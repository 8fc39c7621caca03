"""Port parity: the fused dense Krylov solves of solvers/fused_pcg.py (their
plain torch versions, which a CPU tensor selects) against the JAX package's
solvers/pallas_pcg.py in Pallas interpret mode, on the same float32 inputs
drawn with numpy.

Tolerances:
- CG: niter within 1 and x within 1e-5 of max|x| -- both are float32 CG
  with sums taken in other orders, tested against a squared threshold, so a
  step can land on either side of it.  K is kept well conditioned
  (cond ~ 50): on a spectrum clustered at mu (mu = 0.1, cond ~ 700) float32
  CG loses orthogonality after a few steps and two summation orders give
  residuals 3x apart at step 12, which would test rounding, not the port.
  relres within 5% where both stop on the tolerance (two residuals just
  below it), 1e-4 relative at maxits = 16 (measured 1e-6; at step 12, a
  spike of this K's non-monotone CG residual, the two differ by 10%).
- Lanczos: alpha, beta within 1e-4 of max|alpha|, V within 1e-4 relative
  Frobenius, beta0 rtol 1e-6, the per-probe SLQ quadrature rtol 1e-4:
  float32 products over n = 120 and 8 steps of CGS2 in other orders
  (measured 2e-7, 4e-6 absolute, 1.2e-5 and 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.solvers.pallas_pcg import fused_lanczos_dense as j_lanczos
from nfft4gp_tpu.solvers.pallas_pcg import fused_pcg_dense as j_pcg
from nfft4gp_torch.models.problem import tensors_from_numpy
from nfft4gp_torch.ops.kernels import KernelParams, additive_kernel_matrix, make_windows
from nfft4gp_torch.solvers.fused_pcg import fused_lanczos_dense, fused_pcg_dense

N = 120


def _kernel(l, mu, seed=5):  # noqa: E741
    """Additive gaussian K over windows [[0, 1], [2, 3]], float32 numpy."""
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.uniform(size=(N, 4)))
    p = KernelParams.make(1.0, l, mu, dtype=torch.float64)
    return additive_kernel_matrix("gaussian", p, X, make_windows([[0, 1], [2, 3]])).numpy().astype(np.float32)


def _both_pcg(K, b, **kw):
    jx, jr, jn = j_pcg(jnp.asarray(K), jnp.asarray(b), interpret=True, **kw)
    tK, tb = tensors_from_numpy("cpu", K, b)
    tx, tr, tn = fused_pcg_dense(tK, tb, **kw)
    assert tx.dtype == torch.float32 and tr.dtype == torch.float32 and tn.dtype == torch.int32
    return (np.asarray(jx), float(jr), int(jn)), (tx.numpy(), float(tr), int(tn))


@pytest.mark.parametrize("case", ["converge", "maxits", "zero_rhs", "tol_ge_1", "breakdown"])
def test_fused_pcg_matches_jax(case):
    K = _kernel(0.2, 0.5)
    b = np.random.default_rng(9).normal(size=N).astype(np.float32)
    kw = dict(maxits=150, tol=1e-5)
    if case == "maxits":
        kw["maxits"] = 16
    elif case == "zero_rhs":
        b = np.zeros_like(b)
    elif case == "tol_ge_1":
        kw["tol"] = 1.0
    elif case == "breakdown":
        K = np.zeros_like(K)                       # q = 0, so pq = 0 at step 0
    (jx, jr, jn), (tx, tr, tn) = _both_pcg(K, b, **kw)
    assert abs(tn - jn) <= 1
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5 * max(np.abs(jx).max(), 1e-30))
    if case == "converge":
        assert jr <= kw["tol"] and tr <= kw["tol"]
        np.testing.assert_allclose(tr, jr, rtol=5e-2)
    elif case == "maxits":
        assert tn == jn == 16
        np.testing.assert_allclose(tr, jr, rtol=1e-4)
    elif case == "zero_rhs":
        assert (tn, tr) == (jn, jr) == (0, 0.0)
        assert not tx.any()
    elif case == "tol_ge_1":
        assert (tn, tr) == (jn, jr) == (0, 1.0)      # stopped at the start, x = 0
        assert not tx.any()
    else:
        assert (tn, tr) == (jn, jr) == (1, 1.0)      # the breakdown step counts
        assert not tx.any()


def _quadrature(alpha, beta):
    T = np.diag(alpha) + np.diag(beta, 1) + np.diag(beta, -1)
    theta, vecs = np.linalg.eigh(T.astype(np.float64))
    return np.sum(vecs[0] ** 2 * np.log(np.abs(theta)))


def _both_lanczos(K, Z, maxits):
    ja, jb, jV, jb0 = (np.asarray(a) for a in j_lanczos(jnp.asarray(K), jnp.asarray(Z), maxits=maxits,
                                                         interpret=True))
    tK, tZ = tensors_from_numpy("cpu", K, Z)
    ta, tb, tV, tb0 = (t.numpy() for t in fused_lanczos_dense(tK, tZ, maxits=maxits))
    nv, n = Z.shape
    assert ta.shape == ja.shape == (nv, maxits) and tb.shape == jb.shape == (nv, maxits - 1)
    assert tV.shape == jV.shape == (nv, maxits + 1, n) and tb0.shape == jb0.shape == (nv,)
    return (ja, jb, jV, jb0), (ta, tb, tV, tb0)


def test_fused_lanczos_matches_jax():
    K = _kernel(0.5, 0.1)
    Z = np.random.default_rng(3).choice([-1.0, 1.0], size=(4, N)).astype(np.float32)
    (ja, jb, jV, jb0), (ta, tb, tV, tb0) = _both_lanczos(K, Z, 8)
    scale = np.abs(ja).max()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tb0, jb0, rtol=1e-6)
    assert np.linalg.norm(tV - jV) <= 1e-4 * np.linalg.norm(jV)
    for r in range(Z.shape[0]):
        np.testing.assert_allclose(_quadrature(ta[r], tb[r]), _quadrature(ja[r], jb[r]), rtol=1e-4)


def test_fused_lanczos_breaks_on_low_rank():
    """K of rank 3 < maxits: the recursion meets ||w|| < eps after three
    live steps and pads alpha with 1, beta with 0, V with zero rows; a zero
    probe (beta0 = 0) breaks at its first step."""
    rng = np.random.default_rng(13)
    U, _ = np.linalg.qr(rng.normal(size=(N, 3)))
    K = ((U * np.array([1e-2, 5e-3, 2e-3])) @ U.T).astype(np.float32)
    Z = rng.choice([-1.0, 1.0], size=(3, N)).astype(np.float32)
    Z[2] = 0.0
    (ja, jb, jV, jb0), (ta, tb, tV, tb0) = _both_lanczos(K, Z, 8)
    for a, b, V, b0 in ((ja, jb, jV, jb0), (ta, tb, tV, tb0)):
        assert np.all(a[:2, 3:] == 1.0) and np.all(b[:2, 2:] == 0.0) and not V[:2, 4:].any()
        assert np.all(a[2] == 1.0) and not b[2].any() and not V[2].any() and b0[2] == 0.0
    scale = np.abs(ja).max()
    np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-4 * scale)
    assert np.linalg.norm(tV - jV) <= 1e-4 * np.linalg.norm(jV)


def test_fused_wrappers_validate():
    K = torch.eye(4)
    with pytest.raises(ValueError):
        fused_pcg_dense(K, torch.ones(5))
    with pytest.raises(ValueError):
        fused_lanczos_dense(K, torch.ones((2, 4)), maxits=0)
    before = (fused_pcg_dense.launches, fused_lanczos_dense.launches)
    fused_pcg_dense(K, torch.ones(4, dtype=torch.float64))
    fused_lanczos_dense(K, torch.ones((2, 4)), maxits=2)
    assert (fused_pcg_dense.launches, fused_lanczos_dense.launches) == before   # plain on CPU
    x, _, _ = fused_pcg_dense(K, torch.ones(4, dtype=torch.float64))
    assert x.dtype == torch.float64                                           # b's dtype
