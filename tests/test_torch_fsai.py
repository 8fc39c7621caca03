"""Port parity: the ELL triangular solves and transpose product
(ops/matops.py) and the FSAI preconditioner (preconds/fsai.py) vs the JAX
package, on CPU in float64.

Tolerances:
- triangular solves and G' products: 1e-12 relative to the largest entry,
  against JAX and against dense numpy (blocked substitution and gathers in
  other summation orders than JAX's scatter);
- row factors, breakdown rows included: val and dval 1e-12 (one batched
  Cholesky of the same 8 x 8 blocks), the breakdown flag equal;
- fsai_setup val / dval 1e-10 (the kernel blocks come from a batched GEMM
  here, a vmapped one there);
- solve, logdet, trace, dvp and the gram pair 1e-9 (the factors' 1e-10
  carried through up to three triangular solves);
- dG against central finite differences of G, 1e-6 relative (step 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import matops as jm
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.ops.knn import knn_pattern_host
from nfft4gp_tpu.preconds import fsai as jf
from nfft4gp_torch.ops import matops as tm
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows
from nfft4gp_torch.preconds import fsai as tf

WINDOWS = [[0, 1], [2]]


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


@pytest.fixture(scope="module")
def ell():
    """A lower-triangular ELL G on a KNN pattern: n = 300, not a multiple of
    the 64-row block; a diagonally dominant random matrix."""
    rng = np.random.default_rng(21)
    n, lfil = 300, 7
    idx, mask = knn_pattern_host(rng.uniform(size=(n, 2)), lfil)
    val = np.where(mask, rng.normal(size=(n, lfil)), 0.0)
    val[:, -1] = 3.0 + rng.uniform(size=n)
    G = np.zeros((n, n))
    for i in range(n):
        for s in range(lfil):
            G[i, idx[i, s]] += val[i, s]
    return idx, mask, val, G


@pytest.mark.parametrize("nv", [1, 10])
def test_ell_triangular_solves_and_transpose(ell, nv):
    idx, mask, val, G = ell
    B = np.random.default_rng(nv).normal(size=(nv, G.shape[0]))
    b = B[0] if nv == 1 else B
    pat_t = tuple(torch.from_numpy(a) for a in jm.ell_transpose_pattern(idx, mask))
    tri = tm.ell_tri_blocks(torch.tensor(idx), torch.tensor(val), pat_t, block=64)
    jl = jax.jit(functools.partial(jm.ell_tril_solve, block=64))
    ju = jax.jit(functools.partial(jm.ell_triu_solve, block=64))
    if nv > 1:
        jl, ju = jax.vmap(jl, in_axes=(None, None, 0)), jax.vmap(ju, in_axes=(None, None, 0))
    bt = torch.tensor(b)
    for got, jfn, dense in ((tm.ell_tril_solve(tri, bt), jl, G), (tm.ell_triu_solve(tri, bt), ju, G.T)):
        _close(got, jfn(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(b)), 1e-12)
        _close(got, np.linalg.solve(dense, B.T).T.reshape(b.shape), 1e-12)
    jt = jm.ell_transpose_pattern(idx, mask)
    for got_np, want_np in zip(tm.ell_transpose_pattern(idx, mask), jt):
        np.testing.assert_array_equal(got_np, want_np)
    got = tm.ell_rmatvec_t(*pat_t, torch.tensor(val), bt)
    _close(got, (B @ G).reshape(b.shape), 1e-12)
    _close(got[None] if nv == 1 else got,
           jax.vmap(lambda x: jm.ell_rmatvec_t(*map(jnp.asarray, jt), jnp.asarray(val), x))(jnp.asarray(B)),
           1e-12)


def test_fsai_rows_with_breakdowns():
    """Rows 4 (singular) and 7 (indefinite) break down: both packages repair
    them to the same diagonal rows and dG; no NaN anywhere."""
    rng = np.random.default_rng(3)
    n, lfil = 12, 5
    A = rng.normal(size=(n, lfil, lfil))
    blocks = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(lfil)
    blocks[4] = np.ones((lfil, lfil))
    blocks[7] = -np.eye(lfil)
    mask = np.ones((n, lfil), bool)
    mask[2, :2] = False
    dblocks = rng.normal(size=(n, 3, lfil, lfil))
    dblocks = 0.5 * (dblocks + np.swapaxes(dblocks, 2, 3))
    jv, jdv, jb = jf.fsai_rows_from_blocks(jnp.asarray(blocks), jnp.asarray(dblocks), jnp.asarray(mask))
    tv, tdv, tb = tf.fsai_rows_from_blocks(torch.tensor(blocks), torch.tensor(dblocks), torch.tensor(mask))
    assert bool(jb) and int(tb) == 2
    assert np.isfinite(tv.numpy()).all() and np.isfinite(tdv.numpy()).all()
    _close(tv, jv, 1e-12)
    _close(tdv, jdv, 1e-12)
    np.testing.assert_allclose(tv[4, :-1].numpy(), 0.0)
    tv0, _, tb0 = tf.fsai_rows_from_blocks(torch.tensor(blocks[:4]), None, torch.tensor(mask[:4]))
    assert int(tb0) == 0
    _close(tv0, tv[:4], 1e-15)


@pytest.fixture(scope="module")
def fsai_pair():
    rng = np.random.default_rng(23)
    n, lfil = 300, 8
    X = rng.uniform(size=(n, 3))
    params = (1.1, 0.3, 0.05)
    jpre = jax.jit(lambda Xv: jf.fsai_setup("gaussian", JParams.make(*params), Xv, lfil, require_grad=True,
                                             windows=j_windows(WINDOWS)))(jnp.asarray(X))
    pattern = (torch.tensor(np.asarray(jpre.idx), dtype=torch.int64), torch.tensor(np.asarray(jpre.mask)))
    tpre = tf.fsai_setup("gaussian", TParams.make(*params, dtype=torch.float64), torch.tensor(X), lfil,
                         require_grad=True, windows=t_windows(WINDOWS))
    return X, params, lfil, jpre, tpre, pattern


def test_fsai_setup_and_applies(fsai_pair):
    X, params, lfil, jpre, tpre, pattern = fsai_pair
    # the device KNN pattern equals JAX's, and so do the factors
    np.testing.assert_array_equal(tpre.idx.numpy(), pattern[0].numpy())
    np.testing.assert_array_equal(tpre.mask.numpy(), pattern[1].numpy())
    _close(tpre.val, jpre.val, 1e-10)
    _close(tpre.dval, jpre.dval, 1e-10)
    assert int(tpre.breakdown) == 0 and not bool(jpre.breakdown)
    # the dense diagonal blocks of dvp's solves come with the factorization
    assert tpre._tri is not None
    rng = np.random.default_rng(5)
    Z = rng.normal(size=(4, X.shape[0]))
    z = Z[0]
    for name in ("solve", "dvp", "dvp_gram", "solve_G", "solve_Gt", "apply_G", "apply_Gt"):
        tfn, jfn = getattr(tpre, name), getattr(jpre, name)
        _close(tfn(torch.tensor(z)), jfn(jnp.asarray(z)), 1e-9)
        _close(tfn(torch.tensor(Z)), jax.vmap(jfn)(jnp.asarray(Z)), 1e-9)
    for name in ("logdet", "trace", "trace_gram"):
        _close(getattr(tpre, name)(), getattr(jpre, name)(), 1e-9)


def test_fsai_dG_finite_differences(fsai_pair):
    X, params, lfil, _, tpre, pattern = fsai_pair
    h = 1e-5
    for j in range(3):
        vals = []
        for s in (1.0, -1.0):
            p = list(params)
            p[j] += s * h
            vals.append(tf.fsai_setup("gaussian", TParams.make(*p, dtype=torch.float64), torch.tensor(X), lfil,
                                      windows=t_windows(WINDOWS), pattern=pattern).val)
        _close(tpre.dval[j], (vals[0] - vals[1]) / (2 * h), 1e-6)
