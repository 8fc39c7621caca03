"""Port parity: the dense small-n path -- PCG, the Cholesky preconditioner,
the dense losses with precond="chol" and the Nystrom convenience loss, the
exact multiclass GP and the named kernel wrappers -- against the JAX
package, float64 on CPU, inputs drawn with numpy and handed to both.

Tolerances:
- pcg: niter equal and the same NaN padding; x within 100x the JAX
  package's own rounding envelope (absolute), each entry of the history
  and relres within rtol 1e-12 plus 100x that envelope relative to the
  entry (its running maximum over the steps so far).  The envelope is
  measured in the test by a second JAX solve with every entry of b moved
  by one ulp.  Unpreconditioned CG amplifies rounding by ~100x a step for
  a few steps once a Ritz value converges (on this K the envelope is
  ~1e-15 for 12 steps, then 8.5e-5 at step 17 and 3.4e-2 at step 18), so
  a fixed tolerance would test rounding, not the port.
- CholPrecond, the multiclass GP, kernels: rtol 1e-10 -- direct float64
  factorizations and elementwise formulas; logdet and traces of a K with
  condition ~1e3.
- losses through FGMRES and SLQ: rtol 1e-9 (test_torch_problem.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models import multiclass as jmc
from nfft4gp_tpu.models.gp import gp_loss_gaussian_ran_softplus as j_ran_loss
from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.ops import kernels as jk
from nfft4gp_tpu.preconds.chol import chol_setup as j_chol
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.solvers.pcg import pcg as j_pcg
from nfft4gp_torch.models import multiclass as tmc
from nfft4gp_torch.models.gp import gp_loss_gaussian_ran_softplus as t_ran_loss
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.problem import tensors_from_numpy
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.ops import kernels as tk
from nfft4gp_torch.preconds.chol import chol_setup as t_chol
from nfft4gp_torch.solvers.pcg import pcg as t_pcg

EXACT = dict(rtol=1e-10, atol=1e-12)
WINDOWS = [[0, 1], [2]]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def dense():
    """Additive gaussian K, dK (f64) on 90 points in both packages."""
    rng = np.random.default_rng(17)
    n = 90
    X = rng.uniform(size=(n, 3))
    b = rng.normal(size=n)
    Z = rng.choice([-1.0, 1.0], size=(4, n))
    tp, jp = tk.KernelParams.make(1.1, 0.5, 0.05, dtype=torch.float64), jk.KernelParams.make(1.1, 0.5, 0.05)
    tK, tdK = tk.additive_kernel_matrix_with_grad("gaussian", tp, torch.tensor(X), tk.make_windows(WINDOWS))
    jK, jdK = jk.additive_kernel_matrix_with_grad("gaussian", jp, jnp.asarray(X), jk.make_windows(WINDOWS))
    return dict(X=X, b=b, Z=Z, tp=tp, jp=jp, tK=tK, tdK=tdK, jK=jK, jdK=jdK)


@pytest.fixture(scope="module")
def spd():
    """matern12 K on 90 points (cond 29) and a right-hand side."""
    rng = np.random.default_rng(17)
    X = rng.uniform(size=(90, 3))
    K = np.asarray(jk.kernel_matrix("matern12", jk.KernelParams.make(1.1, 0.2, 0.1), jnp.asarray(X)))
    return K, rng.normal(size=90)


@pytest.mark.parametrize("case", ["plain", "chol", "compensated", "replace20", "atol"])
def test_pcg_matches_jax(spd, case):
    K, b = spd
    kw = dict(tol=1e-8, maxits=80)
    tpre = jpre = None
    if case == "chol":
        tpre, jpre = t_chol(torch.tensor(K)).solve, j_chol(jnp.asarray(K)).solve
    elif case == "compensated":
        kw["compensated"] = True
    elif case == "replace20":
        kw["replace_every"] = 20
    elif case == "atol":
        kw.update(atol=True, tol=1e-6)
    tK, tb = tensors_from_numpy("cpu", K, b)
    t = t_pcg(lambda v: tK @ v, tb, precond=tpre, **kw)
    j = j_pcg(lambda v: jnp.asarray(K) @ v, jnp.asarray(b), precond=jpre, **kw)
    # the JAX package against itself, every entry of b moved by one ulp: the
    # rounding envelope of this solve
    jp = j_pcg(lambda v: jnp.asarray(K) @ v, jnp.asarray(np.nextafter(b, np.inf)), precond=jpre, **kw)
    assert t.niter == int(j.niter) == int(jp.niter) and t.converged == bool(j.converged)
    jx, hist = np.asarray(j.x), np.asarray(j.res_history)
    env_x = np.abs(np.asarray(jp.x) - jx).max()
    np.testing.assert_allclose(_np(t.x), jx, rtol=0, atol=1e-12 * np.abs(jx).max() + 100 * env_x)
    # the history's envelope relative to each entry, as its running maximum
    # over the steps so far (an error once made is carried by later steps)
    live = slice(0, t.niter + 1)
    env_h = np.maximum.accumulate(np.abs(np.asarray(jp.res_history)[live] - hist[live])
                                  / np.abs(hist[live]))
    assert np.isnan(hist[t.niter + 1:]).all() and t.res_history.shape == hist.shape
    assert np.isnan(_np(t.res_history)[t.niter + 1:]).all()
    np.testing.assert_array_less(np.abs(_np(t.res_history)[live] - hist[live]),
                                 (1e-12 + 100 * env_h) * np.abs(hist[live]) + 1e-300)
    np.testing.assert_allclose(float(t.relres), float(j.relres), rtol=1e-12 + 100 * env_h[-1], atol=0)


def test_pcg_b_zero_and_start_converged(spd):
    """b = 0 takes one step (tolb = 0 and the direct exit tests normr0 <
    tolb strictly; rho = 0 breaks down); a start x0 at the solution exits
    before any step (ref pcg.c:70-84)."""
    K, b = spd
    tK, tb = tensors_from_numpy("cpu", K, b)
    t = t_pcg(lambda v: tK @ v, torch.zeros(90, dtype=torch.float64), tol=1e-8)
    j = j_pcg(lambda v: jnp.asarray(K) @ v, jnp.zeros(90), tol=1e-8)
    assert t.niter == int(j.niter) == 1 and t.converged == bool(j.converged)
    np.testing.assert_allclose(_np(t.res_history), np.asarray(j.res_history), equal_nan=True)
    x0 = np.linalg.solve(K, b)
    t = t_pcg(lambda v: tK @ v, tb, torch.tensor(x0), tol=1e-6)
    j = j_pcg(lambda v: jnp.asarray(K) @ v, jnp.asarray(b), jnp.asarray(x0), tol=1e-6)
    assert t.niter == int(j.niter) == 0 and t.converged and bool(j.converged)
    np.testing.assert_allclose(_np(t.x), x0, rtol=0, atol=0)
    np.testing.assert_allclose(_np(t.res_history), np.asarray(j.res_history), rtol=1e-6, atol=1e-14,
                               equal_nan=True)


@pytest.mark.parametrize("build", ["explicit", "from_kernel"])
def test_chol_precond_matches_jax(dense, build):
    d = dense
    if build == "explicit":
        tpre = t_chol(d["tK"], dK=d["tdK"], require_grad=True)
        jpre = j_chol(d["jK"], dK=d["jdK"], require_grad=True)
    else:
        X = d["X"][:, :2]
        tpre = t_chol(kind="matern32", params=d["tp"], X=torch.tensor(X), require_grad=True)
        jpre = j_chol(kind="matern32", params=d["jp"], X=jnp.asarray(X), require_grad=True)
    np.testing.assert_allclose(float(tpre.nu), float(jpre.nu), rtol=1e-12)
    b, Z = tensors_from_numpy("cpu", d["b"], d["Z"])
    np.testing.assert_allclose(_np(tpre.solve(b)), np.asarray(jpre.solve(jnp.asarray(d["b"]))), **EXACT)
    rows = np.stack([np.asarray(jpre.solve(jnp.asarray(z))) for z in d["Z"]])
    np.testing.assert_allclose(_np(tpre.solve(Z)), rows, **EXACT)
    np.testing.assert_allclose(float(tpre.logdet()), float(jpre.logdet()), **EXACT)
    np.testing.assert_allclose(_np(tpre.trace()), np.asarray(jpre.trace()), **EXACT)
    dvp = np.stack([np.asarray(jpre.dvp(jnp.asarray(z))) for z in d["Z"]])      # (nv, 3, n)
    np.testing.assert_allclose(_np(tpre.dvp(Z)), dvp, **EXACT)
    np.testing.assert_allclose(_np(tpre.dvp(b)), np.asarray(jpre.dvp(jnp.asarray(d["b"]))), **EXACT)


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(61)
    n = 80
    X = rng.uniform(size=(n, 4))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)
    return X, y


@pytest.mark.parametrize("windows", [None, [[0, 1], [2, 3]]], ids=["full", "additive"])
def test_dense_chol_problem_loss(synth, windows):
    X, y = synth
    kw = dict(kernel="matern32", windows=windows, operator="dense", precond="chol", maxits=8,
              nvecs=5, seed=2)
    probes = np.asarray(j_probes(jax.random.PRNGKey(kw["seed"] + 1), kw["nvecs"], X.shape[0],
                                 dtype=jnp.float64))
    raw = np.asarray(transform_inverse("softplus", torch.tensor([1.0, 0.6, 0.1], dtype=torch.float64)))
    jl, jg = JProblem(**kw).make_loss(jnp.asarray(X), jnp.asarray(y))(jnp.asarray(raw))
    tX, ty, tprobes, traw = tensors_from_numpy("cpu", X, y, probes, raw)
    tl, tg = TProblem(**kw).make_loss(tX, ty, probes=tprobes)(traw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)


def test_gp_loss_gaussian_ran_softplus(synth):
    X, y = synth
    rng = np.random.default_rng(5)
    probes = rng.choice([-1.0, 1.0], size=(4, X.shape[0]))
    perm = rng.permutation(X.shape[0])
    raw = np.array([0.3, -0.4, -1.5])
    j = j_ran_loss(jnp.asarray(raw), jnp.asarray(X), jnp.asarray(y), jnp.asarray(probes), rank=20,
                   maxits=8, perm=jnp.asarray(perm))
    tX, ty, tprobes, traw, tperm = tensors_from_numpy("cpu", X, y, probes, raw, perm)
    t = t_ran_loss(traw, tX, ty, tprobes, rank=20, maxits=8, perm=tperm)
    for name in ("loss", "l1", "l2"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)), rtol=1e-9)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad), rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def clsdata():
    rng = np.random.default_rng(91)
    n, C = 60, 3
    centers = np.asarray([[0.0, 0.0], [1.5, 0.0], [0.0, 1.5]])
    labels = rng.integers(0, C, size=n)
    X = centers[labels] + 0.3 * rng.normal(size=(n, 2))
    Ys = np.eye(C)[labels] * 2.0 - 1.0
    mu2 = 0.01 + 0.02 * rng.uniform(size=(n, C))
    X2 = rng.uniform(-0.5, 2.0, size=(25, 2))
    raw = np.linspace(0.2, 0.8, 3 * C)
    return X, Ys, mu2, X2, raw


@pytest.mark.parametrize("kind,masks", [("gaussian", None), ("matern12", (1, 1, 0))])
def test_exact_class_gp_loss(clsdata, kind, masks):
    X, Ys, mu2, _, raw = clsdata
    j = jmc.exact_class_gp_loss(jnp.asarray(raw), jnp.asarray(X), jnp.asarray(Ys), jnp.asarray(mu2),
                                kind=kind, masks=masks)
    t = tmc.exact_class_gp_loss(*tensors_from_numpy("cpu", raw, X, Ys, mu2), kind=kind, masks=masks)
    np.testing.assert_allclose(float(t.loss), float(j.loss), **EXACT)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j.grad), **EXACT)
    np.testing.assert_allclose(t.per_class.numpy(), np.asarray(j.per_class), **EXACT)


@pytest.mark.parametrize("with_std", [False, True])
def test_exact_class_gp_predict(clsdata, with_std):
    X, Ys, mu2, X2, raw = clsdata
    j = jmc.exact_class_gp_predict(jnp.asarray(raw), jnp.asarray(X), jnp.asarray(Ys), jnp.asarray(mu2),
                                   jnp.asarray(X2), with_std=with_std)
    traw, tX, tYs, tmu2, tX2 = tensors_from_numpy("cpu", raw, X, Ys, mu2, X2)
    t = tmc.exact_class_gp_predict(traw, tX, tYs, tmu2, tX2, with_std=with_std)
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_allclose(t.means.numpy(), np.asarray(j.means), **EXACT)
    if with_std:
        np.testing.assert_allclose(t.std.numpy(), np.asarray(j.std), **EXACT)
    else:
        assert t.std is None and j.std is None


@pytest.mark.parametrize("grad", [False, True])
def test_fixed_noise_kernel(clsdata, grad):
    X, _, mu2, X2, _ = clsdata
    for Y in (None, X2):
        j = jmc.fixed_noise_kernel("gaussian", 1.2, 0.7, 0.05, jnp.asarray(mu2[:, 0]), jnp.asarray(X),
                                   None if Y is None else jnp.asarray(Y), grad=grad)
        t = tmc.fixed_noise_kernel("gaussian", 1.2, 0.7, 0.05, torch.tensor(mu2[:, 0]), torch.tensor(X),
                                   None if Y is None else torch.tensor(Y), grad=grad)
        for a, b in zip((t,) if not grad else t, (j,) if not grad else j):
            np.testing.assert_allclose(_np(a), np.asarray(b), **EXACT)


@pytest.mark.parametrize("name", ["gaussian_kernel", "matern32_kernel", "matern12_kernel"])
def test_named_kernels(dense, name):
    X = dense["X"]
    for Y in (None, X[:17] + 0.1):
        t = getattr(tk, name)(dense["tp"], torch.tensor(X), None if Y is None else torch.tensor(Y))
        j = getattr(jk, name)(dense["jp"], jnp.asarray(X), None if Y is None else jnp.asarray(Y))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **EXACT)


def test_dense_symv(dense):
    d = dense
    b = torch.tensor(d["b"])
    np.testing.assert_allclose(tk.dense_symv(d["tK"])(b).numpy(),
                               np.asarray(jk.dense_symv(d["jK"])(jnp.asarray(d["b"]))), **EXACT)
    np.testing.assert_allclose(tk.dense_grad_symv(d["tdK"])(b).numpy(),
                               np.asarray(jk.dense_grad_symv(d["jdK"])(jnp.asarray(d["b"]))), **EXACT)
