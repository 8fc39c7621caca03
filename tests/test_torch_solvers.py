"""Port parity: FGMRES, Lanczos, SLQ, transforms and Adam vs the JAX package.

float64 on CPU, inputs (matrices, probes, landmarks) drawn with numpy and
handed to both packages.  Tolerances:
- fgmres, lanczos, slq_logdet: 1e-9 relative to the largest entry -- the
  same recurrences in float64, with sums taken in other orders; a few
  Krylov steps amplify ulp-level differences by the condition number
  (~1e3 here).  Residual norms, computed from x, that sit far below it in a
  converged solve inherit the 1e-9 agreement of x and are held at atol 1e-9.
- transforms and Adam: rtol 1e-12 -- elementwise float64 formulas.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models import adam as jadam
from nfft4gp_tpu.models import transforms as jtr
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import additive_kernel_matrix_with_grad as j_add_kg
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.preconds.nystrom import nystrom_setup as j_nys
from nfft4gp_tpu.solvers.fgmres import fgmres as j_fgmres
from nfft4gp_tpu.solvers.lanczos import lanczos as j_lanczos
from nfft4gp_tpu.solvers.lanczos import slq_logdet as j_slq
from nfft4gp_torch.models import adam as tadam
from nfft4gp_torch.models import transforms as ttr
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import additive_kernel_matrix_with_grad as t_add_kg
from nfft4gp_torch.ops.kernels import make_windows as t_windows
from nfft4gp_torch.preconds.nystrom import nystrom_setup as t_nys
from nfft4gp_torch.solvers.fgmres import fgmres as t_fgmres
from nfft4gp_torch.solvers.lanczos import lanczos as t_lanczos
from nfft4gp_torch.solvers.lanczos import slq_logdet as t_slq

KRYLOV_RTOL = 1e-9
ELEM = dict(rtol=1e-12, atol=1e-14)
WINDOWS = [[0, 1], [2]]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _krylov_close(t, j):
    t, j = _np(t), _np(j)
    np.testing.assert_allclose(t, j, rtol=KRYLOV_RTOL, atol=KRYLOV_RTOL * np.abs(j).max())


@pytest.fixture(scope="module")
def problem():
    """Additive gaussian K, dK on 90 points, Nystrom landmarks and probes."""
    rng = np.random.default_rng(7)
    n = 90
    X = rng.uniform(size=(n, 3))
    b = rng.normal(size=n)
    probes = rng.choice([-1.0, 1.0], size=(5, n))
    perm = rng.permutation(n)[:15]
    tp, jp = TParams.make(1.2, 0.5, 0.03, dtype=torch.float64), JParams.make(1.2, 0.5, 0.03)
    tK, tdK = t_add_kg("gaussian", tp, torch.tensor(X), t_windows(WINDOWS))
    jK, jdK = j_add_kg("gaussian", jp, jnp.asarray(X), j_windows(WINDOWS))
    tpre = t_nys("gaussian", tp, torch.tensor(X), torch.tensor(perm), 15, require_grad=True,
                 windows=t_windows(WINDOWS))
    jpre = j_nys("gaussian", jp, jnp.asarray(X), jnp.asarray(perm), 15, require_grad=True,
                 windows=j_windows(WINDOWS))
    return dict(X=X, b=b, probes=probes, tK=tK, tdK=tdK, jK=jK, jdK=jdK, tpre=tpre, jpre=jpre)


@pytest.mark.parametrize("use_precond", [False, True])
@pytest.mark.parametrize("compensated", [False, True])
def test_fgmres(problem, use_precond, compensated):
    p = problem
    kw = dict(kdim=8, maxits=30, tol=1e-7, compensated=compensated)
    # unpreconditioned GMRES(8) stagnates on K (cond ~ 3e3) and then
    # amplifies rounding chaotically; the shifted K converges and stays
    # comparable
    shift = 0.0 if use_precond else 1.0
    t = t_fgmres(lambda v: p["tK"] @ v + shift * v, torch.tensor(p["b"]),
                 precond=p["tpre"].solve if use_precond else None, **kw)
    j = j_fgmres(lambda v: p["jK"] @ v + shift * v, jnp.asarray(p["b"]),
                 precond=p["jpre"].solve if use_precond else None, **kw)
    assert t.niter == int(j.niter)
    assert t.converged == bool(j.converged)
    _krylov_close(t.x, j.x)
    np.testing.assert_allclose(float(t.relres), float(j.relres), rtol=1e-6, atol=1e-9)
    # later restart cycles start from true residuals that differ at ~1e-9 |b|
    np.testing.assert_allclose(_np(t.res_history), _np(j.res_history), rtol=1e-6, atol=1e-7,
                               equal_nan=True)


@pytest.mark.parametrize("reorth", [dict(), dict(wsize=3), dict(full_reorth=False)],
                         ids=["full", "window3", "three_term"])
@pytest.mark.parametrize("use_precond", [False, True])
def test_lanczos(problem, use_precond, reorth):
    p = problem
    # unpreconditioned, a limited reorthogonalization loses orthogonality on
    # K after ~9 steps; both packages then amplify rounding chaotically (a
    # 1e-15 perturbation of b moves the JAX x by 3e-4), so stop before that
    maxits = 8 if reorth and not use_precond else 12
    t = t_lanczos(lambda v: p["tK"] @ v, torch.tensor(p["b"]), maxits=maxits,
                  precond=p["tpre"].solve if use_precond else None, tol=1e-8, **reorth)
    j = j_lanczos(lambda v: p["jK"] @ v, jnp.asarray(p["b"]), maxits=maxits,
                  precond=p["jpre"].solve if use_precond else None, tol=1e-8, **reorth)
    assert int(t.niter[0]) == int(j.niter) and int(t.tsize[0]) == int(j.tsize)
    for name in ("x", "alpha", "beta"):
        _krylov_close(_np(getattr(t, name))[0], getattr(j, name))
    np.testing.assert_allclose(float(t.relres[0]), float(j.relres), rtol=1e-6)


@pytest.mark.parametrize("use_precond", [False, True])
def test_slq_logdet(problem, use_precond):
    p = problem
    t = t_slq(lambda V: V @ p["tK"], lambda V: torch.einsum("knm,vm->vkn", p["tdK"], V),
              torch.tensor(p["probes"]), maxits=10, precond=p["tpre"] if use_precond else None)
    j = j_slq(lambda v: p["jK"] @ v, lambda v: jnp.einsum("knm,m->kn", p["jdK"], v),
              jnp.asarray(p["probes"]), maxits=10, precond=p["jpre"] if use_precond else None)
    _krylov_close(np.array([float(t.logdet)]), np.array([float(j.logdet)]))
    _krylov_close(t.dlogdet, j.dlogdet)


@pytest.mark.parametrize("kind", ["softplus", "sigmoid", "exp", "identity"])
def test_transforms(kind):
    raw = np.array([-25.0, -3.0, -0.2, 0.0, 0.7, 4.0, 25.0])
    if kind == "sigmoid":
        raw = raw[1:-1]
    tv, td = ttr.transform_forward(kind, torch.tensor(raw))
    jv, jd = jtr.transform_forward(kind, jnp.asarray(raw))
    np.testing.assert_allclose(_np(tv), _np(jv), **ELEM)
    np.testing.assert_allclose(_np(td), _np(jd), **ELEM)
    vals = np.array([1e-10, 0.05, 0.9, 3.0, 30.0]) if kind != "sigmoid" else np.array([0.05, 0.5, 0.9])
    np.testing.assert_allclose(_np(ttr.transform_inverse(kind, torch.tensor(vals))),
                               _np(jtr.transform_inverse(kind, jnp.asarray(vals))), **ELEM)


def test_adam_run():
    A = np.array([[3.0, 0.5, 0.0], [0.5, 2.0, 0.3], [0.0, 0.3, 1.0]])
    c = np.array([0.3, -1.2, 2.0])

    def loss(x, lib):
        g = lib.asarray(A) @ (x - lib.asarray(c)) if lib is jnp else torch.tensor(A) @ (x - torch.tensor(c))
        return 0.5 * (x - (lib.asarray(c) if lib is jnp else torch.tensor(c))) @ g, g

    x0 = np.array([1.0, 1.0, 0.1])
    ts, tl, _, _ = tadam.adam_run(lambda x: loss(x, torch), torch.tensor(x0), maxits=25, alpha=0.05)
    js, jl, _, _ = jadam.adam_run(lambda x: loss(x, jnp), jnp.asarray(x0), maxits=25, alpha=0.05)
    np.testing.assert_allclose(_np(ts.x), _np(js.x), **ELEM)
    np.testing.assert_allclose([float(v) for v in tl], [float(v) for v in jl], **ELEM)
