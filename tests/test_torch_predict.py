"""Port parity: GP prediction (models/gp.py gp_predict, gp_predict_fastsum;
models/problem.py GPProblem.predict) vs the JAX package, float64 on CPU,
with the JAX-drawn Nystrom landmarks injected into the port.

The port solves one FGMRES system per test point where the JAX package
vmaps them; both run the same fixed-step algorithm.

Tolerances: mean and std rtol 1e-10, each also relative to the largest
entry -- the same solves in float64, sums in other orders (measured
agreement over these cases: 5.0e-14 on the mean, 3.1e-14 on the std);
1e-8 for the matern12 dense solve of the auto rule, which carries rounding
further (measured 1.8e-9 on the mean, 2.8e-9 on the std).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models import gp as jgp
from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.preconds.nystrom import nystrom_setup as j_nystrom
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm
from nfft4gp_torch.models import gp as tgp
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.ops.kernels import make_windows as t_windows
from nfft4gp_torch.preconds.nystrom import nystrom_setup as t_nystrom

MEAN_RTOL, STD_RTOL = 1e-10, 1e-10
WINDOWS = [[0, 1], [2, 3], [4]]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(83)
    n, n_test = 160, 10
    X = rng.uniform(size=(n, 5))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)
    return X, y, rng.uniform(size=(n_test, 5))


def _close(t, j, rtol):
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=rtol, atol=rtol * np.abs(j).max())


def _check(tres, jres):
    _close(tres.mean, jres.mean, MEAN_RTOL)
    if jres.std is not None:
        assert bool((tres.std > 0).all())
        _close(tres.std, jres.std, STD_RTOL)


RAW = np.asarray(transform_inverse("softplus", torch.tensor([1.2, 0.4, 0.05], dtype=torch.float64)))


@pytest.mark.parametrize("windows", [WINDOWS, None], ids=["additive", "full"])
@pytest.mark.parametrize("precond", ["nystrom", "none"])
def test_gp_predict_dense(data, windows, precond):
    X, y, Xt = data
    d = 5 if windows else 3
    X, Xt = X[:, :d], Xt[:, :d]
    cfg_kw = dict(kind="matern32", maxits=6, tol=1e-8)
    perm = np.asarray(j_rand_perm(jax.random.PRNGKey(2), X.shape[0], 20))
    tw = t_windows(windows) if windows else None
    jw = np.asarray(j_windows(windows)) if windows else None
    tpre = (lambda p: t_nystrom("matern32", p, torch.tensor(X), torch.tensor(perm), 20, windows=tw)) \
        if precond == "nystrom" else None
    jpre = (lambda p: j_nystrom("matern32", p, jnp.asarray(X), jnp.asarray(perm), 20, windows=jw)) \
        if precond == "nystrom" else None
    tres = tgp.gp_predict(torch.tensor(RAW), torch.tensor(X), torch.tensor(y), torch.tensor(Xt),
                          tgp.GPConfig(**cfg_kw), windows=tw, precond_setup=tpre, with_std=True, maxits=60)
    jres = jax.jit(lambda r, a, b, c: jgp.gp_predict(r, a, b, c, jgp.GPConfig(**cfg_kw), windows=jw,
                                                     precond_setup=jpre, with_std=True, maxits=60))(
        jnp.asarray(RAW), jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xt))
    _check(tres, jres)
    assert tres.solve_iters == int(jres.solve_iters)


@pytest.mark.parametrize("windows", [WINDOWS, None], ids=["additive", "full"])
@pytest.mark.parametrize("kind", ["gaussian", "matern12"])
def test_gp_predict_fastsum(data, windows, kind):
    """The joint-plan predictor, matern12 with its KNN near-field, the std
    in chunks of 4 of the 10 test points (the last chunk ragged)."""
    X, y, Xt = data
    d = 5 if windows else 2
    X, Xt = X[:, :d], Xt[:, :d]
    kw = dict(fastsum_N=16, with_std=True, maxits=40, nearfield_lfil=8 if kind == "matern12" else 0,
              std_chunk=4)
    cfg = dict(kind=kind, maxits=6, tol=1e-8)
    tw = t_windows(windows) if windows else None
    jw = np.asarray(j_windows(windows)) if windows else None
    tres = tgp.gp_predict_fastsum(torch.tensor(RAW), torch.tensor(X), torch.tensor(y), torch.tensor(Xt),
                                  tgp.GPConfig(**cfg), windows=tw, **kw)
    jres = jax.jit(lambda r, a, b, c: jgp.gp_predict_fastsum(r, a, b, c, jgp.GPConfig(**cfg), windows=jw, **kw))(
        jnp.asarray(RAW), jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xt))
    _check(tres, jres)


PROBLEM = dict(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom", rank=16,
               maxits=6, nvecs=4, fastsum_N=16, seed=5)


def _landmarks(kw, n):
    return torch.from_numpy(np.array(j_rand_perm(jax.random.PRNGKey(kw["seed"]), n, kw["rank"])))


def test_predict_of_jax_saved_problem(data, tmp_path):
    """A problem fitted and saved by the JAX package, loaded by the port:
    the fastsum mean and std (the default operator), then the dense ones."""
    X, y, Xt = data
    jp = JProblem(**PROBLEM).fit(jnp.asarray(X), jnp.asarray(y), adam_maxits=2, adam_alpha=0.05)
    jp.save(str(tmp_path / "p.npz"))
    tp = TProblem.load(str(tmp_path / "p.npz"))
    lm = _landmarks(PROBLEM, X.shape[0])
    for op in ("auto", "dense"):
        jp.predict_operator = tp.predict_operator = op
        jm, js = jp.predict(jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xt), with_std=True)
        tm, ts = tp.predict(torch.tensor(X), torch.tensor(y), torch.tensor(Xt), with_std=True, landmarks=lm)
        _close(tm, jm, MEAN_RTOL)
        _close(ts, js, STD_RTOL)
    assert tp.predict(torch.tensor(X), torch.tensor(y), torch.tensor(Xt), landmarks=lm).shape == (Xt.shape[0],)


def test_predict_auto_rule_matern12_dense(data, capsys):
    """matern12 fastsum predicts on the dense kernel while n <= 20000: the
    same numbers as predict_operator='dense', and as the JAX package."""
    X, y, Xt = data
    kw = dict(PROBLEM, kernel="matern12")
    raw = torch.tensor(RAW)
    lm = _landmarks(kw, X.shape[0])
    tp = TProblem(**kw, raw_params_=raw)
    tm, ts = tp.predict(torch.tensor(X), torch.tensor(y), torch.tensor(Xt), with_std=True, landmarks=lm)
    dm, ds = TProblem(**dict(kw, predict_operator="dense"), raw_params_=raw).predict(
        torch.tensor(X), torch.tensor(y), torch.tensor(Xt), with_std=True, landmarks=lm)
    assert torch.equal(tm, dm) and torch.equal(ts, ds)
    assert "WARNING" not in capsys.readouterr().out
    jp = JProblem(**kw)
    jp.raw_params_ = jnp.asarray(RAW)
    jm, js = jp.predict(jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xt), with_std=True)
    _close(tm, jm, 1e-8)
    _close(ts, js, 1e-8)


def test_predict_needs_fit(data):
    X, y, Xt = data
    with pytest.raises(RuntimeError):
        TProblem(**PROBLEM).predict(torch.tensor(X), torch.tensor(y), torch.tensor(Xt))


def test_fastsum_predict_near_dense():
    """The fastsum predictor against the dense one in float32, at the chip
    script's configuration (gaussian, five 2-D windows, N = 32, Nystrom rank
    50, (f, l, mu) = (1, 0.5, 0.1), 200 FGMRES steps) and n = 1000: relative
    L2 gap of the mean <= 1e-3, of the std (16 points) <= 1e-4.  Measured
    3.7e-4 and 1.8e-5 (float64 the same to two digits); the gap grows with
    n (7.1e-4 / 4.6e-5 at n = 4000, 1.08e-3 / 8.1e-5 at n = 8000, float32):
    the Fourier operator's error carried through the solve, whose condition
    grows with n.  chip_smoke.py's [predict] limits at n = 2e4 (5e-3, 5e-4)
    extrapolate this trend."""
    rng = np.random.default_rng(0)
    n = 1000
    X = rng.uniform(size=(n, 10)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 3]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    Xt = rng.uniform(size=(300, 10)).astype(np.float32)
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1]))
    out = {}
    for op in ("fastsum", "dense"):
        p = TProblem(kernel="gaussian", windows=[[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]], operator="fastsum",
                     rank=50, predict_operator=op, raw_params_=raw, device="cpu")
        out[op] = (p.predict(X, y, Xt), p.predict(X, y, Xt[:16], with_std=True)[1])
    for k, limit in ((0, 1e-3), (1, 1e-4)):
        gap = torch.linalg.norm(out["fastsum"][k] - out["dense"][k]) / torch.linalg.norm(out["dense"][k])
        assert float(gap) <= limit, (k, float(gap))
