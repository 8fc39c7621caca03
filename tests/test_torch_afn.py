"""Port parity: the AFN plan and preconditioner (preconds/afn.py) vs the JAX
package, on CPU in float64.

Tolerances:
- plans (perm, k, use_ran, pattern): exact equality (the same host numpy
  steps on the same points; with rank=None the port gets the subsample
  indices JAX draws from its key);
- factors L11, K12, dL11, dK12 and the Schur FSAI's val / dval: 1e-9
  relative to the largest entry (batched against vmapped GEMMs and
  Cholesky; measured 1e-13);
- solve (1 and nv rows), logdet, trace and dvp: 1e-9, against JAX (whose
  Schur G applies through its cell stencil) and against the dense
  U'U factorization of tests/test_afn.py (rtol 1e-7, as there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.rankest import RankestConfig as JCfg
from nfft4gp_tpu.preconds import afn as ja
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import kernel_matrix
from nfft4gp_torch.ops.rankest import RankestConfig as TCfg
from nfft4gp_torch.preconds import afn as ta
from nfft4gp_torch.preconds.nystrom import NystromPrecond
from nfft4gp_torch.solvers.pcg import pcg

CFG = dict(nsample=100, nsample_r=2)


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300))


def _assert_plans_equal(tplan, jplan):
    assert (tplan.k, tplan.use_ran) == (jplan.k, jplan.use_ran)
    np.testing.assert_array_equal(tplan.perm.numpy(), np.asarray(jplan.perm))
    for t, j in zip(tplan.pattern, jplan.pattern):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(t.numpy().dtype))


def _jax_subsamples(n, cfg):
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(cfg.nsample_r):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(jax.random.choice(sub, n, (min(cfg.nsample, n),), replace=False)))
    return subs


@pytest.mark.parametrize("case", ["d2", "d10-pca", "ran", "rank-none-afn", "rank-none-ran"])
def test_afn_plan_equal(case):
    rng = np.random.default_rng(31)
    d = 10 if case == "d10-pca" else 2
    X = rng.uniform(size=(400, d))
    l = 0.03 if case == "rank-none-afn" else 0.3  # noqa: E741
    kw = dict(maxrank=40, lfil=8, force_afn=case in ("d2", "d10-pca"))
    kw["rank"] = {"d2": 60, "d10-pca": 60, "ran": 20}.get(case)
    jplan = ja.afn_plan("gaussian", JParams.make(1.0, l, 0.01), jnp.asarray(X), rankest_cfg=JCfg(**CFG), **kw)
    tplan = ta.afn_plan("gaussian", TParams.make(1.0, l, 0.01, dtype=torch.float64), torch.tensor(X),
                        rankest_cfg=TCfg(**CFG), subsamples=_jax_subsamples(400, JCfg(**CFG)), **kw)
    _assert_plans_equal(tplan, jplan)
    assert tplan.use_ran == (case in ("ran", "rank-none-ran"))


@pytest.fixture(scope="module")
def pair():
    """The AFN of tests/test_afn.py (n = 160 there; 300 here) in both."""
    rng = np.random.default_rng(11)
    n = 300
    X = rng.uniform(size=(n, 2))
    params = (1.0, 0.15, 0.1)
    jplan = ja.afn_plan("gaussian", JParams.make(*params), jnp.asarray(X), maxrank=30, lfil=10, rank=60,
                        force_afn=True)
    jpre = jax.jit(lambda Xv: ja.afn_setup_from_plan("gaussian", JParams.make(*params), Xv, jplan,
                                                     require_grad=True))(jnp.asarray(X))
    tplan = ta.afn_plan("gaussian", TParams.make(*params, dtype=torch.float64), torch.tensor(X), maxrank=30,
                        lfil=10, rank=60, force_afn=True)
    tpre = ta.afn_setup_from_plan("gaussian", TParams.make(*params, dtype=torch.float64), torch.tensor(X),
                                  tplan, require_grad=True)
    return X, params, jpre, tpre


def test_afn_factors(pair):
    _, _, jpre, tpre = pair
    for name in ("perm", "L11", "K12", "dL11", "dK12"):
        _close(getattr(tpre, name), getattr(jpre, name), 1e-9)
    _close(tpre.gs.val, jpre.gs.val, 1e-9)
    _close(tpre.gs.dval, jpre.gs.dval, 1e-9)
    assert int(tpre.breakdown) == 0 and not bool(jpre.breakdown)


def _dense_U(pre):
    """U of M = U'U from the port's factors (tests/test_afn.py's _dense_U)."""
    n, k = pre.n, pre.k
    L11 = pre.L11.numpy()
    idx, val = pre.gs.idx.numpy(), pre.gs.val.numpy()
    G = np.zeros((n - k, n - k))
    for i in range(n - k):
        for s in range(idx.shape[1]):
            G[i, idx[i, s]] += val[i, s]
    U = np.zeros((n, n))
    U[:k, :k] = L11.T
    U[:k, k:] = np.linalg.solve(L11, pre.K12.numpy())
    U[k:, k:] = np.linalg.inv(G).T
    return U


def test_afn_applies(pair):
    X, _, jpre, tpre = pair
    rng = np.random.default_rng(9)
    Z = rng.normal(size=(5, X.shape[0]))
    for name in ("solve", "dvp"):
        tfn = getattr(tpre, name)
        jfn = jax.jit(lambda pre, z, name=name: getattr(pre, name)(z))
        _close(tfn(torch.tensor(Z[0])), jfn(jpre, jnp.asarray(Z[0])), 1e-9)
        _close(tfn(torch.tensor(Z)), jax.vmap(jfn, in_axes=(None, 0))(jpre, jnp.asarray(Z)), 1e-9)
    _close(tpre.logdet(), jpre.logdet(), 1e-9)
    _close(tpre.trace(), jpre.trace(), 1e-9)
    U = _dense_U(tpre)
    P = tpre.perm.numpy()
    np.testing.assert_allclose(tpre.solve(torch.tensor(Z[1])).numpy()[P],
                               np.linalg.solve(U.T @ U, Z[1][P]), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(tpre.logdet()), np.linalg.slogdet(U.T @ U)[1], rtol=1e-8)


def _duplicates(seed):
    base = np.random.default_rng(seed).uniform(size=(48, 2))
    return np.concatenate([base, base], axis=0)


def test_ran_fallback_and_repair():
    """Duplicate points at mu = 0 make the Schur blocks singular: afn_setup
    falls back wholesale to Nystrom on the FPS landmarks of the JAX plan
    (afn_setup.m:93-98; tests/test_afn.py holds JAX to the same);
    afn_setup_from_plan repairs the rows instead, NaN-free, and the solve
    stays positive definite."""
    X = _duplicates(5)
    p0 = (1.0, 0.3, 0.0)
    kw = dict(maxrank=16, lfil=6, rank=16, force_afn=True)
    tpre, tplan = ta.afn_setup("gaussian", TParams.make(*p0, dtype=torch.float64), torch.tensor(X), **kw)
    jplan = ja.afn_plan("gaussian", JParams.make(*p0), jnp.asarray(X), **kw)
    assert tplan.use_ran and isinstance(tpre, NystromPrecond)
    np.testing.assert_array_equal(tplan.perm.numpy(), np.asarray(jplan.perm))
    p1 = TParams.make(1.0, 0.3, 0.05, dtype=torch.float64)
    pre = ta.afn_setup_from_plan("gaussian", p1, torch.tensor(X), tplan)
    K = kernel_matrix("gaussian", p1, torch.tensor(X))
    b = torch.tensor(np.random.default_rng(1).normal(size=X.shape[0]))
    x = pcg(lambda v: K @ v, b, precond=pre.solve, tol=1e-8, maxits=300).x
    np.testing.assert_allclose(x.numpy(), torch.linalg.solve(K, b).numpy(), rtol=1e-5, atol=1e-6)

    rplan = ta.afn_plan("gaussian", TParams.make(*p0, dtype=torch.float64), torch.tensor(X), **kw)
    rpre = ta.afn_setup_from_plan("gaussian", TParams.make(*p0, dtype=torch.float64), torch.tensor(X), rplan,
                                  require_grad=True)
    assert not rplan.use_ran and int(rpre.breakdown) > 0
    r = torch.tensor(np.random.default_rng(7).normal(size=X.shape[0]))
    y = rpre.solve(r)
    assert torch.isfinite(y).all() and float(r @ y) > 0.0
    assert np.isfinite(float(rpre.logdet())) and torch.isfinite(rpre.trace()).all()
    assert torch.isfinite(rpre.dvp(r)).all()
