"""Port parity: FPS, expand_perm, quantile cell grids and the rank estimates
vs the JAX package's ops/fps.py, utils/datasets.py, ops/cellgrid.py and
ops/rankest.py, on CPU in float64.

Tolerances:
- FPS perms, expand_perm, quantile grids, ranks and FPS prefixes: exact
  equality (the same arithmetic on the same points; the rank estimates get
  the subsample indices the JAX functions draw from their keys);
- FPS cover radii 1e-12 (GEMM summation order of the distance updates);
- the Nystrom error curve 1e-10 (the port sums the trailing Gram entries of
  the Cholesky factor, JAX forms each difference matrix; both far below the
  0.1 rank threshold's resolution).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import cellgrid as jcg
from nfft4gp_tpu.ops import fps as jfps
from nfft4gp_tpu.ops import rankest as jrk
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.utils.datasets import expand_perm as j_expand_perm
from nfft4gp_torch.ops import cellgrid as tcg
from nfft4gp_torch.ops import fps as tfps
from nfft4gp_torch.ops import rankest as trk
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.utils.datasets import expand_perm as t_expand_perm

CFG = dict(nsample=80, nsample_r=2)


def _points(n=300, d=2, seed=5):
    return np.random.default_rng(seed).uniform(size=(n, d))


def test_fps_and_fps_host():
    X = _points()
    jr = jfps.fps(jnp.asarray(X), 40)
    tr = tfps.fps(torch.tensor(X), 40)
    np.testing.assert_array_equal(tr.perm.numpy(), np.asarray(jr.perm))
    np.testing.assert_allclose(tr.dists.numpy(), np.asarray(jr.dists), rtol=1e-12)
    jperm, jres = jfps.fps_full_perm(jnp.asarray(X), 40)
    tperm, _ = tfps.fps_full_perm(torch.tensor(X), 40)
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    hp, hd = tfps.fps_host(X, 40)
    jhp, jhd = jfps.fps_host(X, 40)
    np.testing.assert_array_equal(hp, jhp)
    np.testing.assert_allclose(hd, jhd, rtol=1e-12)
    np.testing.assert_array_equal(hp, tr.perm.numpy())
    # watch-list quirk: k above the number of distinct points repeats a landmark
    Xd = np.repeat(_points(n=5, seed=1), 4, axis=0)
    hp, _ = tfps.fps_host(Xd, 8)
    np.testing.assert_array_equal(hp, jfps.fps_host(Xd, 8)[0])
    assert len(set(hp.tolist())) < 8


def test_expand_perm():
    for prefix in ([5, 2, 9], [0], list(range(10))):
        got = t_expand_perm(torch.tensor(prefix), 10)
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_expand_perm(jnp.asarray(prefix), 10)))


@pytest.mark.parametrize("case", ["d1", "d2", "d3", "pca-projection"])
def test_quantile_cell_grid(case):
    """The AFN plan's quantile binning, array for array (and degenerate ->
    None in both)."""
    rng = np.random.default_rng(7)
    if case == "pca-projection":          # a 2-PC projection of d = 10 data (dense core)
        X = rng.normal(size=(600, 10)) ** 3
        Xc = X - X.mean(0)
        X = Xc @ np.linalg.svd(Xc, full_matrices=False)[2][:2].T
    else:
        X = rng.uniform(size=(500, int(case[1]))) ** 2
    for kw in (dict(target_occupancy=15.0), dict(target_occupancy=8.0)):
        t = tcg.build_cell_grid(X, binning="quantile", **kw)
        j = jcg.build_cell_grid(X, binning="quantile", **kw)
        assert (t is None) == (j is None)
        if j is None:
            continue
        assert np.isnan(t.h) and np.isnan(j.h) and len(t.edges) == len(j.edges) == X.shape[1]
        for name in tcg.CellGrid._fields:
            tv, jv = getattr(t, name), getattr(j, name)
            if name == "edges":
                for a, b in zip(tv, jv):
                    np.testing.assert_array_equal(a, b)
            elif isinstance(jv, np.ndarray):
                assert tv.dtype == jv.dtype, name
                np.testing.assert_array_equal(tv, jv)
            elif name != "h":
                assert tv == jv, name
    Xdup = rng.integers(0, 2, size=(400, 2)).astype(np.float64)
    assert tcg.build_cell_grid(Xdup, binning="quantile") is None
    assert jcg.build_cell_grid(Xdup, binning="quantile") is None


def _jax_subsamples(key, n, cfg):
    """The subsample indices estimate_rank / rankest_default draw from key."""
    m = min(cfg.nsample, n)
    subs = []
    for _ in range(cfg.nsample_r):
        key, sub = jax.random.split(key)
        subs.append(np.asarray(jax.random.choice(sub, n, (m,), replace=False)))
    return subs


def test_nystrom_error_curve():
    X = _points(n=120)
    params = (1.0, 0.2, 0.01)
    order = np.asarray(jfps.fps(jnp.asarray(X), 120).perm)
    ranks = np.arange(1, 121)
    j = jrk.nystrom_error_curve("gaussian", JParams.make(*params), jnp.asarray(X[order]), jnp.asarray(ranks))
    t = trk.nystrom_error_curve("gaussian", TParams.make(*params, dtype=torch.float64),
                                torch.tensor(X[order]), torch.tensor(ranks))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-10)
    assert float(j[0]) > 0.1 > float(j[-1])


@pytest.mark.parametrize("kind,l", [("gaussian", 0.3), ("matern12", 0.05)])
def test_rank_estimates(kind, l):  # noqa: E741
    """estimate_rank, fill_distance_estimate and rankest_default with JAX's
    subsamples injected: equal ranks and FPS prefixes."""
    X = _points(n=400)
    cfg_j, cfg_t = jrk.RankestConfig(**CFG), trk.RankestConfig(**CFG)
    jp, tp = JParams.make(1.0, l, 0.01), TParams.make(1.0, l, 0.01, dtype=torch.float64)
    key = jax.random.PRNGKey(3)
    subs = _jax_subsamples(key, X.shape[0], cfg_j)
    Xj, Xt = jnp.asarray(X), torch.tensor(X)
    assert trk.estimate_rank(kind, tp, Xt, cfg=cfg_t, subsamples=subs) == \
        jrk.estimate_rank(kind, jp, Xj, key, cfg_j)
    sub_key = jax.random.split(key)[1]
    idx = np.asarray(jax.random.choice(sub_key, X.shape[0], (CFG["nsample"],), replace=False))
    t_est = trk.fill_distance_estimate(kind, tp, Xt, torch.tensor(idx))
    j_est = jrk.fill_distance_estimate(kind, jp, Xj, sub_key, nsample=CFG["nsample"])
    assert t_est[0] == j_est[0]
    np.testing.assert_allclose(t_est[1], j_est[1], rtol=1e-12)
    assert trk.eigencurve_rank(kind, tp, Xt, torch.tensor(idx)) == \
        jrk.eigencurve_rank(kind, jp, Xj, sub_key, nsample=CFG["nsample"])
    t_rank, t_prefix = trk.rankest_default(kind, tp, Xt, cfg=cfg_t, maxrank=60, subsamples=subs)
    j_rank, j_prefix = jrk.rankest_default(kind, jp, Xj, key, cfg_j, maxrank=60)
    assert t_rank == j_rank
    np.testing.assert_array_equal(t_prefix, j_prefix)
    # without injection the port draws its own subsamples from a generator
    assert 1 <= trk.estimate_rank(kind, tp, Xt, torch.Generator().manual_seed(0), cfg_t) <= X.shape[0]
