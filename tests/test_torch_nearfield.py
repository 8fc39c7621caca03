"""Port parity: the KNN pattern, its symmetrization (with the skewed
in-degree guard), the ELL products, the trigonometric polynomial and the
near-field correction vs ops/knn.py, ops/matops.py and ops/fastsum.py,
float64 on CPU.

Tolerances:
- patterns: exact equality (indices and masks; the data is tie-free);
- ELL products, trigpoly values and near-field values: 1e-10 relative to
  the largest entry (same formulas in float64, sums in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops import knn as jknn
from nfft4gp_tpu.ops import matops as jmat
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_torch.ops import fastsum as tfs
from nfft4gp_torch.ops import knn as tknn
from nfft4gp_torch.ops import matops as tmat
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows

RTOL = 1e-10
WINDOWS = [[0, 1, 2], [3, 4], [5]]


def _close(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * np.abs(j).max())


def _equal(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    np.testing.assert_array_equal(t, np.asarray(j))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(71)
    return rng.uniform(size=(300, 6)), rng.normal(size=(3, 300))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("variant", ["device", "host"])
def test_knn_pattern(data, d, variant):
    X = data[0][:, :d]
    lfil = 12
    if variant == "device":
        ti, tm = tknn.knn_pattern(torch.tensor(X), lfil, block=64, col_block=100)
        ji, jm = jknn.knn_pattern(jnp.asarray(X), lfil, block=64, col_block=100)
    else:
        ti, tm = tknn.knn_pattern_host(X, lfil)
        ji, jm = jknn.knn_pattern_host(X, lfil)
    _equal(ti, ji)
    _equal(tm, jm)


def test_symmetrize_pattern(data):
    X = data[0][:, :2]
    ji, jm = jknn.knn_pattern(jnp.asarray(X), 10)
    for t, j in zip(tfs.symmetrize_pattern(torch.tensor(np.asarray(ji)), torch.tensor(np.asarray(jm))),
                    jfs.symmetrize_pattern(ji, jm)):
        _equal(t, j)
    # the single-plan variant (KNN, symmetrize, guard) of one 2-D window
    t = tfs.nearfield_patterns("matern12", tfs.fastsum_geometry(torch.tensor(X), 16), 10, sym=True)
    j = jfs.nearfield_patterns("matern12", jfs.fastsum_geometry(jnp.asarray(X), 16), 10, sym=True)
    assert t[2] is True and j[2] is True
    _equal(t[0], j[0])
    _equal(t[1], j[1])


def _geoms(X, N=16):
    return (tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(WINDOWS), N=N),
            jfs.additive_fastsum_geometry(jnp.asarray(X), j_windows(WINDOWS), N=N))


def test_additive_patterns_symmetrized(data):
    """Per-group KNN patterns and their symmetrized, padded form (the
    guard does not trip)."""
    tg, jg = _geoms(data[0])
    tp = tfs.additive_nearfield_patterns("matern12", tg, 8)
    jp = jfs.additive_nearfield_patterns("matern12", jg, 8)
    for t, j in zip(tp, jp):
        _equal(t[0], j[0])
        _equal(t[1], j[1])
    ts, js = tfs.symmetrize_nearfield_patterns(tp), jfs.symmetrize_nearfield_patterns(jp)
    for t, j in zip(ts, js):
        assert t[2] is True and j[2] is True
        _equal(t[0], j[0])
        _equal(t[1], j[1])


def test_symmetrize_guard_keeps_lower_triangular():
    """Point 0 is the nearest preceding neighbour of every later point
    (orthonormal points around the origin): its symmetrized row would be
    n wide, so the guard keeps every group lower-triangular."""
    n = 100
    X = np.vstack([np.zeros((1, n - 1)), np.eye(n - 1)])
    rng = np.random.default_rng(3)
    Y = rng.uniform(size=(n, 2))
    t_pats = (tknn.knn_pattern(torch.tensor(X), 2), None, tknn.knn_pattern(torch.tensor(Y), 2))
    j_pats = (jknn.knn_pattern(jnp.asarray(X), 2), None, jknn.knn_pattern(jnp.asarray(Y), 2))
    t_pats = tuple(None if p is None else (p[0][None], p[1][None]) for p in t_pats)
    j_pats = tuple(None if p is None else (p[0][None], p[1][None]) for p in j_pats)
    ts, js = tfs.symmetrize_nearfield_patterns(t_pats), jfs.symmetrize_nearfield_patterns(j_pats)
    assert ts[1] is None and js[1] is None
    for t, j in zip(ts[::2], js[::2]):
        assert t[2] is False and j[2] is False
        _equal(t[0], j[0])
        _equal(t[1], j[1])


@pytest.mark.parametrize("sym", [True, False])
def test_ell_products(data, sym):
    X, V = data
    ji, jm = jknn.knn_pattern(jnp.asarray(X[:, :2]), 8)
    if sym:
        ji, jm = jfs.symmetrize_pattern(ji, jm)
    idx = np.asarray(ji)
    val = np.where(np.asarray(jm), np.random.default_rng(5).normal(size=idx.shape), 0.0)
    ti, tv = torch.tensor(idx, dtype=torch.int64), torch.tensor(val)
    _close(tmat.ell_matvec(ti, tv, torch.tensor(V[0])), jmat.ell_matvec(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(V[0])))
    _close(tmat.ell_rmatvec(ti, tv, torch.tensor(V[0])), jmat.ell_rmatvec(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(V[0])))
    _close(tmat.ell_matvec_batch(ti, tv, torch.tensor(V)),
           jmat.ell_matvec_batch(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(V)))
    _close(tmat.ell_rmatvec_batch(ti, tv, torch.tensor(V)),
           jmat.ell_rmatvec_batch(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(V)))
    _close(tfs.nearfield_apply(sym, ti, tv, torch.tensor(V[1])),
           jfs.nearfield_apply(sym, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(V[1])))
    _close(tfs.nearfield_apply_batch(sym, ti, tv, torch.tensor(V)),
           jfs.nearfield_apply_batch(sym, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(V)))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_trigpoly(d):
    rng = np.random.default_rng(11 + d)
    N = 8
    b = rng.normal(size=(N,) * d)
    D = rng.uniform(-0.5, 0.5, size=(700, d))
    want = jfs.trigpoly_eval(jnp.asarray(b), jnp.asarray(D))
    _close(tfs.trigpoly_eval(torch.tensor(b), torch.tensor(D)), want)
    got = tfs.trigpoly_eval_multi_chunked([torch.tensor(b), torch.tensor(2 * b)], torch.tensor(D), chunk=128)
    _close(got[0], want)
    _close(got[1], 2 * np.asarray(want))


@pytest.mark.parametrize("sym", [True, False])
def test_nearfield_correction(data, sym):
    """Values on the JAX pattern of every window group, tapered (default)."""
    tg, jg = _geoms(data[0])
    pats = jfs.additive_nearfield_patterns("matern12", jg, 8)
    if sym:
        pats = jfs.symmetrize_nearfield_patterns(pats)
        assert pats[0][2] is True
    tp, jp = TParams.make(1.0, 0.3, 0.05, dtype=torch.float64), JParams.make(1.0, 0.3, 0.05)
    for (dw, _, tgeos), (_, _, jgeo), pat in zip(tg.groups, jg.groups, pats):
        for k, g in enumerate(tgeos):
            jgk = jfs.FastsumGeometry(N=16, d=dw, x=jgeo.x[k], scale=jgeo.scale[k], Tcs=jgeo.Tcs[k])
            jplan = jfs.fastsum_coeffs("matern12", jp, jgk, nearfield_lfil=0)
            tplan = tfs.fastsum_coeffs("matern12", tp, g, nearfield_lfil=0)
            pk = (np.asarray(pat[0][k]), np.asarray(pat[1][k]))
            t = tfs.nearfield_correction("matern12", tp, g, tplan.b, tplan.db_l, 12,
                                         pattern=(torch.tensor(pk[0]), torch.tensor(pk[1])))
            j = jfs.nearfield_correction("matern12", jp, jgk, jplan.b, jplan.db_l, 12,
                                         pattern=(jnp.asarray(pk[0]), jnp.asarray(pk[1])))
            _equal(t[0], np.asarray(j[0]).astype(np.int64))
            _close(t[1], j[1])
            _close(t[2], j[2])
