"""Port parity: the stream engine's radius near-field (ops/fastsum.py
additive_nearfield_stencil_direct, _nf_direct_values, packed_ndft_plan's
nf_stencils) and GPProblem's engine selection vs the JAX package, float64 on
CPU, the JAX packed kernels in interpret mode.

The JAX package stores this matrix as a dense cell stencil; the port keeps
its in-radius pairs as a symmetric padded-ELL matrix.  The values are
compared as dense matrices.

Tolerances:
- the cell grids under the stencils: exact equality; the radius rtol 1e-14
  (the packages' geometries scale the points to the last bit apart);
- near-field values against JAX and against a brute-force evaluation over
  all pairs: 1e-10 relative to the largest entry (the same formulas in
  float64, sums in other orders);
- packed matvecs with the stencils, K and gradient, single and batched:
  2e-5 relative to the largest entry (JAX's table_f32 kernels round the
  table and alpha to float32), and the near-field's share of them (with
  minus without stencils) 1e-10;
- GPProblem(matern12, stream) loss rtol 1e-6, gradient 1e-5 of its largest
  entry, as tests/test_torch_problem.py's stream-engine case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.ops import cellgrid as jcg
from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.problem import state_from_numpy
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.ops import fastsum as tfs
from nfft4gp_torch.ops.kernels import BASE_KERNELS
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows

WINDOWS = [[0, 1], [2, 3], [4]]
LFIL = 12
PARAMS = (1.0, 0.3, 0.05)


def _close(t, j, rtol):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


@pytest.fixture(scope="module")
def setup():
    X = np.random.default_rng(17).uniform(size=(400, 5))
    tg = tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(WINDOWS), N=16)
    jg = jfs.additive_fastsum_geometry(jnp.asarray(X), j_windows(WINDOWS), N=16)
    ts = tfs.additive_nearfield_stencil_direct(tg, "matern12", LFIL)
    js = jfs.additive_nearfield_stencil_direct(jg, "matern12", LFIL)
    tplan = tfs.additive_fastsum_coeffs("matern12", TParams.make(*PARAMS, dtype=torch.float64), tg,
                                        nearfield_lfil=0)
    jplan = jfs.additive_fastsum_coeffs("matern12", JParams.make(*PARAMS), jg, nearfield_lfil=0)
    return X, tg, jg, ts, js, tplan, jplan


def _dense(entry, n):
    M = np.zeros((n, n))
    rows = np.repeat(np.arange(n), entry.idx.shape[1])
    np.add.at(M, (rows, entry.idx.reshape(-1).numpy()), entry.A_k.reshape(-1).numpy())
    return M


def test_stencil_grids(setup):
    """Same radius and grid per window; the window's pairs are exactly those
    of its stencil within rho, each row's self included."""
    X, tg, jg, ts, js, _, _ = setup
    assert [g is None for g in ts] == [g is None for g in js]
    for (dw, _, tgeos), tgroup, jgroup in zip(tg.groups, ts, js):
        for k, (t, j) in enumerate(zip(tgroup, jgroup)):
            # the two geometries scale the points in another summation order
            np.testing.assert_allclose(t.rho, j.rho, rtol=1e-14)
            assert t.grid.shape == j.dev.shape and t.grid.c == j.dev.c
            grid = jcg.build_cell_grid(np.asarray(tgeos[k].x), target_occupancy=max(4.0, LFIL / 3.0))
            for name in ("perm", "cell_of", "rank_of", "starts"):
                np.testing.assert_array_equal(getattr(t.grid, name), getattr(grid, name))
            x = tgeos[k].x.numpy()
            r2 = np.sum((x[:, None, :] - x[None, :, :]) ** 2, axis=2)
            want = np.sort(np.nonzero(r2.reshape(-1) <= t.rho ** 2)[0])
            width = t.idx.shape[1]
            got = np.sort((t.pos // width).numpy() * X.shape[0] + t.idx.reshape(-1)[t.pos].numpy())
            np.testing.assert_array_equal(got, want)


def test_direct_values_vs_jax_and_bruteforce(setup):
    X, tg, jg, ts, js, tplan, jplan = setup
    n = X.shape[0]
    tp = TParams.make(*PARAMS, dtype=torch.float64)
    for (dw, _, tplans), (_, _, jplans), tgroup, jgroup in zip(tplan.groups, jplan.groups, ts, js):
        for k, (t, j) in enumerate(zip(tgroup, jgroup)):
            tpl = tplans[k]
            got = tfs._nf_direct_values(t, "matern12", tp, tpl.geom.scale, tpl.b, tpl.db_l)
            je = jfs._nf_direct_values(j, "matern12", JParams.make(*PARAMS), jplans.geom.scale[k],
                                       jplans.b[k], jplans.db_l[k], True)
            # the JAX exception list of a direct stencil is empty: one zero
            # entry, which the port leaves out
            for a in (je.exc_v_k, je.exc_v_l):
                assert a.shape == (1,) and float(a[0]) == 0.0
            eye = jnp.eye(n, dtype=jnp.float64)
            for A_t, A_j in ((got.A_k, je.A_k), (got.A_l, je.A_l)):
                want = np.asarray(jcg.stencil_matvec(j.dev, A_j, eye, user_order=True))
                _close(_dense(tfs.NfStencilEntry(got.idx, A_t, None), n), want, 1e-10)
            # brute force over all pairs, in the port's own formulas
            x = tpl.geom.x
            D = x[:, None, :] - x[None, :, :]
            r = torch.sqrt(torch.sum(D * D, dim=2))
            phi, _ = BASE_KERNELS["matern12"](r * r / tpl.geom.scale ** 2, tp.l)
            tp_f = tfs.trigpoly_eval(tpl.b, D.reshape(-1, dw)).reshape(n, n)
            brute = torch.where(r <= t.rho, (phi - tp_f) * torch.clamp(1 - r / t.rho, min=0) ** 2, 0.0)
            _close(_dense(got, n), brute, 1e-10)
            assert np.abs(_dense(got, n) - _dense(got, n).T).max() == 0.0


def test_packed_matvecs_with_stencils(setup):
    X, tg, jg, ts, js, tplan, jplan = setup
    V = np.random.default_rng(5).normal(size=(3, X.shape[0]))
    kw = dict(interpret=True, upcast=True, prec="highest")

    def jall(pn, Vj):
        return (jfs.packed_ndft_matvec(pn, Vj[0], **kw), jfs.packed_ndft_grad_matvec(pn, Vj[0], **kw),
                jfs.packed_ndft_matvec_batch(pn, Vj, **kw), jfs.packed_ndft_grad_matvec_batch(pn, Vj, **kw))

    def tall(pn, Vt):
        return (tfs.packed_ndft_matvec(pn, Vt[0]), tfs.packed_ndft_grad_matvec(pn, Vt[0]),
                tfs.packed_ndft_matvec_batch(pn, Vt), tfs.packed_ndft_grad_matvec_batch(pn, Vt))

    jwith = jax.jit(lambda Vj: jall(jfs.packed_ndft_plan(jplan, nf_stencils=js), Vj))(jnp.asarray(V))
    jwithout = jax.jit(lambda Vj: jall(jfs.packed_ndft_plan(jplan), Vj))(jnp.asarray(V))
    tpn = tfs.packed_ndft_plan(tplan, nf_stencils=ts)
    assert len(tpn.nf) == 3 and all(isinstance(e, tfs.NfStencilEntry) for e in tpn.nf)
    twith = tall(tpn, torch.tensor(V))
    twithout = tall(tfs.packed_ndft_plan(tplan), torch.tensor(V))
    for tw, jw, t0, j0 in zip(twith, jwith, twithout, jwithout):
        _close(tw, jw, 2e-5)
        _close(tw - t0, np.asarray(jw) - np.asarray(j0), 1e-10)


def test_duplicate_features_fall_back_to_knn():
    """Integer features: the grids degenerate, both packages refuse the
    radius near-field, and GPProblem's stream engine keeps KNN patterns on
    every window."""
    X = np.random.default_rng(0).integers(0, 4, size=(1200, 4)).astype(np.float64)
    windows = [[0, 1], [2, 3]]
    tg = tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(windows))
    jg = jfs.additive_fastsum_geometry(jnp.asarray(X), j_windows(windows))
    assert tfs.additive_nearfield_stencil_direct(tg, "matern12", LFIL) is None
    assert jfs.additive_nearfield_stencil_direct(jg, "matern12", LFIL) is None
    prob = TProblem(kernel="matern12", windows=windows, operator="fastsum", fastsum_engine="stream",
                    rank=16, maxits=4, nvecs=2, fastsum_N=16)
    y = np.sin(X[:300, 0])
    loss, grad = prob.make_loss(torch.tensor(X[:300]), torch.tensor(y))(
        transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.5], dtype=torch.float64)))
    assert prob.nf_stencils_ is None and len(prob.nf_patterns_) == 1 and prob.nf_patterns_[0] is not None
    assert np.isfinite(float(loss)) and bool(torch.isfinite(grad).all())


def test_problem_matern12_stream_engine():
    """The default matern12 near-field on the stream engine: the radius
    stencils on the 2-D and 1-D windows, a KNN pattern on the 3-feature
    window; loss and gradient against the JAX GPProblem."""
    rng = np.random.default_rng(29)
    n = 240
    X = rng.uniform(size=(n, 6))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 4]) + 0.1 * rng.normal(size=n)
    kw = dict(kernel="matern12", windows=[[0, 1, 2], [3, 4], [5]], operator="fastsum",
              precond="nystrom", rank=16, maxits=6, nvecs=4, fastsum_N=16, fastsum_table_dtype=None,
              seed=3, fastsum_engine="stream")
    probes = j_probes(jax.random.PRNGKey(kw["seed"] + 1), kw["nvecs"], n, dtype=jnp.float64)
    perm = j_rand_perm(jax.random.PRNGKey(kw["seed"]), n, kw["rank"])
    inj = state_from_numpy("cpu", landmarks=np.asarray(perm), probes=np.asarray(probes))
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1], dtype=torch.float64))
    jl, jgrad = JProblem(**kw).make_loss(jnp.asarray(X), jnp.asarray(y))(jnp.asarray(raw.numpy()))
    prob = TProblem(**kw)
    tl, tgrad = prob.make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes,
                               landmarks=inj.landmarks)(raw)
    dims = [dw for dw, _, _ in tfs.additive_fastsum_geometry(torch.tensor(X), t_windows(kw["windows"])).groups]
    assert dims == [1, 2, 3]
    assert [s is not None for s in prob.nf_stencils_] == [True, True, False]
    assert [p is not None for p in prob.nf_patterns_] == [False, False, True]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, rtol=1e-5, atol=1e-5 * np.abs(jgrad).max())
    # injected stencils give the same loss
    tl2, _ = TProblem(**kw).make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes,
                                      landmarks=inj.landmarks, nf_stencils=prob.nf_stencils_)(raw)
    assert float(tl2) == float(tl)
