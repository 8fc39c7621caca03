"""Port parity: the row-sharded building blocks of parallel/ on torch.distributed
against the JAX package's parallel/ (tests/test_sharding.py's cases).

The port runs in spawned gloo worlds on the CPU (one world of 2 ranks for
the building blocks, one of 4 for the train steps, each with its own time
limit; a hung collective fails a test, not the suite); the JAX side runs on
the 8-device mesh of tests/conftest.py, or on one device.  Inputs are the
same numpy arrays from a seed.  The rank functions import no jax: a rank
starts in about a second.

Tolerances:
- float64 building blocks (dot, dense matvec, NDFT adjoint, fastsum with
  and without the near-field, near-field both forms, FSAI, Nystrom against
  the JAX Gram-eigh set-up): 1e-10 relative (1e-12 for the dot; 1e-9 for
  FSAI's dval, as the JAX test), measured 1e-15 to 1e-13;
- PCG to relres 1e-10: rtol 1e-6, atol 1e-8 against the direct solve, as the
  JAX test;
- Nystrom against the single-device tall-SVD set-up: the JAX test's rtol
  2e-4 on the solve, 1e-5 on the logdet;
- the stream ops (float32 tables, the kernels' plain versions): the JAX
  test's rtol 2e-5, atol 2e-5 (5e-5 for the scaled batch row);
- the AFN + matern12 train step (float32, 4 ranks against the JAX step on 8
  devices): the JAX test's loss rtol 1e-4, gradient rtol 1e-3, atol 1e-5.
"""

import hashlib
import time

import numpy as np
import pytest
import torch

from nfft4gp_torch.parallel.mesh import run_ranks

WORLD_TIMEOUT = 120.0


# --- the ranks' side (no jax here) ----------------------------------------------


def _gathered(mesh, t):
    return mesh.all_gather(t, dim=-1).numpy()


def _blocks(mesh, D):
    """Every building block on this rank's shard; point-sized outputs
    gathered, so each rank returns the whole arrays."""
    from nfft4gp_torch.ops import fastsum as tfs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.parallel.sharded import (
        shard_plan,
        shard_points,
        sharded_dot,
        sharded_fastsum_matvec,
        sharded_fsai_setup,
        sharded_matvec_dense,
        sharded_ndft_adjoint,
        sharded_nearfield_matvec,
        sharded_nystrom_setup,
        sharded_stream_ops,
        _nearfield_local,
    )
    from nfft4gp_torch.solvers.pcg import pcg

    out = {}
    n = D["X"].shape[0]
    rows = mesh.rows(n)
    X = torch.from_numpy(D["X"])
    b = torch.from_numpy(D["b"])
    p = KernelParams.make(1.0, 0.3, 0.1, dtype=torch.float64)
    a_s, b_s = shard_points(mesh, 2.0 * D["b"], D["b"])
    out["dot"] = float(sharded_dot(mesh)(a_s, b_s))

    mv = sharded_matvec_dense(mesh, shard_points(mesh, D["K"]))
    y = mv(b_s)
    out["dense"], out["dense_rows"] = _gathered(mesh, y), y.shape[0]
    res = pcg(mv, b_s, tol=1e-10, maxits=300, group=mesh)
    out["pcg"] = _gathered(mesh, res.x)

    for N in (32, 16):
        plan = tfs.fastsum_build("gaussian", p, X, N=N)
        y = sharded_fastsum_matvec(mesh, shard_plan(plan, rows))(b_s)
        out[f"fastsum{N}"], out[f"fastsum{N}_rows"] = _gathered(mesh, y), y.shape[0]
    out["adjoint"] = sharded_ndft_adjoint(mesh)(shard_plan(plan, rows).geom.Tcs, b_s).numpy()

    idx_s, mask_s = shard_points(mesh, D["fsai_idx"].astype(np.int64), D["fsai_mask"])
    frows = sharded_fsai_setup(mesh, "gaussian", p, X, (idx_s, mask_s), require_grad=True)
    pre = frows.gather(mesh)
    out["fsai_val"], out["fsai_dval"] = pre.val.numpy(), pre.dval.numpy()
    out["fsai_breakdown"], out["fsai_solve"] = int(pre.breakdown), pre.solve(b).numpy()

    nf_idx, nf_val, nf_x = (shard_points(mesh, a) for a in (D["nf_idx"].astype(np.int64), D["nf_val"], D["nf_x"]))
    y = sharded_nearfield_matvec(mesh, nf_idx, nf_val)(nf_x)
    out["nearfield"], out["nearfield_rows"] = _gathered(mesh, y), y.shape[0]
    s_idx, s_val = shard_points(mesh, D["sym_idx"].astype(np.int64), D["sym_val"])
    xf = torch.from_numpy(D["nf_x"])
    out["nearfield_sym"] = _gathered(mesh, _nearfield_local(s_idx, s_val, nf_x, xf, mesh, sym=True))
    Xf = torch.stack([xf, -2.0 * xf])
    out["nearfield_batch"] = _gathered(mesh, _nearfield_local(nf_idx, nf_val, Xf[:, mesh.rows(xf.shape[0])], Xf,
                                                              mesh))

    Xm = torch.from_numpy(D["Xm"])
    plan = tfs.fastsum_build("matern12", p, Xm, N=16, nearfield_lfil=8)
    y = sharded_fastsum_matvec(mesh, shard_plan(plan, rows))(shard_points(mesh, D["bm"]))
    out["fastsum_nf"], out["fastsum_nf_rows"] = _gathered(mesh, y), y.shape[0]
    out["fastsum_nf_sym"] = bool(plan.nf_sym)

    Xs = torch.from_numpy(D["Xs"])
    ps = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float32)
    splan = tfs.additive_fastsum_build("matern12", ps, Xs, make_windows(D["windows"]))
    smv, sdmv = sharded_stream_ops(mesh, shard_plan(splan, rows))
    v_s = shard_points(mesh, D["vs"])
    y, dy = smv(v_s), sdmv(v_s)
    out["stream"], out["stream_rows"] = _gathered(mesh, y), y.shape[0]
    out["stream_grad"] = _gathered(mesh, dy)
    V = torch.stack([v_s, 2.0 * v_s, -v_s])
    out["stream_batch"] = _gathered(mesh, smv(V))

    X64 = torch.from_numpy(D["Xs"].astype(np.float64))
    p64 = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float64)
    perm = torch.from_numpy(D["nys_perm"].astype(np.int64))
    ny = sharded_nystrom_setup(mesh, "gaussian", p64, shard_points(mesh, X64), X64[perm],
                               windows=make_windows(D["windows"]))
    out["nystrom_solve"] = _gathered(mesh, ny.solve(shard_points(mesh, D["vs"].astype(np.float64))))
    out["nystrom_logdet"] = float(ny.logdet())

    try:
        shard_points(mesh, np.zeros(n + 1))
        out["uneven_raises"] = False
    except ValueError:
        out["uneven_raises"] = True
    return out


def _steps(mesh, D):
    """The 4-rank train steps: train_sharded's 3 Adam steps, and one AFN +
    matern12 step on the JAX side's probes and AFN plan."""
    from types import SimpleNamespace

    from nfft4gp_torch.models.adam import adam_init
    from nfft4gp_torch.models.problem import state_from_numpy
    from nfft4gp_torch.parallel.training import (
        make_sharded_train_step,
        shard_training_data,
        train_sharded,
    )

    _, losses = train_sharded(D["tX"], D["ty"], windows=[[0], [1, 2], [3]], mesh=mesh, adam_maxits=3,
                              nys_rank=16, slq_its=4, nvecs=4, fastsum_N=16, adam_alpha=0.05)
    inj = state_from_numpy("cpu", probes=D["probes"], afn_plan=SimpleNamespace(**D["afn"]))
    step = make_sharded_train_step([[0, 1], [2, 3]], kernel="matern12", precond="afn", afn_plan=inj.afn_plan,
                                   slq_its=4, nvecs=4, fastsum_N=16, engine="table", mesh=mesh)
    Xs, ys, ps = shard_training_data(mesh, D["X"], D["y"], inj.probes)
    _, loss, grad = step(adam_init(torch.tensor([0.5, -0.5, -2.0], dtype=torch.float32)), Xs, ys, ps)
    return {"losses": losses, "loss": float(loss), "grad": grad.numpy()}


def _rank1_raises(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 stops here")
    return float(mesh.psum(torch.ones(())))


def _sleeps(mesh):
    time.sleep(60)


# --- the JAX side and the checks ---------------------------------------------------


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs of tests/test_sharding.py's fixtures and cases."""
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.fastsum import symmetrize_pattern
    from nfft4gp_tpu.ops.kernels import KernelParams, kernel_matrix
    from nfft4gp_tpu.ops.knn import knn_pattern

    D = {}
    rng = np.random.default_rng(61)
    n = 256
    D["X"] = rng.uniform(size=(n, 2))
    D["b"] = rng.normal(size=(n,))
    D["K"] = np.asarray(kernel_matrix("gaussian", KernelParams.make(1.0, 0.3, 0.1), jnp.asarray(D["X"])))
    idx, mask = knn_pattern(jnp.asarray(D["X"]), 8)
    D["fsai_idx"], D["fsai_mask"] = np.asarray(idx), np.asarray(mask)

    rng = np.random.default_rng(3)
    nn, lfil = 128, 6
    Xn = rng.uniform(size=(nn, 2))
    idx, mask = (np.asarray(a) for a in knn_pattern(jnp.asarray(Xn), lfil))
    D["nf_idx"], D["nf_val"] = idx, np.where(mask, rng.normal(size=(nn, lfil)), 0.0)
    D["nf_x"] = rng.normal(size=(nn,))
    sidx, smask = symmetrize_pattern(idx, mask)
    # the values of a symmetric matrix w on the symmetrized pattern
    w = rng.normal(size=(nn, nn))
    w = w + w.T
    D["sym_idx"], D["sym_val"] = sidx, np.where(smask, w[np.arange(nn)[:, None], sidx], 0.0)

    rng = np.random.default_rng(5)
    D["Xm"] = rng.uniform(size=(256, 2))
    D["bm"] = rng.normal(size=(256,))

    rng = np.random.default_rng(9)
    D["Xs"] = rng.uniform(size=(256, 4)).astype(np.float32)
    D["vs"] = rng.normal(size=(256,)).astype(np.float32)
    D["windows"] = [[0, 1], [2, 3], [1]]
    D["nys_perm"] = np.random.default_rng(11).permutation(256)[:32]
    return D


@pytest.fixture(scope="module")
def world2(inputs):
    t0 = time.perf_counter()
    res = run_ranks(_blocks, 2, inputs, device="cpu", timeout=WORLD_TIMEOUT, threads=1)
    res[0]["seconds"] = time.perf_counter() - t0
    return res


@pytest.fixture(scope="module")
def mesh8():
    import jax
    from nfft4gp_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= 8, "host platform device count not applied"
    return make_mesh(8)


def _shard(mesh8, *arrays):
    import jax.numpy as jnp
    from nfft4gp_tpu.parallel.sharded import shard_points

    return shard_points(mesh8, *(jnp.asarray(a) for a in arrays))


def test_sharded_dot(world2, mesh8, inputs):
    from nfft4gp_tpu.parallel.sharded import sharded_dot

    a_s, b_s = _shard(mesh8, 2.0 * inputs["b"], inputs["b"])
    want = float(sharded_dot(mesh8)(a_s, b_s))
    np.testing.assert_allclose(world2[0]["dot"], want, rtol=1e-12)
    np.testing.assert_allclose(world2[0]["dot"], float(np.vdot(2.0 * inputs["b"], inputs["b"])), rtol=1e-12)


def test_sharded_dense_matvec(world2, mesh8, inputs):
    import jax
    from nfft4gp_tpu.parallel.sharded import sharded_matvec_dense

    K_s, b_s = _shard(mesh8, inputs["K"], inputs["b"])
    want = np.asarray(jax.jit(sharded_matvec_dense(mesh8, K_s))(b_s))
    np.testing.assert_allclose(world2[0]["dense"], want, rtol=1e-10)
    assert world2[0]["dense_rows"] == inputs["K"].shape[0] // 2        # output stays row-sharded


def test_pcg_on_sharded_inputs(world2, mesh8, inputs):
    """PCG with the group's dots and norms == the JAX PCG on sharded inputs
    and the direct solve."""
    import jax
    from nfft4gp_tpu.solvers.pcg import pcg

    K_s, b_s = _shard(mesh8, inputs["K"], inputs["b"])
    jx = np.asarray(jax.jit(lambda Km, bv: pcg(lambda x: Km @ x, bv, tol=1e-10, maxits=300).x)(K_s, b_s))
    direct = np.linalg.solve(inputs["K"], inputs["b"])
    np.testing.assert_allclose(world2[0]["pcg"], direct, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(world2[0]["pcg"], jx, rtol=1e-6, atol=1e-8)


def _jax_plan(kind, X, N, **kw):
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.fastsum import fastsum_build
    from nfft4gp_tpu.ops.kernels import KernelParams

    return fastsum_build(kind, KernelParams.make(1.0, 0.3, 0.1), jnp.asarray(X), N=N, **kw)


@pytest.mark.parametrize("N", [32, 16])
def test_fastsum_on_sharded_points(world2, inputs, N):
    """N = 32: the JAX test's GSPMD fastsum; N = 16: its shard_map form
    (test_sharded_fastsum_matvec_matches_local); both against the one-device
    JAX matvec."""
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.fastsum import fastsum_matvec

    want = np.asarray(fastsum_matvec(_jax_plan("gaussian", inputs["X"], N), jnp.asarray(inputs["b"])))
    np.testing.assert_allclose(world2[0][f"fastsum{N}"], want, rtol=1e-10)
    assert world2[0][f"fastsum{N}_rows"] == 128


def test_sharded_ndft_adjoint_matches_local(world2, mesh8, inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nfft4gp_tpu.ops.fastsum import _folded_adjoint
    from nfft4gp_tpu.parallel.sharded import sharded_ndft_adjoint

    plan = _jax_plan("gaussian", inputs["X"], 16)
    Tcs = jax.device_put(plan.geom.Tcs, NamedSharding(mesh8, P(None, "points", None)))
    A = np.asarray(sharded_ndft_adjoint(mesh8)(Tcs, _shard(mesh8, inputs["b"])))
    np.testing.assert_allclose(world2[0]["adjoint"], A, rtol=1e-10)
    np.testing.assert_allclose(world2[0]["adjoint"],
                               np.asarray(_folded_adjoint(plan.geom.Tcs, jnp.asarray(inputs["b"]))), rtol=1e-10)


def test_sharded_fastsum_matvec_matches_local(world2, mesh8, inputs):
    """The JAX shard_map fastsum matvec against the port's, row-sharded."""
    import dataclasses

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nfft4gp_tpu.parallel.sharded import sharded_fastsum_matvec

    plan = _jax_plan("gaussian", inputs["X"], 16)
    geom_s = dataclasses.replace(plan.geom, x=_shard(mesh8, plan.geom.x),
                                 Tcs=jax.device_put(plan.geom.Tcs, NamedSharding(mesh8, P(None, "points", None))))
    y = jax.jit(sharded_fastsum_matvec(mesh8, dataclasses.replace(plan, geom=geom_s)))(_shard(mesh8, inputs["b"]))
    np.testing.assert_allclose(world2[0]["fastsum16"], np.asarray(y), rtol=1e-10)
    assert world2[0]["fastsum16_rows"] == inputs["X"].shape[0] // 2


def test_sharded_fsai_setup_matches_local(world2, inputs):
    """Row-sharded FSAI set-up == the JAX one-device set-up (values,
    gradients, breakdown, solve), which tests/test_sharding.py holds equal
    to the JAX sharded one."""
    import jax
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.kernels import KernelParams
    from nfft4gp_tpu.preconds.fsai import fsai_setup

    p = KernelParams.make(1.0, 0.3, 0.1)
    pat = (jnp.asarray(inputs["fsai_idx"]), jnp.asarray(inputs["fsai_mask"]))

    @jax.jit
    def ref(X, b):
        pre = fsai_setup("gaussian", p, X, 8, require_grad=True, pattern=pat)
        return pre.val, pre.dval, pre.breakdown, pre.solve(b)

    val, dval, bad, sol = ref(jnp.asarray(inputs["X"]), jnp.asarray(inputs["b"]))
    got = world2[0]
    np.testing.assert_allclose(got["fsai_val"], np.asarray(val), rtol=1e-10)
    np.testing.assert_allclose(got["fsai_dval"], np.asarray(dval), rtol=1e-9, atol=1e-12)
    assert got["fsai_breakdown"] == int(bool(bad))
    np.testing.assert_allclose(got["fsai_solve"], np.asarray(sol), rtol=1e-10)


def test_sharded_nearfield_matvec(world2, mesh8, inputs):
    """Lower-triangular pattern: the transpose's reduce-scatter path, one
    vector and a batch of two, against the JAX one-device and shard_map
    forms."""
    import jax
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.fastsum import nearfield_matvec
    from nfft4gp_tpu.parallel.sharded import sharded_nearfield_matvec

    idx, val, x = (jnp.asarray(inputs[k]) for k in ("nf_idx", "nf_val", "nf_x"))
    want = np.asarray(nearfield_matvec(idx, val, x))
    sh = np.asarray(jax.jit(sharded_nearfield_matvec(mesh8, *_shard(mesh8, idx, val)))(_shard(mesh8, x)))
    np.testing.assert_allclose(world2[0]["nearfield"], want, rtol=1e-10)
    np.testing.assert_allclose(world2[0]["nearfield"], sh, rtol=1e-10)
    np.testing.assert_allclose(world2[0]["nearfield_batch"], np.stack([want, -2.0 * want]), rtol=1e-10)
    assert world2[0]["nearfield_rows"] == x.shape[0] // 2


def test_sharded_nearfield_matvec_symmetrized(world2, inputs):
    """Symmetrized pattern: one gather from the all-gathered x, against the
    dense symmetric matrix."""
    idx, val, x = inputs["sym_idx"], inputs["sym_val"], inputs["nf_x"]
    S = np.zeros((x.shape[0],) * 2)
    np.add.at(S, (np.repeat(np.arange(x.shape[0]), idx.shape[1]), idx.reshape(-1)), val.reshape(-1))
    np.testing.assert_allclose(S, S.T)
    np.testing.assert_allclose(world2[0]["nearfield_sym"], S @ x, rtol=1e-10, atol=1e-12)


def test_sharded_fastsum_matvec_with_nearfield(world2, mesh8, inputs):
    """matern12 with its lower-triangular KNN near-field: all_gather + the
    transpose's reduce-scatter, against the JAX one-device and sharded
    matvecs."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from nfft4gp_tpu.ops.fastsum import fastsum_matvec
    from nfft4gp_tpu.parallel.sharded import sharded_fastsum_matvec

    plan = _jax_plan("matern12", inputs["Xm"], 16, nearfield_lfil=8)
    assert plan.nf_val is not None and not world2[0]["fastsum_nf_sym"]
    want = np.asarray(fastsum_matvec(plan, jnp.asarray(inputs["bm"])))
    geom_s = dataclasses.replace(plan.geom, x=_shard(mesh8, plan.geom.x),
                                 Tcs=jax.device_put(plan.geom.Tcs, NamedSharding(mesh8, P(None, "points", None))))
    plan_s = dataclasses.replace(plan, geom=geom_s, nf_idx=_shard(mesh8, plan.nf_idx),
                                 nf_val=_shard(mesh8, plan.nf_val), nf_dval=_shard(mesh8, plan.nf_dval))
    sh = np.asarray(jax.jit(sharded_fastsum_matvec(mesh8, plan_s))(_shard(mesh8, inputs["bm"])))
    np.testing.assert_allclose(world2[0]["fastsum_nf"], want, rtol=1e-10)
    np.testing.assert_allclose(world2[0]["fastsum_nf"], sh, rtol=1e-10)
    assert world2[0]["fastsum_nf_rows"] == 128


def test_sharded_stream_ops_match_single_chip(world2, inputs):
    """The port's per-rank stream (plain kernel versions, float32 tables, a
    lower-triangular KNN near-field per window) == the JAX single-chip
    packed kernels in interpret mode."""
    import jax
    import jax.numpy as jnp
    from nfft4gp_tpu.ops import fastsum as fs
    from nfft4gp_tpu.ops.kernels import KernelParams, make_windows

    X, v = jnp.asarray(inputs["Xs"]), jnp.asarray(inputs["vs"])
    p = KernelParams.make(1.0, 0.5, 0.1, dtype=jnp.float32)
    W = np.asarray(make_windows(inputs["windows"]))
    pn = fs.packed_ndft_plan(jax.jit(lambda Xv: fs.additive_fastsum_build("matern12", p, Xv, W))(X))
    y_ref, dy_ref = (np.asarray(a) for a in jax.jit(lambda q: (
        fs.packed_ndft_matvec(pn, q, interpret=True, upcast=True),
        fs.packed_ndft_grad_matvec(pn, q, interpret=True, upcast=True)))(v))
    got = world2[0]
    np.testing.assert_allclose(got["stream"], y_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["stream_grad"], dy_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got["stream_batch"][1], 2.0 * y_ref, rtol=2e-5, atol=5e-5)
    np.testing.assert_allclose(got["stream_batch"][2], -y_ref, rtol=2e-5, atol=5e-5)
    assert got["stream_rows"] == X.shape[0] // 2


def test_sharded_nystrom_setup_matches_local(world2, mesh8, inputs):
    """Gram-eigh Nystrom on row shards == the JAX sharded set-up (float64)
    and, at the JAX test's limits, the one-device tall-SVD set-up."""
    import jax
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.kernels import KernelParams, make_windows
    from nfft4gp_tpu.parallel.sharded import sharded_nystrom_setup
    from nfft4gp_tpu.preconds.nystrom import nystrom_setup

    X = jnp.asarray(inputs["Xs"].astype(np.float64))
    v = jnp.asarray(inputs["vs"].astype(np.float64))
    p = KernelParams.make(1.0, 0.5, 0.1)
    windows = make_windows(inputs["windows"])
    perm = jnp.asarray(inputs["nys_perm"])
    sh = jax.jit(lambda Xv, Xk: sharded_nystrom_setup(mesh8, "gaussian", p, Xv, Xk, windows=windows))(
        _shard(mesh8, X), X[perm])
    got = world2[0]
    want = np.asarray(sh.solve(_shard(mesh8, v)))
    np.testing.assert_allclose(got["nystrom_solve"], want, rtol=1e-10, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(got["nystrom_logdet"], float(sh.logdet()), rtol=1e-10)
    r_ref, ld_ref = jax.jit(lambda Xv, vv: (lambda pre: (pre.solve(vv), pre.logdet()))(
        nystrom_setup("gaussian", p, Xv, perm, 32, windows=windows)))(X, v)
    r_ref = np.asarray(r_ref)
    np.testing.assert_allclose(got["nystrom_solve"], r_ref, rtol=2e-4, atol=2e-4 * np.abs(r_ref).max())
    np.testing.assert_allclose(got["nystrom_logdet"], float(ld_ref), rtol=1e-5)


def test_points_must_divide_over_ranks(world2):
    """n % world != 0 raises ValueError, as shard_map's divisibility rule."""
    assert world2[0]["uneven_raises"] and world2[1]["uneven_raises"]


def test_sharded_stream_ops_refuse_three_feature_windows():
    """3-D windows take the table engine (sharded_table_ops), as in JAX."""
    from nfft4gp_torch.ops import fastsum as tfs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.parallel.sharded import sharded_stream_ops

    X = torch.from_numpy(np.random.default_rng(2).uniform(size=(64, 4)))
    plan = tfs.additive_fastsum_build("gaussian", KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float64), X,
                                      make_windows([[0, 1, 2], [3]]), N=16)
    with pytest.raises(NotImplementedError):
        sharded_stream_ops(None, plan)


def test_ranks_return_the_same_gathered_results(world2):
    for key, val in world2[0].items():
        if key != "seconds":
            np.testing.assert_array_equal(np.asarray(world2[1][key]), np.asarray(val), err_msg=key)


@pytest.fixture(scope="module")
def world4_steps():
    """The JAX side's AFN + matern12 inputs (tests/test_sharding.py), and the
    port's 4-rank steps on them."""
    import jax
    import jax.numpy as jnp
    from nfft4gp_tpu.ops.kernels import KernelParams
    from nfft4gp_tpu.preconds.afn import afn_plan
    from nfft4gp_tpu.solvers.lanczos import rademacher_probes

    rng = np.random.default_rng(21)
    n = 256
    D = {"X": rng.uniform(size=(n, 4)).astype(np.float32), "y": rng.normal(size=(n,)).astype(np.float32)}
    D["probes"] = np.asarray(rademacher_probes(jax.random.PRNGKey(1), 4, n, dtype=jnp.float32))
    aplan = afn_plan("matern12", KernelParams.make(1.0, 1.0, 0.1, dtype=jnp.float32), jnp.asarray(D["X"]),
                     maxrank=24, lfil=6, key=jax.random.PRNGKey(2), force_afn=True, rank=24)
    D["afn"] = dict(perm=np.asarray(aplan.perm), k=int(aplan.k), use_ran=bool(aplan.use_ran),
                    pattern=tuple(np.asarray(a) for a in aplan.pattern))
    rng = np.random.default_rng(77)
    tn = 8 * 24
    D["tX"] = rng.uniform(size=(tn, 4))
    D["ty"] = np.sin(5 * D["tX"][:, 0]) + 0.1 * rng.normal(size=tn)
    res = run_ranks(_steps, 4, D, device="cpu", timeout=WORLD_TIMEOUT, threads=1)
    return D, aplan, res


def test_sharded_train_step(world4_steps):
    """train_sharded, 4 ranks: loss finite, decreasing over 3 steps, the same
    on every rank."""
    _, _, res = world4_steps
    losses = res[0]["losses"]
    assert np.isfinite(losses).all() and len(losses) == 3
    assert losses[-1] < losses[0]
    assert all(r["losses"] == losses for r in res)


def test_sharded_train_step_afn_matern12(world4_steps, mesh8):
    """AFN + matern12 (near-field on) on 4 gloo ranks == the JAX sharded step
    on 8 devices, same probes and AFN plan."""
    import jax.numpy as jnp
    from nfft4gp_tpu.models.adam import adam_init
    from nfft4gp_tpu.ops.kernels import make_windows
    from nfft4gp_tpu.parallel.training import make_sharded_train_step, shard_training_data

    D, aplan, res = world4_steps
    step = make_sharded_train_step(make_windows([[0, 1], [2, 3]]), kernel="matern12", precond="afn",
                                   afn_plan=aplan, slq_its=4, nvecs=4, fastsum_N=16, engine="table")
    X_s, y_s, p_s = shard_training_data(mesh8, jnp.asarray(D["X"]), jnp.asarray(D["y"]), jnp.asarray(D["probes"]))
    _, loss, grad = step(adam_init(jnp.asarray([0.5, -0.5, -2.0], jnp.float32)), X_s, y_s, p_s)
    for r in res:
        assert np.isfinite(r["loss"])
        np.testing.assert_allclose(r["loss"], float(loss), rtol=1e-4)
        np.testing.assert_allclose(r["grad"], np.asarray(grad), rtol=1e-3, atol=1e-5)


def test_world_fails_fast_on_a_rank_error():
    """A rank that raises ends the world (its peer, blocked in a collective,
    is terminated) and the error reaches the caller."""
    with pytest.raises(RuntimeError, match="rank 1 stops here"):
        run_ranks(_rank1_raises, 2, device="cpu", timeout=WORLD_TIMEOUT, threads=1)


def test_world_timeout_terminates_its_ranks():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        run_ranks(_sleeps, 2, device="cpu", timeout=3.0, threads=1)
    assert time.perf_counter() - t0 < 30.0


# --- group=None leaves the single-device solvers bit for bit as they were -----------

# sha256 of the float.hex() of the outputs below, from the solvers as they
# were before they took a `group` argument (float64 on the CPU, torch 2.13;
# the same with 1 and 8 intra-op threads)
_SINGLE_DEVICE_SHA = "23ceacef8f208fb6c1b9155755a0fc5800422f5ba6164e6a2af0820d19e6faea"


def test_group_none_leaves_solvers_and_loss_bitwise_unchanged():
    from nfft4gp_torch.models.gp import GPConfig, gp_loss, make_dense_ops
    from nfft4gp_torch.ops.kernels import KernelParams, kernel_matrix
    from nfft4gp_torch.preconds.nystrom import nystrom_setup
    from nfft4gp_torch.solvers.fgmres import fgmres
    from nfft4gp_torch.solvers.lanczos import lanczos_batch

    rng = np.random.default_rng(5)
    n = 48
    X = torch.tensor(rng.uniform(size=(n, 2)))
    y = torch.tensor(rng.normal(size=n))
    probes = torch.tensor(rng.choice([-1.0, 1.0], size=(3, n)))
    K = kernel_matrix("gaussian", KernelParams.make(1.0, 0.4, 0.05, dtype=torch.float64), X)
    out = []
    r = fgmres(lambda v: K @ v, y, kdim=12, maxits=12, tol=1e-12, group=None)
    out += r.x.tolist() + [float(r.relres)]
    r = fgmres(lambda v: K @ v, y, kdim=12, maxits=12, tol=1e-12, compensated=True, group=None)
    out += r.x.tolist()
    lb = lanczos_batch(lambda V: V @ K, probes, maxits=8, group=None)
    out += lb.x.flatten().tolist() + lb.alpha.flatten().tolist() + lb.beta.flatten().tolist()
    res = gp_loss(torch.tensor([0.3, -0.4, -1.5], dtype=torch.float64), y, make_dense_ops("gaussian", X), probes,
                  GPConfig(kind="gaussian", maxits=6, nvecs=3),
                  lambda p: nystrom_setup("gaussian", p, X, torch.arange(0, n, 3), 10, require_grad=True),
                  group=None)
    out += [float(res.loss)] + res.grad.tolist()
    assert len(out) == 290
    assert hashlib.sha256("".join(float(v).hex() for v in out).encode()).hexdigest() == _SINGLE_DEVICE_SHA
