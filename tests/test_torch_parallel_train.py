"""Port parity: the sharded train step (parallel/training.py) on 4 gloo ranks
against the JAX package's make_sharded_train_step and against the port's
own single-process loss (GPProblem.make_loss, which calls gp_loss); and the
dry run (parallel/dryrun.py) on 2 ranks.

Two paths, float64, n = 256 (64 rows a rank):
- gaussian, Nystrom, engine 'stream' (the table kernels' plain versions on
  the CPU), 2-D windows;
- matern12 with its lower-triangular KNN near-field, AFN, engine 'table',
  1-D and 2-D windows.
Both sides take one Adam step from the same mid-run Adam state (t = 3,
non-zero moments); the state, the JAX probes, landmarks and AFN plan are
carried across as numpy through models/problem.state_from_numpy.

Tolerances:
- against JAX, stream: the JAX test's loss rtol 1e-4, gradient and new
  parameters rtol 1e-3, atol 1e-5 (JAX's stream kernels store the table and
  round alpha to float32);
- against JAX, table (float64 on both sides): rtol 1e-7, atol 1e-10, as
  tests/test_torch_problem.py's matern12 losses (measured 1.3e-9 on the
  loss: the near-field's products differ in the last bits and the FGMRES
  and SLQ steps carry that);
- against the port's single-process loss: rtol 1e-9, atol 1e-12 (the
  same products, the sums over points reordered by the all_reduce);
- the dry run's own checks (rtol 1e-4 on the loss, 1e-3 / 1e-6 on the
  gradient, against one device).
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nfft4gp_torch.parallel.mesh import run_ranks

WORLD_TIMEOUT = 120.0
N, D_FEAT, WORLD = 256, 4, 4
STEP = dict(nys_rank=16, slq_its=4, nvecs=4, fastsum_N=16, adam_alpha=0.05, seed=3)
CASES = {
    "gaussian-nystrom-stream": dict(kernel="gaussian", precond="nystrom", engine="stream", windows=[[0, 1], [2, 3]]),
    "matern12-afn-table": dict(kernel="matern12", precond="afn", engine="table", windows=[[0], [1, 2], [3]]),
}
ADAM0 = dict(x=[0.5, -0.5, -2.0], m=[0.12, -0.05, 0.3], v=[0.02, 0.004, 0.09], t=3)


def _data():
    rng = np.random.default_rng(44)
    X = rng.uniform(size=(N, D_FEAT))
    y = np.sin(4.0 * X[:, 0]) + np.cos(3.0 * X[:, 2]) + 0.1 * rng.normal(size=N)
    return X, y


def _injected(carried):
    """The carried JAX state as port tensors (numpy through state_from_numpy)."""
    from nfft4gp_torch.models.problem import state_from_numpy

    return state_from_numpy("cpu", probes=carried["probes"], landmarks=carried["landmarks"],
                            afn_plan=SimpleNamespace(**carried["afn"]) if carried["afn"] else None,
                            adam_state=SimpleNamespace(**carried["adam"]))


def _step_kw(case, inj):
    kw = {k: v for k, v in CASES[case].items() if k != "windows"}
    return dict(kw, **STEP, landmarks=inj.landmarks, afn_plan=inj.afn_plan)


def _train_steps(mesh, carried):
    """Rank side: one sharded step of each case from the carried state."""
    from nfft4gp_torch.parallel.training import make_sharded_train_step, shard_training_data

    X, y = _data()
    out = {}
    for case in CASES:
        inj = _injected(carried[case])
        step = make_sharded_train_step(CASES[case]["windows"], mesh=mesh, **_step_kw(case, inj))
        state, loss, grad = step(inj.adam_state, *shard_training_data(mesh, X, y, inj.probes))
        out[case] = {"loss": float(loss), "grad": grad.numpy(), "x": state.x.numpy(), "t": state.t}
    return out


@pytest.fixture(scope="module")
def jax_side():
    """Per case what the port is handed (probes, landmarks, AFN plan, Adam
    state) and the JAX step's loss, gradient and new parameters."""
    import jax
    import jax.numpy as jnp
    from nfft4gp_tpu.models.adam import AdamState
    from nfft4gp_tpu.ops.kernels import KernelParams, make_windows
    from nfft4gp_tpu.parallel.mesh import make_mesh
    from nfft4gp_tpu.parallel.training import make_sharded_train_step, shard_training_data
    from nfft4gp_tpu.preconds.afn import afn_plan
    from nfft4gp_tpu.solvers.lanczos import rademacher_probes
    from nfft4gp_tpu.utils.datasets import rand_perm

    X, y = (jnp.asarray(a) for a in _data())
    mesh = make_mesh(8)
    probes = rademacher_probes(jax.random.PRNGKey(STEP["seed"] + 1), STEP["nvecs"], N, dtype=jnp.float64)
    state0 = AdamState(**{f: jnp.asarray(v, jnp.int32 if f == "t" else jnp.float64) for f, v in ADAM0.items()})
    out = {}
    for case, c in CASES.items():
        aplan = None
        if c["precond"] == "afn":
            aplan = afn_plan(c["kernel"], KernelParams.make(1.0, 1.0, 0.1), X, maxrank=24, lfil=6,
                             key=jax.random.PRNGKey(2), force_afn=True, rank=24)
        kw = {k: v for k, v in c.items() if k != "windows"}
        step = make_sharded_train_step(make_windows(c["windows"]), mesh=mesh, afn_plan=aplan, **kw, **STEP)
        Xs, ys, ps = shard_training_data(mesh, X, y, probes)
        state1, loss, grad = step(state0, Xs, ys, ps)
        out[case] = {
            "carried": {"probes": np.asarray(probes),
                        "landmarks": np.asarray(rand_perm(jax.random.PRNGKey(STEP["seed"]), N, STEP["nys_rank"])),
                        "afn": None if aplan is None else dict(perm=np.asarray(aplan.perm), k=int(aplan.k),
                                                               use_ran=bool(aplan.use_ran),
                                                               pattern=tuple(np.asarray(a) for a in aplan.pattern)),
                        "adam": {f: np.asarray(getattr(state0, f)) for f in ("x", "m", "v", "t")}},
            "loss": float(loss), "grad": np.asarray(grad), "x": np.asarray(state1.x), "t": int(state1.t)}
    return out


@pytest.fixture(scope="module")
def world4(jax_side):
    t0 = time.perf_counter()
    res = run_ranks(_train_steps, WORLD, {c: jax_side[c]["carried"] for c in CASES}, device="cpu",
                    timeout=WORLD_TIMEOUT, threads=1)
    return res, time.perf_counter() - t0


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_jax(world4, jax_side, case):
    res, _ = world4
    want = jax_side[case]
    if CASES[case]["engine"] == "stream":
        lrtol, rtol, atol = 1e-4, 1e-3, 1e-5
    else:
        lrtol, rtol, atol = 1e-7, 1e-7, 1e-10
    for r in res:
        got = r[case]
        assert np.isfinite(got["loss"]) and got["t"] == want["t"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=lrtol)
        np.testing.assert_allclose(got["grad"], want["grad"], rtol=rtol, atol=atol)
        np.testing.assert_allclose(got["x"], want["x"], rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_matches_single_process_loss(world4, jax_side, case):
    """The 4-rank loss and gradient == GPProblem.make_loss on one process,
    at the same raw parameters, probes, landmarks, AFN plan and KNN
    near-field pattern (lower-triangular, as the train step builds it)."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.ops import fastsum as tfs
    from nfft4gp_torch.ops.kernels import make_windows

    res, _ = world4
    c = CASES[case]
    inj = _injected(jax_side[case]["carried"])
    X, y = (torch.from_numpy(a) for a in _data())
    pats = None
    if c["kernel"] == "matern12":
        geom = tfs.additive_fastsum_geometry(X, make_windows(c["windows"]), N=STEP["fastsum_N"])
        pats = tuple(None if p is None else (p[0], p[1], False)
                     for p in tfs.additive_nearfield_patterns(c["kernel"], geom))
    prob = GPProblem(kernel=c["kernel"], windows=c["windows"], operator="fastsum", precond=c["precond"],
                     rank=STEP["nys_rank"], maxits=STEP["slq_its"], nvecs=STEP["nvecs"],
                     fastsum_N=STEP["fastsum_N"], fastsum_engine=c["engine"], fastsum_table_dtype=None,
                     seed=STEP["seed"])
    loss, grad = prob.make_loss(X, y, probes=inj.probes, landmarks=inj.landmarks, afn_plan=inj.afn_plan,
                                nf_patterns=pats)(inj.adam_state.x)
    for r in res:
        np.testing.assert_allclose(r[case]["loss"], float(loss), rtol=1e-9)
        np.testing.assert_allclose(r[case]["grad"], grad.numpy(), rtol=1e-9, atol=1e-12)


def test_every_rank_has_the_same_step(world4):
    res, seconds = world4
    assert seconds < WORLD_TIMEOUT
    for case in CASES:
        for r in res[1:]:
            assert r[case]["loss"] == res[0][case]["loss"]
            np.testing.assert_array_equal(r[case]["grad"], res[0][case]["grad"])


def test_dryrun_two_ranks():
    """parallel/dryrun.py on 2 gloo ranks: matern12 + AFN + the KNN
    near-field, one step against one device; the matvec's output row-local."""
    from nfft4gp_torch.parallel.dryrun import POINTS_PER_RANK, dryrun_multichip

    reports = dryrun_multichip(2, device="cpu", timeout=WORLD_TIMEOUT)
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["engine"] == "table" and np.isfinite(r["loss"])
        assert r["matvec_rows"] == POINTS_PER_RANK
        assert r["rows"] == [r["rank"] * POINTS_PER_RANK, (r["rank"] + 1) * POINTS_PER_RANK]


def test_mesh_refuses_the_card_without_one():
    """Nothing in parallel/ moves to the CPU unless asked: without a card the
    default device raises."""
    from nfft4gp_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1)
