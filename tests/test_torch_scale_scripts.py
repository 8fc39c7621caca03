"""The scale-out scripts of the port on the CPU: scripts/torch_sharded_scale_demo.py
and scripts/torch_scaling_bench.py against one process and against the JAX
package, and the card paths of the port and of the new scripts free of jax.

- The demo (float64, n = 600, d = 4, rank 40, tol 1e-6, 40 iterations,
  compensated reductions, both engines): its mesh mode on a gloo world of 2
  ranks against its gpu mode in one process, and on the table engine (the
  JAX script's operator; the stream engine trims the Nyquist mode) both
  against the JAX script's solve (additive_fastsum_geometry / _coeffs with
  psd_clip, the windowed nystrom_setup, pcg and fgmres) on the same
  landmarks: PCG and FGMRES solutions within 1e-8 relative, the same
  iteration counts, the solution row-sharded (n / 2 rows a rank).  The mesh's Nystrom factor is
  the sharded TSQR one (sharded_nystrom_setup); in float64 it equals the
  tall SVD's to about 1e-13.  The TSQR itself in float32 on a gloo world of
  2 against one device's SVD and against the Gram eigendecomposition of the
  JAX package's sharded set-up; and the landmark file of chip_smoke.py's
  [scale] against jax.random.
- The scaling bench: the row-sharded matvec of both engines on a gloo world
  of 2 against one process (the script's rtol 1e-5, atol 1e-5), and the
  table engine's collectives a matvec, counted on the mesh, equal to what
  scripts/scaling_bench.py's collective_bytes reads from the JAX package's
  compiled HLO of the same problem (n = 512, d = 10, N = 32, float32) on the
  suite's 8-device virtual CPU mesh: one all-reduce of 5 x 34^2 x 4 = 23120
  bytes.  The stream engine's: one all-reduce of the trimmed 5 x 32^2 x 4.
- The port's modules, chip_smoke.py, these scripts and the profiling and
  probe scripts (scripts/torch_loss_profile.py and the five beside it) on
  their CPU paths with any import of jax refused; the profiling scripts
  without a card and without --platform cpu exit non-zero.
"""

import dataclasses
import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.parallel.mesh import make_mesh as j_make_mesh
from nfft4gp_tpu.parallel.sharded import shard_points as j_shard_points
from nfft4gp_tpu.preconds.nystrom import nystrom_setup as j_nystrom_setup
from nfft4gp_tpu.solvers.fgmres import fgmres as j_fgmres
from nfft4gp_tpu.solvers.pcg import pcg as j_pcg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
DEMO_ARGV = ["--n", "600", "--d", "4", "--rank", "40", "--iters", "40", "--tol", "1e-6", "--compensated",
             "--platform", "cpu", "--x64", "--devices", "2"]
X_RTOL = 1e-8


def _script(name):
    """A scripts/ module imported by name, so that spawned ranks can import
    its rank functions."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    return importlib.import_module(name)


def _jax_demo_solve(args, landmarks):
    """scripts/sharded_scale_demo.py's solve in float64 on one device."""
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(size=(args.n, args.d)))
    b = jnp.asarray(rng.normal(size=(args.n,)))
    windows = j_windows([[i, i + 1] for i in range(0, args.d, 2)])
    params = JParams.make(1.0, 0.5, args.mu, dtype=jnp.float64)
    geom = jfs.additive_fastsum_geometry(X, windows, N=args.fastsum_N)
    plan = jfs.additive_fastsum_coeffs("gaussian", params, geom, psd_clip=True)

    @jax.jit
    def solve(plan, Xv, bv, perm):
        pre = j_nystrom_setup("gaussian", params, Xv, perm, args.rank, require_grad=False, windows=windows)
        mv = lambda v: jfs.additive_fastsum_matvec(plan, v)  # noqa: E731
        res = j_pcg(mv, bv, precond=pre.solve, tol=args.tol, maxits=args.iters, compensated=args.compensated)
        kf = min(args.iters, 60)
        resf = j_fgmres(mv, bv, precond=pre.solve, kdim=kf, tol=args.tol, maxits=kf,
                        compensated=args.compensated)
        return res.x, res.niter, resf.x, resf.niter

    x, its, xf, fits = solve(plan, X, b, jnp.asarray(landmarks))
    return np.asarray(x), int(its), np.asarray(xf), int(fits)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def demo():
    return _script("torch_sharded_scale_demo")


@pytest.fixture(scope="module")
def jax_demo(demo):
    args = demo.build_argparser().parse_args(DEMO_ARGV)
    landmarks = demo.default_landmarks(args.n, args.rank).numpy()
    return landmarks, _jax_demo_solve(args, landmarks)


@pytest.mark.parametrize("engine", ["table", "stream"])
def test_demo_mesh_matches_one_process_and_jax(demo, jax_demo, engine):
    landmarks, (jx, jits, jxf, jfits) = jax_demo
    args = demo.build_argparser().parse_args(DEMO_ARGV + ["--engine", engine])
    one = demo.run_single(args, torch.device("cpu"), landmarks=landmarks)
    mesh = demo.run_mesh(args, landmarks=landmarks, timeout=120.0)
    assert mesh["rows_by_rank"] == [args.n // 2] * 2
    assert one["rows"] == args.n and mesh["x_pcg"].shape == (args.n,)
    assert mesh["pcg"]["iters"] == one["pcg"]["iters"] and mesh["fgmres"]["iters"] == one["fgmres"]["iters"]
    for rec in (one, mesh):
        assert rec["pcg"]["converged"] and rec["fgmres"]["converged"]
        if engine == "table":
            # the JAX script's operator; the stream engine trims the Nyquist mode
            assert rec["pcg"]["iters"] == jits and rec["fgmres"]["iters"] == jfits
            assert _rel(rec["x_pcg"], jx) <= X_RTOL
            assert _rel(rec["x_fgmres"], jxf) <= X_RTOL
    assert _rel(mesh["x_pcg"], one["x_pcg"]) <= X_RTOL
    assert _rel(mesh["x_fgmres"], one["x_fgmres"]) <= X_RTOL
    assert one["matvec_ms"] > 0 and one["build_s"] > 0


def test_demo_landmarks_file_is_the_jax_draw(demo):
    """tests/goldens/scale_demo_landmarks_1e6.json, which chip_smoke.py's
    [scale] hands the demo, holds scripts/sharded_scale_demo.py's own draw."""
    path = os.path.join(ROOT, "tests", "goldens", "scale_demo_landmarks_1e6.json")
    args = demo.build_argparser().parse_args(["--n", "1000000", "--rank", "200", "--landmarks", path])
    got = demo.landmarks_of(args).numpy()
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(0), args.n)[: args.rank])
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        demo.landmarks_of(demo.build_argparser().parse_args(["--n", "1000", "--landmarks", path]))


def test_demo_refuses_ranks_past_the_cards(demo):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the refusal is for a machine without one")
    with pytest.raises(SystemExit):
        demo.main(["--mode", "mesh", "--devices", "2", "--n", "64"])


def _tsqr_rank(mesh, A):
    """The rank's rows of U and sigma from parallel/sharded._tsqr_svd."""
    from nfft4gp_torch.parallel.sharded import _tsqr_svd, shard_points

    U, sigma = _tsqr_svd(mesh, shard_points(mesh, A))
    return mesh.all_gather(U, dim=0).numpy(), sigma.numpy()


def test_sharded_nystrom_tsqr_keeps_small_singular_values_in_float32():
    """The row-sharded Nystrom factor's thin SVD (TSQR, gloo world 2) on a
    float32 tall matrix with singular values from 1e4 down to 1e-3: sigma as
    accurate as one device's torch.linalg.svd (within 10x of its error) and
    U orthonormal to float32 rounding; the Gram eigendecomposition of the
    JAX package's sharded_nystrom_setup (parallel/sharded.py:293-299) loses
    the singular values below about sqrt(eps) sigma_max (its error is
    measured here too, and must exceed 100x the TSQR's)."""
    from nfft4gp_torch.parallel.mesh import run_ranks

    rng = np.random.default_rng(5)
    n, k = 4096, 32
    sig = np.logspace(4, -3, k)
    U0, _ = np.linalg.qr(rng.normal(size=(n, k)))
    V0, _ = np.linalg.qr(rng.normal(size=(k, k)))
    A = (U0 * sig) @ V0.T
    A32 = A.astype(np.float32)
    ref = np.linalg.svd(A32.astype(np.float64), compute_uv=False)
    U, sigma = run_ranks(_tsqr_rank, 2, A32, device="cpu", timeout=120.0, threads=2)[0]
    one = torch.linalg.svd(torch.from_numpy(A32), full_matrices=False)[1].numpy()
    lam, _ = np.linalg.eigh(A32.T @ A32)
    gram = np.sqrt(np.clip(lam[::-1], 0.0, None))
    err_tsqr, err_one, err_gram = (float(np.abs(s - ref).max()) for s in (sigma, one, gram))
    assert U.shape == (n, k) and sigma.dtype == np.float32
    assert err_tsqr <= 10.0 * err_one
    assert err_gram >= 100.0 * err_tsqr
    assert np.abs(U.astype(np.float64).T @ U - np.eye(k)).max() <= 1e-5


def _jax_hlo_collectives(n, d, N):
    """scripts/scaling_bench.py's HLO count of the sharded table matvec on
    the 8-device virtual mesh (its shard_group recipe)."""
    spec = importlib.util.spec_from_file_location("scaling_bench", os.path.join(SCRIPTS, "scaling_bench.py"))
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    windows = j_windows([[i, i + 1] for i in range(0, d, 2)])
    params = JParams.make(1.0, 0.5, 0.01, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.uniform(size=(n, d)), jnp.float32)
    v = jnp.asarray(rng.normal(size=(n,)), jnp.float32)
    plan = jax.jit(lambda Xq: jfs.additive_fastsum_build("gaussian", params, Xq, windows, N=N))(X)
    mesh = j_make_mesh(8)
    sh_T = NamedSharding(mesh, P(None, None, "points", None))
    sh_x = NamedSharding(mesh, P(None, "points", None))

    def shard_group(g):
        geom = dataclasses.replace(g.geom, Tcs=jax.device_put(g.geom.Tcs, sh_T), x=jax.device_put(g.geom.x, sh_x))
        return dataclasses.replace(g, geom=geom)

    plan_s = plan._replace(groups=tuple((dw, order, shard_group(p)) for dw, order, p in plan.groups))
    hlo = jax.jit(jfs.additive_fastsum_matvec).lower(plan_s, j_shard_points(mesh, v)).compile().as_text()
    return sb.collective_bytes(hlo)


def test_scaling_collectives_match_jax_hlo_and_parity():
    from nfft4gp_torch.parallel.mesh import run_ranks

    bench = _script("torch_scaling_bench")
    n, d, N = 512, 10, 32
    want = _jax_hlo_collectives(n, d, N)
    assert want == {"all-reduce": {"count": 1, "bytes": 5 * 34 * 34 * 4}}
    outs = run_ranks(bench.rank_matvecs, 2, n, d, N, device="cpu", timeout=120.0, threads=2)
    ref = bench.single_outputs(n, d, N, torch.device("cpu"))
    for rank_out in outs:
        assert bench.hlo_counts(rank_out["table"]["collectives"]) == want
        assert rank_out["stream"]["collectives"] == {"psum": {"count": 1, "bytes": 5 * 32 * 32 * 4}}
    for engine in bench.ENGINES:
        par = bench.parity(np.concatenate([o[engine]["y"] for o in outs]), ref[engine])
        assert par["ok"], (engine, par)


def test_scaling_model():
    bench = _script("torch_scaling_bench")
    eff = bench.model_efficiency(23120, 1, 1000.0, 65.0, 900.0, 1.0)
    assert list(eff) == ["P2", "P4", "P8", "P16"]
    assert all(0.0 < e < 1.0 for e in eff.values())
    assert eff["P2"] > eff["P4"] > eff["P8"] > eff["P16"]
    # one collective's host floor alone: t_comp / (t_comp + floor + link + hops)
    t2 = 500.0
    assert eff["P2"] == pytest.approx(t2 / (t2 + 65.0 + 23120 / 900e3 + 2.0))


def test_port_and_new_scripts_run_without_jax():
    """The port's modules, chip_smoke.py and the new scripts' functions on
    their card code paths (here on the CPU at a toy size), with any import
    of jax made to fail."""
    code = f"""
import sys
sys.modules['jax'] = None
sys.path[:0] = [{ROOT!r}, {SCRIPTS!r}]
import pkgutil, importlib, torch
import nfft4gp_torch, chip_smoke
import preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
import torch_test1_oracle, torch_sharded_scale_demo as demo, torch_scaling_bench as bench
import torch_scale_nystrom_probe as probe, torch_card, torch_scale_solve_probe
from nfft4gp_torch.utils import timers, debug
from nfft4gp_torch.parallel.mesh import make_mesh, close_mesh
cpu = torch.device('cpu')
args = torch_test1_oracle.build_argparser().parse_args(['--n', '64', '--kernel', 'matern12', '--platform', 'cpu'])
torch_test1_oracle.format_table(torch_test1_oracle.oracle_table(args, cpu))
for engine in ('table', 'stream'):
    a = demo.build_argparser().parse_args(['--mode', 'gpu', '--n', '256', '--rank', '16', '--iters', '5',
                                           '--engine', engine, '--platform', 'cpu'])
    demo.run_single(a, cpu)
mesh = make_mesh(1, device='cpu')
try:
    a = demo.build_argparser().parse_args(['--mode', 'mesh', '--n', '256', '--rank', '16', '--iters', '5',
                                           '--devices', '1', '--engine', 'stream', '--platform', 'cpu'])
    demo.mesh_rank(mesh, a)
    b = bench.build_argparser().parse_args(['--n', '256'])
    bench.world1_record(mesh, b, [256], 'cpu')
    probe.mesh_runs(demo, 256, mesh, cpu)
finally:
    close_mesh()
assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)
print('ok')
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


# the port's profiling and probe scripts at toy sizes on the CPU
PROFILE_SCRIPT_ARGV = {
    "torch_loss_profile": ["--n", "256", "--d", "4", "--nvecs", "3", "--maxits", "4", "--rank", "16", "--reps", "1"],
    "torch_loss_bench": ["--n", "256", "--d", "4", "--nvecs", "3", "--maxits", "4", "--reps", "1"],
    "torch_setup_timing": ["--n", "512", "--d", "4", "--table-dtype", "float32"],
    "torch_afn_solve_profile": ["--n", "300", "--d", "4", "--rank", "16", "--lfil", "8", "--iters", "1"],
    "torch_rank_dispatch_probe": ["--n", "400"],
    "torch_op_accuracy_probe": ["--n", "256", "--d", "4"],
}


@pytest.mark.parametrize("script", list(PROFILE_SCRIPT_ARGV))
def test_profile_scripts_run_without_jax(script, tmp_path):
    """Each profiling script's main on the CPU with any import of jax made to
    fail; without a card and without --platform cpu it exits non-zero."""
    argv = PROFILE_SCRIPT_ARGV[script] + ["--json", str(tmp_path / "out.json")]
    code = f"""
import sys
sys.modules['jax'] = None
sys.path[:0] = [{ROOT!r}, {SCRIPTS!r}]
import importlib, torch
mod = importlib.import_module({script!r})
mod.main({argv!r} + ['--platform', 'cpu'])
if not torch.cuda.is_available():
    try:
        mod.main({argv!r})
    except SystemExit as e:
        assert e.code not in (0, None), e.code
    else:
        raise AssertionError('ran without a card and without --platform cpu')
assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)
print('ok')
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
