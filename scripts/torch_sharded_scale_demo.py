"""Scale-out demonstration on the PyTorch port: row-sharded additive-NDFT PCG
and FGMRES at large n; the port of scripts/sharded_scale_demo.py.

Two modes:
  --mode mesh : ranks of parallel/mesh.py's run_ranks, one process a device,
                the points axis row-sharded: NCCL on the cards (one rank a
                card; NCCL refuses two ranks on one card), gloo with
                --platform cpu.  The same solvers as one device, with the
                process group's all_reduce for every Krylov dot and norm and
                one all_reduce of the small mode tensors a matvec
                (parallel/sharded.py); the Nystrom factor's rows sharded
                (sharded_nystrom_setup).  The solution stays row-sharded.
  --mode gpu  : one card (or the CPU with --platform cpu): big-n matvec
                throughput, then Nystrom-PCG and Nystrom-FGMRES.

Engines of the matvec (--engine):
  table  : the JAX script's operator, the folded-NDFT products in torch
           (additive_fastsum_matvec; sharded_table_ops in mesh mode);
  stream : the port's training path, one packed phase table (bf16 for
           float32 data, the data's dtype with --x64) through the table
           kernels of ops/packed_ndft.py (packed_ndft_matvec;
           sharded_stream_ops in mesh mode).

The problem is the JAX script's: n points in d dims and the right-hand side
from np.random.default_rng(0), 2-feature windows [i, i + 1], gaussian
(f, l) = (1, 0.5), the coefficients clipped to the PSD cone, --rank random
landmarks (a torch generator seeded 0 in place of jax.random.PRNGKey(0), or
the indices of --landmarks: tests/goldens/scale_demo_landmarks_1e6.json
holds the JAX script's own draw at n = 1e6).  It runs on the card by
default and fails without one:

  python scripts/torch_sharded_scale_demo.py --mode gpu --n 1000000 --iters 60 --compensated \
      --landmarks tests/goldens/scale_demo_landmarks_1e6.json
  python scripts/torch_sharded_scale_demo.py --mode mesh --devices 2 --n 20000 --platform cpu

Prints the JAX script's lines, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="mesh", choices=["mesh", "gpu"])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--devices", type=int, default=8, help="ranks of --mode mesh")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--fastsum-N", type=int, default=32)
    ap.add_argument("--mu", type=float, default=0.1)
    ap.add_argument("--rank", type=int, default=200)
    ap.add_argument("--compensated", action="store_true",
                    help="TwoSum float-float dot/norm accumulation in the solvers (solvers/reductions.py), "
                    "needed for deep tolerances at n ~ 1e6")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--engine", default="table", choices=["table", "stream"])
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU (gloo ranks in mesh mode); the default is the card")
    ap.add_argument("--x64", action="store_true", help="float64 data, operator and solvers")
    ap.add_argument("--landmarks", default=None,
                    help="a JSON file whose 'landmarks' list holds the Nystrom landmark indices (default: "
                    "a torch generator's draw, default_landmarks)")
    return ap


def windows_of(d: int):
    return [[i, i + 1] for i in range(0, d, 2)]


def make_problem(args, device):
    """(X (n, d), b (n,), params, windows) of the JAX script, on device."""
    import torch

    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    dtype = torch.float64 if args.x64 else torch.float32
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(size=(args.n, args.d)).astype(np.float64 if args.x64 else np.float32))
    b = torch.from_numpy(rng.normal(size=(args.n,)).astype(np.float64 if args.x64 else np.float32))
    params = KernelParams.make(1.0, 0.5, args.mu, dtype=dtype, device=device)
    return X.to(device), b.to(device), params, make_windows(windows_of(args.d))


def default_landmarks(n: int, rank: int):
    """The demo's random Nystrom landmarks: the first `rank` entries of a
    permutation from a CPU torch generator seeded 0."""
    import torch

    from nfft4gp_torch.utils.datasets import rand_perm

    return rand_perm(torch.Generator().manual_seed(0), n, rank)


def landmarks_of(args):
    """The landmarks of --landmarks (checked against n and rank), or the
    default draw."""
    import torch

    if args.landmarks is None:
        return default_landmarks(args.n, args.rank)
    with open(args.landmarks) as f:
        doc = json.load(f)
    lm = torch.tensor(doc["landmarks"], dtype=torch.int64)
    if lm.numel() < args.rank or int(lm.max()) >= args.n or int(lm.min()) < 0:
        raise ValueError(f"{args.landmarks}: {lm.numel()} landmarks in [{int(lm.min())}, {int(lm.max())}] do not "
                         f"serve rank {args.rank} of n = {args.n}")
    return lm


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _table_dtype(args):
    import torch

    return None if args.x64 else torch.bfloat16


def build_operator(args, X, params, windows, mesh=None):
    """(matvec, plan-build seconds): the staged build (geometry, then the
    PSD-clipped coefficients; the stream engine also packs its table) of the
    chosen engine, on all points; in mesh mode the plan cut to the rank's
    rows and the matvec mapping rows to rows."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.parallel.sharded import shard_plan, sharded_stream_ops, sharded_table_ops

    _sync(X.device)
    t0 = time.perf_counter()
    geom = fs.additive_fastsum_geometry(X, windows, N=args.fastsum_N)
    plan = fs.additive_fastsum_coeffs("gaussian", params, geom, psd_clip=True)
    if mesh is not None:
        plan = shard_plan(plan, mesh.rows(X.shape[0]))
        ops = sharded_table_ops if args.engine == "table" else (
            lambda m, p: sharded_stream_ops(m, p, table_dtype=_table_dtype(args)))
        mv = ops(mesh, plan)[0]
    elif args.engine == "table":
        mv = lambda v: fs.additive_fastsum_matvec(plan, v)  # noqa: E731
    else:
        pn = fs.packed_ndft_plan(plan, table_dtype=_table_dtype(args))
        mv = lambda v: fs.packed_ndft_matvec(pn, v)  # noqa: E731
    _sync(X.device)
    return mv, time.perf_counter() - t0


def time_matvecs(mv, b, iters, norm):
    """Seconds of one normalized matvec (y <- K (y / |y|), `iters` times),
    timed on a second run after an untimed one; the result must be finite."""
    import torch

    def run():
        y = b
        for _ in range(iters):
            y = mv(y / norm(y))
        return y

    y = run()
    _sync(b.device)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("the matvec produced non-finite values")
    t0 = time.perf_counter()
    run()
    _sync(b.device)
    return (time.perf_counter() - t0) / iters


def _solve_record(res, secs):
    return {"iters": int(res.niter), "relres": float(res.relres), "converged": bool(res.converged), "s": secs}


def solve(args, mv, b, pre, group=None):
    """Nystrom-PCG (maxits --iters) and Nystrom-FGMRES (kdim = maxits =
    min(iters, 60)), --compensated passed to both.  Returns their records
    and solutions.  At n ~ 1e6 in float32 the PCG quadratic form p'Ap drops
    below the matvec's noise floor and the breakdown guard freezes it;
    FGMRES tolerates the inexact matvec (the JAX script's note)."""
    from nfft4gp_torch.solvers.fgmres import fgmres
    from nfft4gp_torch.solvers.pcg import pcg

    t0 = time.perf_counter()
    res = pcg(mv, b, precond=pre.solve, tol=args.tol, maxits=args.iters, compensated=args.compensated,
              group=group)
    _sync(b.device)
    t1 = time.perf_counter()
    kf = min(args.iters, 60)
    resf = fgmres(mv, b, precond=pre.solve, kdim=kf, tol=args.tol, maxits=kf, compensated=args.compensated,
                  group=group)
    _sync(b.device)
    t2 = time.perf_counter()
    return {"pcg": _solve_record(res, t1 - t0), "fgmres": _solve_record(resf, t2 - t1)}, res.x, resf.x


def _run(args, X, b, params, windows, landmarks, mesh=None):
    """Build, time the matvecs, set up Nystrom and solve on this process's
    rows (all rows without a mesh)."""
    import torch

    from nfft4gp_torch.parallel.sharded import sharded_nystrom_setup
    from nfft4gp_torch.preconds.nystrom import nystrom_setup

    dev = X.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mv, build_s = build_operator(args, X, params, windows, mesh)
    if mesh is None:
        Xr, br, norm = X, b, torch.linalg.norm
    else:
        rows = mesh.rows(X.shape[0])
        Xr, br = X[rows], b[rows]
        norm = lambda v: torch.sqrt(mesh.psum(torch.dot(v, v)))  # noqa: E731
    mv_s = time_matvecs(mv, br, args.iters, norm)
    lm = torch.as_tensor(landmarks if landmarks is not None else landmarks_of(args))
    lm = lm.to(dev)[: args.rank]
    t0 = time.perf_counter()
    if mesh is None:
        pre = nystrom_setup("gaussian", params, X, lm, args.rank, require_grad=False, windows=windows)
    else:
        pre = sharded_nystrom_setup(mesh, "gaussian", params, Xr, X[lm], windows=windows)
    _sync(dev)
    nys_s = time.perf_counter() - t0
    recs, x, xf = solve(args, mv, br, pre, group=mesh)
    out = {"build_s": build_s, "matvec_ms": mv_s * 1e3, "mpts_per_s": args.n / mv_s / 1e6, "nystrom_s": nys_s,
           **recs, "rows": int(x.shape[0]), "x_pcg": x.double().cpu().numpy(),
           "x_fgmres": xf.double().cpu().numpy()}
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    return out


def run_single(args, device, landmarks=None):
    """--mode gpu on `device` (the card, or the CPU): the record of one run."""
    X, b, params, windows = make_problem(args, device)
    return _run(args, X, b, params, windows, landmarks)


def mesh_rank(mesh, args, landmarks=None):
    """--mode mesh on one rank (a run_ranks rank function; chip_smoke.py
    calls it with its own mesh): every rank makes the whole problem from the
    seed, builds the plan on all points and keeps its rows.  The solution
    must stay row-sharded: n / world rows on each rank."""
    X, b, params, windows = make_problem(args, mesh.device)
    out = _run(args, X, b, params, windows, landmarks, mesh)
    if out["rows"] != args.n // mesh.world:
        raise AssertionError(f"rank {mesh.rank}: the solution has {out['rows']} rows, not n / world = "
                             f"{args.n // mesh.world}")
    return out


def run_mesh(args, landmarks=None, timeout=1800.0):
    """--mode mesh: `args.devices` ranks (gloo on the CPU with --platform
    cpu, else NCCL, one card a rank), within `timeout` seconds; rank 0's
    record, with the solutions gathered in rank order and every rank's row
    count."""
    from nfft4gp_torch.parallel.mesh import run_ranks

    device = "cpu" if args.platform == "cpu" else None
    threads = max(1, (os.cpu_count() or 1) // args.devices) if device == "cpu" else None
    outs = run_ranks(mesh_rank, args.devices, args, landmarks, device=device, timeout=timeout,
                     threads=threads)
    rec = dict(outs[0])
    rec["rows_by_rank"] = [o["rows"] for o in outs]
    for key in ("x_pcg", "x_fgmres"):
        rec[key] = np.concatenate([o[key] for o in outs])
    if device is None:
        rec["peak_gib"] = max(o["peak_gib"] for o in outs)
    return rec


def nvidia_smi() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    on_cpu = args.platform == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        sys.exit("torch_sharded_scale_demo: no CUDA device; pass --platform cpu to run on the CPU")
    if args.mode == "mesh" and not on_cpu and args.devices > torch.cuda.device_count():
        sys.exit(f"torch_sharded_scale_demo: {args.devices} ranks need as many cards (NCCL refuses two ranks on "
                 f"one card); this machine has {torch.cuda.device_count()}")
    device = torch.device("cpu" if on_cpu else "cuda")
    card = None if on_cpu else f"{torch.cuda.get_device_name(0)}; nvidia-smi: {nvidia_smi()}"
    if args.mode == "mesh":
        print(f"mesh: {args.devices} ranks ({'gloo' if on_cpu else 'nccl'}), points axis sharded; n={args.n}",
              flush=True)
        rec = run_mesh(args)
    else:
        print(f"single device ({card or 'cpu'}); n={args.n}", flush=True)
        rec = run_single(args, device)
    print(f"plan build: {rec['build_s']:.2f}s;  matvec: {rec['matvec_ms']:.2f} ms -> {rec['mpts_per_s']:.1f} "
          f"Mpts/s", flush=True)
    p, f = rec["pcg"], rec["fgmres"]
    print(f"PCG: {p['iters']} its, relres {p['relres']:.2e} | FGMRES: {f['iters']} its, relres {f['relres']:.2e} | "
          f"{rec['nystrom_s'] + p['s'] + f['s']:.2f}s (sharded mode: {args.mode == 'mesh'}, compensated: "
          f"{args.compensated}, tol: {args.tol})", flush=True)
    out = {k: v for k, v in rec.items() if not k.startswith("x_")}
    out.update(mode=args.mode, engine=args.engine, n=args.n, d=args.d, N=args.fastsum_N, mu=args.mu,
               rank=args.rank, iters=args.iters, tol=args.tol, compensated=args.compensated,
               world=args.devices if args.mode == "mesh" else 1, dtype="float64" if args.x64 else "float32",
               device=card or "cpu")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
