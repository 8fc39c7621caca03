"""AFN-PCG time-to-tolerance on the PyTorch port: the port of
scripts/afn_pcg_bench.py (BASELINE.json's "AFN-PCG time-to-tol at
N=1e5-1e6" metric, AFN_PCG.md).

Builds the same synthetic additive-kernel problem (n points in d dims from
np.random.default_rng(0), 2-feature windows [i, i + 1], right-hand side
from the same generator), the Fourier fastsum operator by the same recipe
(on the stream engine: the radius near-field stencils, psd_clip=True and a
solve-only plan, nf_require_grad=False) or the dense one, and compares PCG
and FGMRES with no preconditioner, Nystrom and AFN.  Per run it records
the same fields as the JAX script: iterations, final relres, solve seconds,
seconds per iteration, set-up seconds, converged, the iterations and time
to cross each tolerance decade, and a decimated residual history (--json).

It runs on the card (CUDA) by default and fails without one;
--platform cpu runs the stream engine's plain versions on the CPU:

  python scripts/torch_afn_pcg_bench.py --n 100000 --d 2 --kernel matern12 --l 0.1 \\
      --N 256 --nf-lfil 128 --tol 1e-2 --comp --replace-every 25 --json out.json
  python scripts/torch_afn_pcg_bench.py --n 2000 --d 2 --kernel matern12 --l 0.1 \\
      --N 64 --nf-lfil 32 --platform cpu --x64 --engine stream

Each solve runs twice and the second is timed, as in the JAX script.
The data, the operator and the AFN plan are the JAX script's; the Nystrom
landmarks are not (a torch generator seeded 7 in place of
jax.random.PRNGKey(7)), so only its AFN and unpreconditioned rows compare
with the JAX artifacts iteration for iteration.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DECADES = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--rank", type=int, default=200)
    ap.add_argument("--lfil", type=int, default=16)
    ap.add_argument("--l", type=float, default=0.5)
    ap.add_argument("--mu", type=float, default=0.01)
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--maxits", type=int, default=400)
    ap.add_argument("--kernel", default="gaussian")
    ap.add_argument("--operator", default="fastsum", choices=["fastsum", "dense"])
    ap.add_argument("--engine", default="auto", choices=["auto", "table", "stream"],
                    help="fastsum engine: the stream kernels with the radius near-field (the card's "
                    "default) or the torch table path (the CPU's)")
    ap.add_argument("--N", type=int, default=32, help="fastsum modes per dim")
    ap.add_argument("--nf-lfil", type=int, default=None, help="near-field size (None = kernel auto)")
    ap.add_argument("--table-dtype", default=None, choices=[None, "bfloat16"],
                    help="phase-table dtype of the stream engine (default: the data's)")
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    ap.add_argument("--x64", action="store_true", help="float64 data, operator and solvers")
    ap.add_argument("--fgmres-kdim", type=int, default=100)
    ap.add_argument("--comp", action="store_true",
                    help="compensated solver reductions (TwoSum dots and norms, the FGMRES x-update)")
    ap.add_argument("--comp-op", action="store_true",
                    help="also the compensated NDFT adjoint (table engine only; the stream engine "
                    "ignores it, as the JAX script's does)")
    ap.add_argument("--replace-every", type=int, default=-1,
                    help="PCG residual replacement period; -1 = auto: 25 on float32 preconditioned "
                    "runs, 0 in float64")
    ap.add_argument("--mixed", action="store_true",
                    help="float32 operator and preconditioner, float64 Krylov vectors")
    ap.add_argument("--precs", default="none,nystrom,afn")
    ap.add_argument("--solvers", default="pcg,fgmres")
    ap.add_argument("--json", default=None)
    return ap


def parse_args(argv=None):
    args = build_argparser().parse_args(argv)
    if args.replace_every < 0:
        args.replace_every = 0 if (args.x64 or args.mixed) else 25
    return args


def device_of(args):
    import torch

    if args.platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("torch_afn_pcg_bench: no CUDA device (use --platform cpu for the CPU)")
    return torch.device("cuda:0")


def make_problem(args, dev):
    """(X (n, d), b (n,), dtype): the JAX script's data, from
    np.random.default_rng(0), in float64 with --x64, else float32."""
    import torch

    dtype = torch.float64 if args.x64 else torch.float32
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(size=(args.n, args.d)), dtype=dtype).to(dev)
    b = torch.as_tensor(rng.normal(size=(args.n,)), dtype=dtype).to(dev)
    return X, b, dtype


def windows_of(d):
    return [[i, i + 1] for i in range(0, d, 2)]


def use_stream(args, dev):
    return args.engine == "stream" or (args.engine == "auto" and dev.type == "cuda")


def build_operator(args, X, params, windows, log=print):
    """(mv, info): the operator's matvec v -> K v and what it holds.  The
    JAX script's recipe: on the stream engine the radius near-field
    stencils (the KNN near-field where a grid degenerates), psd_clip=True
    and a solve-only plan; on the table engine KNN patterns."""
    import torch

    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import additive_kernel_matrix

    info = {}
    if args.operator == "dense":
        K = additive_kernel_matrix(args.kernel, params, X, windows)
        info["dense_bytes"] = K.numel() * K.element_size()
        return (lambda v: K @ v), info
    tdt = torch.bfloat16 if args.table_dtype == "bfloat16" else None
    geom = fs.additive_fastsum_geometry(X, windows, N=args.N, table_dtype=tdt)
    stream = use_stream(args, X.device)
    info["engine"] = "stream" if stream else "table"
    nf_stens, nf_lfil_build = None, args.nf_lfil
    if stream and fs._resolve_nf_lfil(args.kernel, args.nf_lfil, X.shape[0], 2) > 0:
        nf_stens = fs.additive_nearfield_stencil_direct(geom, args.kernel, args.nf_lfil)
        if nf_stens is None:
            log("nf stencil degenerate; ELL near-field")
        else:
            nf_lfil_build = 0
    plan = fs.additive_fastsum_coeffs(args.kernel, params, geom, psd_clip=True, nearfield_lfil=nf_lfil_build)
    if not stream:
        return (lambda v: fs.additive_fastsum_matvec(plan, v, compensated=args.comp_op)), info
    pn = fs.packed_ndft_plan(plan, table_dtype=tdt, nf_stencils=nf_stens, nf_require_grad=False)
    del plan, geom  # the packed plan holds its own table; the per-window tables are dead weight
    info["P"] = pn.P
    info["table_bytes"] = 0 if pn.Tp is None else pn.Tp.numel() * pn.Tp.element_size()
    info["nf_bytes"] = sum(t.numel() * t.element_size() for e in pn.nf for t in e if t is not None)
    info["nf"] = "radius" if nf_stens is not None else ("knn" if pn.nf else "none")
    return (lambda v: fs.packed_ndft_matvec(pn, v)), info


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def record(res, t_solve, setup_s, solver):
    """The JAX script's per-run record."""
    hist = res.res_history.detach().cpu().double().numpy()
    its = int(res.niter)
    t_it = t_solve / max(its, 1)
    crossings = {}
    for dec in DECADES:
        hit = np.where(hist[: its + 1] <= dec)[0]
        if hit.size:
            crossings[f"{dec:.0e}"] = {"iters": int(hit[0]), "time_s": round(float(hit[0]) * t_it, 3)}
    return {"solver": solver, "iters": its, "relres": float(res.relres), "solve_s": round(t_solve, 3),
            "s_per_iter": round(t_it, 5), "setup_s": round(setup_s, 2), "converged": bool(res.converged),
            "time_to_tol": crossings,
            "history_decimated": [float(h) for h in hist[: its + 1: max(1, its // 50)]]}


def preconditioners(args, X, params, windows, precs):
    """{name: (setup seconds, preconditioner or None, plan or None)} in the
    order of precs: none, Nystrom (rank landmarks of a permutation from a
    torch generator seeded 7: not the JAX script's PRNGKey(7) landmarks, so
    its Nystrom iteration counts are not comparable with the JAX
    artifacts'), AFN (rank landmarks by FPS, force_afn, pattern of lfil;
    the plan is deterministic and equals the JAX package's)."""
    import torch

    from nfft4gp_torch.preconds.afn import afn_plan, afn_setup_from_plan
    from nfft4gp_torch.preconds.nystrom import nystrom_setup
    from nfft4gp_torch.utils.datasets import rand_perm

    dev = X.device
    for name in precs:
        _sync(dev)
        t0 = time.perf_counter()
        plan = None
        if name == "none":
            pre = None
        elif name == "nystrom":
            perm = rand_perm(torch.Generator(device=dev).manual_seed(7), X.shape[0], args.rank)
            pre = nystrom_setup(args.kernel, params, X, perm, args.rank, windows=windows)
        elif name == "afn":
            plan = afn_plan(args.kernel, params, X, maxrank=args.rank, lfil=args.lfil, rank=args.rank,
                            force_afn=True)
            pre = afn_setup_from_plan(args.kernel, params, X, plan, windows=windows)
        else:
            raise SystemExit(f"unknown preconditioner {name!r}")
        _sync(dev)
        yield name, time.perf_counter() - t0, pre, plan


def solve(args, mv, b, pre, solver):
    """One solve of K x = b as the JAX script runs it: PCG unpreconditioned
    without replacement, preconditioned with --replace-every; FGMRES with
    --comp.  With --mixed the operator and preconditioner run in float32 on
    float64 Krylov vectors."""
    import torch

    from nfft4gp_torch.solvers.fgmres import fgmres
    from nfft4gp_torch.solvers.pcg import pcg

    if args.mixed:
        op_dtype = torch.float32
        b = b.to(torch.float64)
        matvec = lambda v: mv(v.to(op_dtype)).to(torch.float64)  # noqa: E731
        psolve = None if pre is None else (lambda r: pre.solve(r.to(op_dtype)).to(torch.float64))
    else:
        matvec = mv
        psolve = None if pre is None else pre.solve
    if solver == "pcg":
        return pcg(matvec, b, precond=psolve, tol=args.tol, maxits=args.maxits,
                   replace_every=0 if pre is None else args.replace_every)
    return fgmres(matvec, b, precond=psolve, kdim=args.fgmres_kdim, maxits=args.maxits, tol=args.tol,
                  compensated=args.comp)


def run(args, log=print):
    """The whole benchmark: returns the JAX script's JSON record, with the
    port's device in `platform` and `device`, the operator's bytes in
    `operator_info`."""
    import torch

    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    dev = device_of(args)
    X, b, dtype = make_problem(args, dev)
    params = KernelParams.make(1.0, args.l, args.mu, dtype=dtype, device=dev)
    windows = make_windows(windows_of(args.d))
    out = {"n": args.n, "d": args.d, "kernel": args.kernel, "operator": args.operator, "rank": args.rank,
           "lfil": args.lfil, "l": args.l, "mu": args.mu, "tol": args.tol, "maxits": args.maxits, "N": args.N,
           "engine": args.engine, "nf_lfil": args.nf_lfil, "compensated": args.comp,
           "replace_every": args.replace_every, "mixed": args.mixed, "dtype": str(dtype).replace("torch.", ""),
           "platform": dev.type, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "runs": {}}
    log(f"n={args.n} d={args.d} kernel={args.kernel} op={args.operator} rank={args.rank} lfil={args.lfil} "
        f"l={args.l} mu={args.mu} dtype={out['dtype']} device={out['device']}")
    _sync(dev)
    t0 = time.perf_counter()
    mv, info = build_operator(args, X, params, windows, log)
    mv(b)
    _sync(dev)
    out["operator_build_s"] = round(time.perf_counter() - t0, 2)
    out["operator_info"] = info
    log(f"operator build {out['operator_build_s']:.1f}s {info}")
    for name, setup_s, pre, _plan in preconditioners(args, X, params, windows, args.precs.split(",")):
        for solver in ("pcg", "fgmres"):
            if solver not in args.solvers:
                continue
            solve(args, mv, b, pre, solver)
            _sync(dev)
            t0 = time.perf_counter()
            res = solve(args, mv, b, pre, solver)
            _sync(dev)
            rec = record(res, time.perf_counter() - t0, setup_s, solver)
            out["runs"][f"{name}:{solver}"] = rec
            cross = " ".join(f"{k}@{v['iters']}it/{v['time_s']}s" for k, v in rec["time_to_tol"].items())
            log(f"{name:8s} {solver:6s} | iters {rec['iters']:4d} | relres {rec['relres']:.2e} | solve "
                f"{rec['solve_s']:.2f}s | setup {setup_s:.1f}s | {cross}")
    return out


def main(argv=None):
    args = parse_args(argv)
    out = run(args, log=lambda s: print(s, flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}", flush=True)


if __name__ == "__main__":
    main()
