"""Time one apply of prediction's additive operator on each of its engines,
at the shapes of the benchmark cell gauss-add-1e6.predict, on one NVIDIA GPU.

    python3 scripts/torch_predict_apply_ab.py [--n 1000000] [--n-test 100000] [--part apply|solve|all]

The operator is the one `models/gp.py gp_predict_fastsum` applies 211
times a request: gaussian, five 2-D windows, N = 32, all N modes kept
(2P = 34), (f, l, mu) = softplus(0), on the train plan (n points, the
FGMRES matvec) and on the joint plan (n + n_test points, the mean).  Per
plan and engine, one vector each:

- `table`: the table engine, `additive_fastsum_matvec` (torch products on
  the float32 phase tables Tcs);
- `regen`: the phase-regenerating kernels (csrc/packed_ndft_regen.cu),
  `additive_fastsum_matvec_fused` on its `fused_plan`, built once;
- `wide34`: the float32-table wide pair (csrc/packed_ndft_wide.cu) on an
  untrimmed table of 2P = 34 (`pack_phase_table(xT, 17)`), through the same
  combine and near-field as `regen`;

and the two kernels of `regen` and `wide34` alone (adjoint nv = 1, forward
nsets = 1).  Each line: `card_ms` and `host_ms` of one call
(scripts/torch_card.py `time_calls`: the card's time of calls queued
behind a sleep kernel, and the host clock over calls ending in a
synchronize; where the host issues an apply slower than the card runs
it, card_ms shows the host's pace), `rel_err` against the table engine in
float64 on the card, the kernels' launches an apply.  Then one profile of
5 applies per engine: device ms an apply by kernel name (the card's own
time).

The solve part runs whole requests of the cell (its configuration and
inputs from each `--seed`, at `--n` points), `--requests` an engine, on
the table engine (`fastsum_engine="table"`) and on the cell's own route,
traced (utils/timers.py): per request the fgmres span's iterations, its
cycles' lengths, the cycles a lucky breakdown ended with their
t / (eps ||b||), those the Givens estimate ended by meeting tol, the
true relres each restart starts from and the last, `host_syncs`, the
NDFT launches, and the mean's gap to the table engine's.  Prints JSON lines; the last one
holds them all (also written to chiprun_out/predict_apply_ab.json).

`--platform cpu --n 3000 --n-test 300` rehearses the script on the CPU
(the plain versions, host-clock times that say nothing of the card).
"""

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from nfft4gp_torch.ops import fastsum as fs  # noqa: E402
from nfft4gp_torch.ops import packed_ndft as pk  # noqa: E402
from nfft4gp_torch.ops.kernels import KernelParams, make_windows  # noqa: E402
from torch_card import card_label, device_of, sync, time_calls  # noqa: E402

DIM = 10
WINDOWS = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
N_MODES = 32
P = N_MODES // 2 + 1
REPS = 20


def _data(n, n_test, dev):
    """Uniform points in [0, 1]^10, the train rows sorted by feature 0 (as
    the cell's), and the test points."""
    g = torch.Generator(device=dev).manual_seed(0)
    X = torch.rand((n, DIM), generator=g, device=dev)
    X = X[torch.argsort(X[:, 0])]
    return X, torch.cat([X, torch.rand((n_test, DIM), generator=g, device=dev)])


def _plan(Z):
    p = KernelParams.make(*[float(torch.nn.functional.softplus(torch.tensor(0.0)))] * 3, dtype=Z.dtype,
                          device=Z.device)
    return fs.additive_fastsum_coeffs("gaussian", p, fs.additive_fastsum_geometry(Z, make_windows(WINDOWS),
                                                                                  N=N_MODES))


def _engines(plan):
    """{engine: apply(v)} and {kernel: call()} of one plan."""
    fp = fs.fused_plan(plan)
    lay = fp.lay
    Tp = pk.pack_phase_table(lay.xT, P)
    p, kw = plan.params, dict(pairs=lay.pairs, singles=lay.singles)

    def wide34(v):
        (acc,) = fs._layout_sums(lay, v[None], ["w"], lambda V: fs._two_pass(
            lay, V, ["w"], lambda A: pk.packed_adjoint(Tp, A, **kw),
            lambda G2, G1: pk.packed_forward(Tp, G2, G1, **kw)))
        return (p.f * p.f * (acc / plan.n_windows + p.mu * v[None]))[0]

    engines = {"table": lambda v: fs.additive_fastsum_matvec(plan, v),
               "regen": lambda v: fs.additive_fastsum_matvec_fused(fp, v),
               "wide34": wide34}
    n = lay.xT.shape[1]
    a = torch.randn((1, n), device=lay.xT.device)
    G2 = [torch.randn((1, 2 * P, 2 * P), device=a.device) for _ in lay.pairs]
    kernels = {"regen_adjoint": lambda: pk.packed_adjoint_regen(lay.xT, a, P=P, **kw),
               "regen_forward": lambda: pk.packed_forward_regen(lay.xT, G2, P=P, **kw),
               "wide34_adjoint": lambda: pk.packed_adjoint(Tp, a, **kw),
               "wide34_forward": lambda: pk.packed_forward(Tp, G2, **kw)}
    return engines, kernels


def _launches(fn):
    pk.reset_launch_counts()
    fn()
    return {f.__name__: f.launches for f in pk.KERNEL_WRAPPERS if f.launches}


def _profile(fn, dev, reps=5):
    """Device ms an apply by kernel name (the 12 longest)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync(dev)
    rows = sorted(((e.key, e.device_time_total / 1e3 / reps) for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    return {"device_ms": sum(ms for _, ms in rows), "by_kernel": [[k[:90], round(ms, 4)] for k, ms in rows[:12]]}


def _apply_rows(args, dev, out):
    X, X_all = _data(args.n, args.n_test, dev)
    for name, Z in (("train", X), ("joint", X_all)):
        plan = _plan(Z)
        engines, kernels = _engines(plan)
        v = torch.randn(Z.shape[0], generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        exact = fs.additive_fastsum_matvec(_plan(Z.double()), v.double())
        for eng, fn in engines.items():
            y = fn(v)
            row = {"plan": name, "n": Z.shape[0], "engine": eng, **time_calls(lambda: fn(v), REPS, dev),
                   "rel_err": float(torch.linalg.norm(y.double() - exact) / torch.linalg.norm(exact)),
                   "launches": _launches(lambda: fn(v))}
            if dev.type == "cuda":
                row["profile"] = _profile(lambda: fn(v), dev)
            print(json.dumps(row), flush=True)
            out["rows"].append(row)
        for k, fn in kernels.items():
            row = {"plan": name, "n": Z.shape[0], "kernel": k, **time_calls(fn, REPS, dev)}
            print(json.dumps(row), flush=True)
            out["rows"].append(row)
        del plan, engines, kernels, exact


def _solve_rows(args, dev, out):
    from benchmark import generator
    from benchmark.harness import load_cell, predict_maxits
    from nfft4gp_torch.models import gp
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.utils import timers

    cell = load_cell("gauss-add-1e6.predict")
    cfg = dict(cell.config, n=args.n)
    maxits = predict_maxits(cell)
    solves = []

    def recorded(*a, **k):   # the request's FgmresResult, for its residual history
        solves.append(gp_fgmres(*a, **k))
        return solves[-1]

    gp_fgmres, gp.fgmres = gp.fgmres, recorded
    try:
        for seed in args.seed:
            inp = generator.make_inputs(cfg, seed, dev)
            means = {}
            for engine in ("table", cfg["problem"]["fastsum_engine"]):
                prob = GPProblem(**dict(cfg["problem"], fastsum_engine=engine))
                prob.raw_params_ = torch.tensor(cfg["raw_params0"], dtype=inp.X.dtype, device=dev)
                for i in range(args.requests):
                    Xt = generator.test_points(cfg, cell.traffic, seed, i, dev)
                    pk.reset_launch_counts()
                    with timers.tracing() as tr:
                        mean = prob.predict(inp.X, inp.y, Xt, landmarks=inp.landmarks, maxits=maxits)
                    out["rows"].append(_solve_row(engine, seed, i, tr, solves[-1], mean, means, maxits, args.n))
                    print(json.dumps(out["rows"][-1]), flush=True)
                del prob
    finally:
        gp.fgmres = gp_fgmres


def _solve_row(engine, seed, i, tr, sol, mean, means, maxits, n):
    (f,) = [s for s in tr.spans if s.name == "fgmres"]
    its, lucky = f.attrs["cycle_its"], f.attrs["lucky_t"]
    starts = [sum(its[:c]) for c in range(1, len(its))]
    ref = means.setdefault(i, mean.double())
    return {"part": "solve", "engine": engine, "seed": seed, "n": n, "request": i,
            "iters": f.attrs["iters"], "cycles": len(its), "cycle_its": its,
            "lucky": len(lucky), "lucky_t_over_eps_normb": lucky,
            # kdim = maxits, so every cycle but the last ends early: by a lucky
            # breakdown or by the Givens estimate meeting tol
            "estimate_met_tol": len(its) - 1 - len(lucky) + (f.attrs["iters"] < maxits),
            # the true residual / ||b|| each restart starts from (the history's
            # entry at a cycle's start), then the solve's last
            "restart_relres": [float(sol.res_history[s]) for s in starts], "relres": f.attrs["relres"],
            "host_syncs": tr.counters["host_syncs"],
            "launches": {g.__name__: g.launches for g in pk.KERNEL_WRAPPERS if g.launches},
            "mean_gap_to_table": float(torch.linalg.norm(mean.double() - ref) / torch.linalg.norm(ref))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--n-test", type=int, default=100_000)
    ap.add_argument("--part", choices=["apply", "solve", "all"], default="all")
    ap.add_argument("--seed", type=int, nargs="+", default=[2_100_022_001])
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    dev = device_of(args.platform, "torch_predict_apply_ab.py")
    out = {"card": card_label(dev), "n": args.n, "n_test": args.n_test, "rows": []}
    print(json.dumps({"card": out["card"]}), flush=True)
    if args.part in ("apply", "all"):
        _apply_rows(args, dev, out)
    if args.part in ("solve", "all"):
        _solve_rows(args, dev, out)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "predict_apply_ab.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
