"""GP loss-step benchmark of the port: the stream engine against the table
path; the port of scripts/loss_bench.py.

The training loss (models/gp.gp_loss) is matvec-dominated: FGMRES runs
2 maxits single-vector matvecs and SLQ nvecs x maxits probe matvecs plus
nvecs gradient matvecs.  GPProblem(fastsum_engine="stream") streams every
probe of a Lanczos step through one pass of the packed table kernels
(ops/fastsum.packed_ndft_matvec_batch; on the card csrc/packed_ndft_tc.cu
on bf16 tables); "table" is the folded-NDFT products in torch.

The JAX script's problem: n = 1e5 points uniform in d = 10 features, y =
sin(3 x0) + 0.1 noise (default_rng(0)), five 2-D windows [i, i + 1],
gaussian, precond none, rank 64, maxits 10, nvecs 10, fastsum_N 32, seed 0,
raw parameters softplus^-1 (1, 0.5, 0.05); --operator dense runs the dense
operator (the small-n regime) and ignores the engines.

The JAX script chains --reps losses in one jitted fori_loop; the port calls
make_loss's closure eagerly: after the first loss (the row's "loss") and
one untimed call, --reps calls between two synchronizations (host wall ms
a step, "ms_per_loss_step"), then --reps more queued behind a sleep
kernel between two CUDA events ("card_ms_per_loss_step": the loss reads
values on the host, so this is the card's elapsed time with the host's
waits in it).  Each row is one JSON line with the card's
name and power limit.  The last line gives the table / stream speedup
and the loss difference between the engines; that difference is printed,
not held to a limit: at mu = 0.05 the float32 loss moves by about 1e-4
under any rounding-level change (PERF.md), and the engines differ by the
trimmed Nyquist mode and the bf16 tables.  It must be finite.

  python scripts/torch_loss_bench.py                        # the card
  python scripts/torch_loss_bench.py --platform cpu --n 2000 --reps 2
"""

import argparse
import json
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label, device_of, time_calls  # noqa: E402


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--nvecs", type=int, default=10)
    ap.add_argument("--maxits", type=int, default=10)
    ap.add_argument("--engines", nargs="*", default=["table", "stream"])
    ap.add_argument("--operator", default="fastsum", choices=["fastsum", "dense"],
                    help="dense: the small-n regime (multiclass/TEST2 scale); engines are ignored")
    ap.add_argument("--precond", default="none")
    ap.add_argument("--json", default=None)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    return ap


def make_problem(args, device, dtype=None):
    """X (n, d), y and the raw parameters of the JAX script."""
    import torch

    from nfft4gp_torch.models.transforms import transform_inverse

    dtype = dtype or torch.float32
    rng = np.random.default_rng(0)
    Xh = rng.uniform(size=(args.n, args.d)).astype(np.float32)
    yh = (np.sin(3 * Xh[:, 0]) + 0.1 * rng.normal(size=args.n)).astype(np.float32)
    X = torch.from_numpy(Xh).to(device, dtype)
    y = torch.from_numpy(yh).to(device, dtype)
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.05], dtype=dtype, device=device))
    return X, y, raw


def problem(args, engine):
    """The JAX script's GPProblem for one engine ("dense": the dense operator)."""
    from nfft4gp_torch.models.problem import GPProblem

    return GPProblem(kernel="gaussian", windows=[[i, i + 1] for i in range(0, args.d, 2)],
                     operator=args.operator, precond=args.precond, rank=64, maxits=args.maxits,
                     nvecs=args.nvecs, fastsum_N=32, fastsum_engine=engine if engine != "dense" else "table",
                     seed=0)


def engine_row(args, engine, X, y, raw, probes=None, landmarks=None):
    """One engine's row: the first loss, then --reps timed steps (time_calls)."""
    loss_fn = problem(args, engine).make_loss(X, y, probes=probes, landmarks=landmarks)
    loss0 = float(loss_fn(raw)[0])
    t = time_calls(lambda: loss_fn(raw), args.reps, X.device)
    return dict(engine=engine, n=args.n, d=args.d, nvecs=args.nvecs, maxits=args.maxits,
                ms_per_loss_step=t["host_ms"], card_ms_per_loss_step=t["card_ms"], loss=loss0)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    device = device_of(args.platform, "torch_loss_bench")
    label = card_label(device)
    X, y, raw = make_problem(args, device)
    rows = []
    engines = args.engines if args.operator == "fastsum" else ["dense"]
    for engine in engines:
        rows.append(dict(engine_row(args, engine, X, y, raw), device=label))
        print(json.dumps(rows[-1]), flush=True)
    out = dict(config=vars(args), results=rows)
    if len(rows) == 2:
        delta = abs(rows[0]["loss"] - rows[1]["loss"])
        out["speedup"] = rows[0]["ms_per_loss_step"] / rows[1]["ms_per_loss_step"]
        out["loss_delta"] = delta
        print(f"speedup {out['speedup']:.2f}x (loss delta {delta:.2e}) | {label}", flush=True)
        if not math.isfinite(delta):
            raise AssertionError(f"the engines' losses are not finite: {rows}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
