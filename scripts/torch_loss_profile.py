"""Component profile of the port's GP loss step; the port of
scripts/loss_profile.py.

Times each piece of models/gp.gp_loss on the JAX script's problem: n = 1e5
points uniform in d = 10 features, five 2-D windows [i, i + 1], gaussian
(f, l, mu) = (1, 0.5, 0.1), bf16 phase tables, maxits 10, nvecs 10 probes,
Nystrom rank 50.  The rows, the JAX script's:

  coeffs+plan build          additive_fastsum_coeffs + packed_ndft_plan
  matvec single              the plan build and one matvec
  matvec batch x{nvecs}      the plan build and one matvec of nvecs rows
  fgmres 2*maxits            the plan build and FGMRES (kdim 2 maxits, tol 1e-6)
  slq (no precond)           the plan build and slq_logdet over the probes
  nystrom setup (grad)       nystrom_setup(require_grad=True) on rank landmarks
  batched eigh (nvecs,m,m)   torch.linalg.eigh of nvecs symmetric m x m
  gp_loss precond=none       gp_loss, no preconditioner
  gp_loss precond=nystrom    gp_loss with the Nystrom set-up per call

Every row but the build alone and the eigh builds the per-parameter operator
inside the timed call, as the JAX script's jitted rows do.  The operator is
GPProblem's stream engine: models/problem.py's _ops on
packed_ndft_matvec_batch / packed_ndft_grad_matvec_batch of
fs.packed_ndft_plan(plan, table_dtype=bfloat16) (csrc/packed_ndft_tc.cu on
the card).  One vector and a batch of rows both take the batch functions;
the port has no vmap.

The port runs eagerly: each row is one untimed call, then --reps calls
between two synchronizations (host wall ms; the JSON's "rows", the JAX
script's key) and --reps more queued behind a sleep kernel between CUDA
events (the card's ms, "card_ms"; FGMRES and SLQ read values on the host,
so their card time carries the host's).  The step is host-bound, so both
are printed, each beside the card's name and power limit.

  python scripts/torch_loss_profile.py                         # the card
  python scripts/torch_loss_profile.py --n 1000000 --reps 5
  python scripts/torch_loss_profile.py --platform cpu --n 2000 --reps 2
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label, device_of, ms_text, time_calls  # noqa: E402

FGMRES_TOL = 1e-6
RAW = (0.5, -0.5, -2.0)


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--nvecs", type=int, default=10)
    ap.add_argument("--maxits", type=int, default=10)
    ap.add_argument("--rank", type=int, default=50)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", default=None)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    return ap


def make_problem(args, device, dtype=None):
    """The JAX script's data: X (n, d) and y (n,) from default_rng(0), the
    Rademacher probes and the Nystrom landmarks from torch generators seeded
    1 and 0 (the JAX script: PRNGKeys 1 and 0), the eigh's (nvecs, maxits,
    maxits) symmetric matrices from the same numpy generator."""
    import torch

    from nfft4gp_torch.solvers.lanczos import rademacher_probes
    from nfft4gp_torch.utils.datasets import rand_perm

    dtype = dtype or torch.float32
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(size=(args.n, args.d))).to(device, dtype)
    y = torch.from_numpy(rng.normal(size=(args.n,))).to(device, dtype)
    probes = rademacher_probes(torch.Generator().manual_seed(1), args.nvecs, args.n, dtype=dtype).to(device)
    perm = rand_perm(torch.Generator().manual_seed(0), args.n, args.rank).to(device)
    T = torch.from_numpy(rng.normal(size=(args.nvecs, args.maxits, args.maxits))).to(device, dtype)
    return X, y, probes, perm, T + T.transpose(1, 2)


def windows_of(d):
    from nfft4gp_torch.ops.kernels import make_windows

    return make_windows([[i, i + 1] for i in range(0, d, 2)])


def stream_build(geom, table_dtype):
    """params -> (matvec, dmatvec) on the packed tables of `geom`."""
    from nfft4gp_torch.models.problem import _ops
    from nfft4gp_torch.ops import fastsum as fs

    def build(params):
        pn = fs.packed_ndft_plan(fs.additive_fastsum_coeffs("gaussian", params, geom), table_dtype=table_dtype)
        return _ops(lambda V: fs.packed_ndft_matvec_batch(pn, V), lambda V: fs.packed_ndft_grad_matvec_batch(pn, V))

    return build


def row_fns(args, geom, build, X, y, probes, perm, T, table_dtype):
    """{row name: a call of no arguments}, each returning its result (the
    tests read the FGMRES solution and the SLQ estimate).  build: params ->
    (matvec, dmatvec), as stream_build."""
    import torch

    from nfft4gp_torch.models.gp import GPConfig, gp_loss
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams
    from nfft4gp_torch.preconds.nystrom import nystrom_setup
    from nfft4gp_torch.solvers.fgmres import fgmres
    from nfft4gp_torch.solvers.lanczos import slq_logdet

    windows = windows_of(args.d)
    params = KernelParams.make(1.0, 0.5, 0.1, dtype=X.dtype, device=X.device)
    raw = torch.tensor(RAW, dtype=X.dtype, device=X.device)
    cfg = GPConfig(kind="gaussian", maxits=args.maxits, nvecs=args.nvecs, tol=FGMRES_TOL)
    its = 2 * args.maxits

    def nys(p):
        return nystrom_setup("gaussian", p, X, perm, args.rank, require_grad=True, windows=windows)

    return {
        "coeffs+plan build": lambda: fs.packed_ndft_plan(
            fs.additive_fastsum_coeffs("gaussian", params, geom), table_dtype=table_dtype).w2[0],
        "matvec single": lambda: build(params)[0](y),
        f"matvec batch x{args.nvecs}": lambda: build(params)[0](probes),
        "fgmres 2*maxits": lambda: fgmres(build(params)[0], y, kdim=its, maxits=its, tol=FGMRES_TOL).x,
        "slq (no precond)": lambda: slq_logdet(*build(params), probes, maxits=args.maxits),
        "nystrom setup (grad)": lambda: nys(params).U,
        "batched eigh (nvecs,m,m)": lambda: torch.linalg.eigh(T)[0],
        "gp_loss precond=none": lambda: gp_loss(raw, y, build, probes, cfg, None).loss,
        "gp_loss precond=nystrom": lambda: gp_loss(raw, y, build, probes, cfg, nys).loss,
    }


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    from nfft4gp_torch.ops import fastsum as fs

    device = device_of(args.platform, "torch_loss_profile")
    label = card_label(device)
    print(f"[device] {label}", flush=True)
    X, y, probes, perm, T = make_problem(args, device)
    tdt = torch.bfloat16
    geom = fs.additive_fastsum_geometry(X, windows_of(args.d), table_dtype=tdt)
    fns = row_fns(args, geom, stream_build(geom, tdt), X, y, probes, perm, T, tdt)
    out = {"n": args.n, "d": args.d, "nvecs": args.nvecs, "maxits": args.maxits, "rank": args.rank,
           "reps": args.reps, "device": label, "rows": {}, "card_ms": {}}
    for name, fn in fns.items():
        t = time_calls(fn, args.reps, device)
        out["rows"][name], out["card_ms"][name] = t["host_ms"], t["card_ms"]
        print(f"{name:28s} {ms_text(t)} | {label}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
