"""Time of the port's AFN preconditioner apply and of its parts; the port of
scripts/afn_solve_profile.py.

The JAX script's problem: n = 1e5 points uniform in d = 10 features
(default_rng(0)), five 2-D windows [i, i + 1], gaussian (f, l, mu) =
(1, 0.5, 0.01), rank 200 FPS landmarks (ops/fps.fps, expand_perm) and the
lower-triangular KNN pattern of lfil 16 on the remaining points in that
order (ops/knn.knn_pattern), no cell sort: an AFN plan made with
preconds/afn.plan_from_arrays and factored by afn_setup_from_plan.  The
rows, each the time of one call on the residual r (default_rng(0) normals):

  afn.solve            AfnPrecond.solve(r)
  perm gather x[perm]  r[perm]
  unperm scatter       the un-permute of the solve; the port's solve runs it
                       as a gather y[inv_perm] (the JAX script times the
                       scatter zeros.at[perm].set(y), whose result is equal)
  chol_solve k         one triangular solve with L11 on r[:k], as the JAX
                       row (the solve's chol_solve runs two, twice)
  K12' gemv            K12 r[k:] (k x n2), as the JAX row
  fsai ell fwd         G r[k:]: the padded-ELL gather product (ell_apply)
  fsai ell transpose   G' r[k:] as the port's solve runs it: ell_rmatvec_t
                       on the transposed pattern, gathers only
                       (preconds/fsai.py; the JAX row times the
                       scatter-add ell_rmatvec)
  afn.dvp x10          the port's addition: AfnPrecond.dvp over 10
                       Rademacher probes (a torch generator seeded 1), the
                       gradient trace estimate's apply and AFN's largest
                       cost measured on the card (its triangular ELL
                       sweeps, ops/matops._tri_sweep); it takes at most
                       DVP_ITERS calls a batch

The set-up takes require_grad=True (the JAX script's takes False): the
dvp needs dL11, dK12 and dG; the solve and its parts read none of them.
Each row: one untimed call, then --iters calls between two
synchronizations (host wall ms) and --iters more queued behind a sleep
kernel between CUDA events (the card's ms), printed beside the card's name
and power limit.  The JAX script chains its calls in a fori_loop; the port
calls eagerly.

  python scripts/torch_afn_solve_profile.py                       # the card
  python scripts/torch_afn_solve_profile.py --platform cpu --n 4000 --iters 3
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label, device_of, ms_text, sync, time_calls  # noqa: E402

NVECS = 10
DVP_ITERS = 5


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--rank", type=int, default=200)
    ap.add_argument("--lfil", type=int, default=16)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--json", default=None)
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    return ap


def make_plan(args, device, dtype=None):
    """(X, r, params, windows, plan): the JAX script's data and AFN plan."""
    import torch

    from nfft4gp_torch.ops.fps import fps
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.ops.knn import knn_pattern
    from nfft4gp_torch.preconds.afn import plan_from_arrays
    from nfft4gp_torch.utils.datasets import expand_perm

    dtype = dtype or torch.float32
    n, k = args.n, args.rank
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(size=(n, args.d))).to(device, dtype)
    r = torch.from_numpy(rng.normal(size=(n,))).to(device, dtype)
    params = KernelParams.make(1.0, 0.5, 0.01, dtype=dtype, device=device)
    windows = make_windows([[i, i + 1] for i in range(0, args.d, 2)])
    perm = expand_perm(fps(X, k).perm, n)
    idx, mask = knn_pattern(X[perm[k:]], args.lfil)
    plan = plan_from_arrays(perm.cpu().numpy(), k, False, (idx.cpu().numpy(), mask.cpu().numpy()), device)
    return X, r, params, windows, plan


def part_fns(afn):
    """{row name: fn(v)} of the solve's parts (the dvp row apart)."""
    from nfft4gp_torch.ops.matops import tril_solve

    k = afn.k
    return {
        "afn.solve": afn.solve,
        "perm gather x[perm]": lambda v: v[afn.perm],
        "unperm scatter": lambda v: v[afn.inv_perm],
        "chol_solve k": lambda v: tril_solve(afn.L11, v[:k]),
        "K12' gemv": lambda v: afn.K12 @ v[k:],
        "fsai ell fwd": lambda v: afn.gs.apply_G(v[k:]),
        "fsai ell transpose": lambda v: afn.gs.apply_Gt(v[k:]),
    }


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    from nfft4gp_torch.preconds.afn import afn_setup_from_plan
    from nfft4gp_torch.solvers.lanczos import rademacher_probes

    device = device_of(args.platform, "torch_afn_solve_profile")
    label = card_label(device)
    print(f"[device] {label}", flush=True)
    t0 = time.perf_counter()
    X, r, params, windows, plan = make_plan(args, device)
    sync(device)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    afn = afn_setup_from_plan("gaussian", params, X, plan, require_grad=True, windows=windows)
    sync(device)
    setup_s = time.perf_counter() - t0
    print(f"[setup] plan (FPS {args.rank}, KNN lfil {args.lfil}) {plan_s:.3f} s, factorization (require_grad) "
          f"{setup_s:.3f} s, repaired rows {int(afn.breakdown)} | {label}", flush=True)
    Z = rademacher_probes(torch.Generator().manual_seed(1), NVECS, args.n, dtype=X.dtype).to(device)
    timed = [(name, lambda fn=fn: fn(r), args.iters) for name, fn in part_fns(afn).items()]
    timed.append((f"afn.dvp x{NVECS}", lambda: afn.dvp(Z), min(args.iters, DVP_ITERS)))
    out = {"n": args.n, "d": args.d, "rank": args.rank, "lfil": args.lfil, "iters": args.iters, "device": label,
           "plan_s": plan_s, "setup_s": setup_s, "rows": {}, "card_ms": {}, "calls": {}}
    for name, fn, reps in timed:
        t = time_calls(fn, reps, device)
        out["rows"][name], out["card_ms"][name], out["calls"][name] = t["host_ms"], t["card_ms"], reps
        print(f"{name:24s} {ms_text(t)} | {label}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
