"""Which branch the port's unforced AFN plan takes; the port of
scripts/rank_dispatch_probe.py.

Runs preconds/afn.afn_plan with rank=None (the scaled Nystrom-error rank
estimate, then the eigen-curve and fill-distance refinement, then the
RAN-or-AFN branch; ref afn.c:294-304, afn_setup.m:58-83) on one smooth and
one rough problem, n = 2e4 points uniform in 2 features (default_rng(0)),
float64, maxrank 200, lfil 16: gaussian l = 0.5 (expected "ran") and
matern12 l = 0.05 (expected "afn"), mu = 0.01.  For each it records the
branch, the rank k, the plan's seconds, and PCG to 1e-6 (at most 400
iterations) on the dense K with the resulting preconditioner and without
one: the evidence that the dispatch picks the right factorization per
regime.

The JAX script draws the rank estimate's subsamples from
jax.random.PRNGKey(0), the port from a torch generator, so k can differ
(JAX: 40 for gaussian).  --subsamples hands over a draw: a JSON file whose
"subsamples" list holds one index list per repeat of the estimate
(tests/goldens/rank_dispatch_subsamples_2e4.json: the JAX draw at n = 2e4,
which both cases take, as both JAX calls take PRNGKey(0)).

It writes --out (default RANK_DISPATCH_TORCH.json); RANK_DISPATCH.json is
the JAX script's record.  On the card the dense K is n^2 float64 (3.2 GB at
2e4).  Every time is printed beside the card's name and power limit.

  python scripts/torch_rank_dispatch_probe.py \\
      --subsamples tests/goldens/rank_dispatch_subsamples_2e4.json   # the card
  python scripts/torch_rank_dispatch_probe.py --platform cpu --n 2000 --out /tmp/r.json
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label, device_of, sync  # noqa: E402

MAXRANK = 200
LFIL = 16
PCG_TOL = 1e-6
PCG_MAXITS = 400
CASES = (("gaussian", 0.5, "ran"), ("matern12", 0.05, "afn"))


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--subsamples", default=None,
                    help="a JSON file whose 'subsamples' list holds the rank estimate's subsample indices (default: "
                    "a torch generator seeded 0)")
    ap.add_argument("--out", "--json", dest="out", default="RANK_DISPATCH_TORCH.json")
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    return ap


def subsamples_of(args):
    """The --subsamples draw (checked against n), or None."""
    if args.subsamples is None:
        return None
    with open(args.subsamples) as f:
        doc = json.load(f)
    subs = [np.asarray(s, dtype=np.int64) for s in doc["subsamples"]]
    if doc["n"] != args.n or any(s.min() < 0 or s.max() >= args.n for s in subs):
        raise ValueError(f"{args.subsamples}: a draw for n = {doc['n']}, not {args.n}")
    return subs


def make_problem(n, device):
    import torch

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(size=(n, 2))).to(device)
    b = torch.from_numpy(rng.normal(size=(n,))).to(device)
    return X, b


def run_case(kind, l, X, b, subsamples=None):  # noqa: E741
    """One case's record: the JAX script's keys but "expected"."""
    import torch

    from nfft4gp_torch.ops.kernels import KernelParams, kernel_matrix
    from nfft4gp_torch.preconds.afn import afn_plan, afn_setup_from_plan
    from nfft4gp_torch.solvers.pcg import pcg

    params = KernelParams.make(1.0, l, 0.01, dtype=X.dtype, device=X.device)
    t0 = time.perf_counter()
    plan = afn_plan(kind, params, X, maxrank=MAXRANK, lfil=LFIL, subsamples=subsamples,
                    generator=torch.Generator().manual_seed(0))
    sync(X.device)
    t_plan = time.perf_counter() - t0
    pre = afn_setup_from_plan(kind, params, X, plan)
    K = kernel_matrix(kind, params, X)
    mv = lambda v: K @ v  # noqa: E731
    res = pcg(mv, b, precond=pre.solve, tol=PCG_TOL, maxits=PCG_MAXITS)
    res0 = pcg(mv, b, tol=PCG_TOL, maxits=PCG_MAXITS)
    return {"l": l, "branch": "ran" if plan.use_ran else "afn", "k": int(plan.k), "plan_s": t_plan,
            "pcg_iters": int(res.niter), "pcg_relres": float(res.relres),
            "pcg_iters_noprecond": int(res0.niter), "relres_noprecond": float(res0.relres)}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    device = device_of(args.platform, "torch_rank_dispatch_probe")
    label = card_label(device)
    subs = subsamples_of(args)
    X, b = make_problem(args.n, device)
    out = {"n": args.n, "maxrank": MAXRANK, "lfil": LFIL, "device": label,
           "subsamples": (os.path.relpath(os.path.abspath(args.subsamples), REPO) if args.subsamples
                          else "a torch generator seeded 0"), "cases": {}}
    for kind, l, expect in CASES:  # noqa: E741
        rec = {"expected": expect, **run_case(kind, l, X, b, subs)}
        out["cases"][f"{kind}_l{l}"] = rec
        print(f"{kind} l={l}: branch={rec['branch']} (expected {expect}) k={rec['k']} plan {rec['plan_s']:.2f} s "
              f"pcg {rec['pcg_iters']} its relres {rec['pcg_relres']:.2e} (none: {rec['pcg_iters_noprecond']} its "
              f"{rec['relres_noprecond']:.2e}) | {label}", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main()
