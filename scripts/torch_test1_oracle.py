"""TEST1 oracle on the PyTorch port: fastsum vs exact-dense matvec error table
("Figure 2"); the port of scripts/test1_oracle.py.

Reproduces the reference's printed TEST1 accuracy oracle
(ref TESTS/TEST1/foo.cpp:240-295): build the additive exact and Fourier
operator stacks on the same data (np.random.default_rng(906), the same
windows), apply both to a random vector, and print L-inf/L2 absolute and
relative errors for K@x and the three gradient matvecs; for matern12 with
the default near-field, one more row for the uncorrected operator (nf=0).

It runs on the card by default and fails without one; --platform cpu runs
on the CPU:

  python scripts/torch_test1_oracle.py [--n 800] [--d 4] [--N 32] [--kernel gaussian]
  python scripts/torch_test1_oracle.py --kernel matern12 --platform cpu --x64
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 906
GRAD_NAMES = ("dK/df@x", "dK/dl@x", "dK/dmu@x")


def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--kernel", default="gaussian", choices=["gaussian", "matern32", "matern12"])
    ap.add_argument("--f", type=float, default=1.0)
    ap.add_argument("--l", type=float, default=0.25)
    ap.add_argument("--mu", type=float, default=0.05)
    ap.add_argument("--nearfield-lfil", type=int, default=None,
                    help="near-field correction size (default auto: on for matern12, matching the "
                    "reference's always-on fastsum regularization)")
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    ap.add_argument("--x64", action="store_true", help="float64 data and operators")
    return ap


def windows_of(d: int):
    """The oracle's windows: 1-D windows on the even features, 2-D windows on
    the odd pairs (the JAX script's)."""
    return [[i] for i in range(0, d, 2)] + [[i, i + 1] for i in range(1, d - 1, 2)]


def _errors(a, b):
    """(L-inf abs, L-inf rel, L2 abs, L2 rel) of a against b, in float64 on the host."""
    diff = (a - b).double().cpu().numpy()
    bb = b.double().cpu().numpy()
    linf, l2 = float(np.abs(diff).max()), float(np.linalg.norm(diff))
    return linf, linf / float(np.abs(bb).max()), l2, l2 / float(np.linalg.norm(bb))


def oracle_table(args, device):
    """The error table: a dict with the header's fields, `rows` (name,
    (L-inf abs, L-inf rel, L2 abs, L2 rel)) in the printed order and, for
    tests, the fast and exact results as float64 numpy arrays (`fast`,
    `exact`, keyed by row name)."""
    import torch

    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, additive_kernel_matrix_with_grad, make_windows

    dtype = torch.float64 if args.x64 else torch.float32
    rng = np.random.default_rng(SEED)
    X = torch.from_numpy(rng.uniform(size=(args.n, args.d))).to(device=device, dtype=dtype)
    x = torch.from_numpy(rng.normal(size=(args.n,))).to(device=device, dtype=dtype)
    p = KernelParams.make(args.f, args.l, args.mu, dtype=dtype, device=device)
    wlist = windows_of(args.d)
    windows = make_windows(wlist)

    K, dK = additive_kernel_matrix_with_grad(args.kernel, p, X, windows)
    exact = {"K@x": K @ x}
    dy_exact = torch.einsum("knm,m->kn", dK, x)
    plan = fs.additive_fastsum_build(args.kernel, p, X, windows, N=args.N, nearfield_lfil=args.nearfield_lfil)
    fast = {"K@x": fs.additive_fastsum_matvec(plan, x)}
    dy_fast = fs.additive_fastsum_grad_matvec(plan, x)
    for j, name in enumerate(GRAD_NAMES):
        exact[name], fast[name] = dy_exact[j], dy_fast[j]
    if args.kernel == "matern12" and args.nearfield_lfil is None:
        # the uncorrected pure-Fourier operator, so the default near-field
        # correction's gain is visible in one run
        plan0 = fs.additive_fastsum_build(args.kernel, p, X, windows, N=args.N, nearfield_lfil=0)
        fast["K@x nf=0"], exact["K@x nf=0"] = fs.additive_fastsum_matvec(plan0, x), exact["K@x"]
    return {"kernel": args.kernel, "n": args.n, "d": args.d, "N": args.N, "windows": wlist,
            "params": (args.f, args.l, args.mu), "device": str(device), "dtype": str(dtype).replace("torch.", ""),
            "rows": [(name, _errors(fast[name], exact[name])) for name in fast],
            "fast": {k: v.double().cpu().numpy() for k, v in fast.items()},
            "exact": {k: v.double().cpu().numpy() for k, v in exact.items()}}


def format_table(table) -> str:
    f, l, mu = table["params"]
    lines = [f"kernel={table['kernel']} n={table['n']} d={table['d']} N={table['N']} "
             f"windows={table['windows']} (f,l,mu)=({f},{l},{mu})"]
    for name, (linf, linf_rel, l2, l2_rel) in table["rows"]:
        lines.append(f"{name:10s} | Linf abs {linf:.3e} | Linf rel {linf_rel:.3e}"
                     f" | L2 abs {l2:.3e} | L2 rel {l2_rel:.3e}")
    return "\n".join(lines)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    if args.platform == "cpu":
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        sys.exit("torch_test1_oracle: no CUDA device; pass --platform cpu to run on the CPU")
    print(format_table(oracle_table(args, device)), flush=True)


if __name__ == "__main__":
    main()
