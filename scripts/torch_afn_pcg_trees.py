"""Time the AFN-PCG solve of chip_smoke.py's [afn-pcg-256] with the port of
a given checkout, on one NVIDIA GPU.

    python3 scripts/torch_afn_pcg_trees.py [--tree DIR] [--label NAME] [--reps 15] [-- BENCH FLAGS]

DIR is the root of a checkout of the repo (default: the one that holds this
script): its package and its scripts/torch_afn_pcg_bench.py are the ones
imported, and its kernels build into its own `_build/`.  To compare two
commits on one card, unpack the earlier one with `git archive` into a
git-ignored directory and run this script once per tree, each in its own
process, in turns (earlier, current, current, earlier), all in one GPU call.

The configuration is AFN_PCG.md section 3's row at N = 256, as chip_smoke.py
runs it (n = 1e5, d = 2, matern12, float32 tables at 2P = 256 on the wide
kernels, the radius near-field of nf_lfil 128, AFN rank 200 lfil 16, PCG to
1e-2 with replace_every 25), set up through the tree's bench functions.
After one warm-up solve, --reps solves are each timed on the host clock
between synchronizations (the solve is host-bound): ms per iteration is a
solve's milliseconds over its iterations.  Flags after `--` go to the bench's
parser after these (`-- --n 2000 --N 64 --platform cpu --x64` rehearses it
on the CPU).  Prints one JSON line: the label, the card's name and power
limit, the iterations, every solve's ms per iteration and their median.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

AFN_PCG_256_ARGV = ["--n", "100000", "--d", "2", "--kernel", "matern12", "--l", "0.1", "--mu", "0.01", "--N", "256",
                    "--nf-lfil", "128", "--rank", "200", "--lfil", "16", "--tol", "1e-2", "--maxits", "400", "--comp",
                    "--replace-every", "25", "--engine", "stream", "--precs", "afn", "--solvers", "pcg"]


def _card():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    import torch
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    if not Path(nfft4gp_torch.__file__).resolve().is_relative_to(tree):
        sys.exit(f"torch_afn_pcg_trees: imported {nfft4gp_torch.__file__}, not the package of {tree}")
    spec = importlib.util.spec_from_file_location("torch_afn_pcg_bench", tree / "scripts" / "torch_afn_pcg_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bargs = bench.parse_args(AFN_PCG_256_ARGV + extra)
    dev = bench.device_of(bargs)
    X, b, dtype = bench.make_problem(bargs, dev)
    params = KernelParams.make(1.0, bargs.l, bargs.mu, dtype=dtype, device=dev)
    windows = make_windows(bench.windows_of(bargs.d))
    mv, _ = bench.build_operator(bargs, X, params, windows, log=lambda m: None)
    (_, setup_s, pre, _), = bench.preconditioners(bargs, X, params, windows, ["afn"])
    bench.solve(bargs, mv, b, pre, "pcg")
    runs = []
    for _ in range(args.reps):
        bench._sync(dev)
        t0 = time.perf_counter()
        res = bench.solve(bargs, mv, b, pre, "pcg")
        bench._sync(dev)
        runs.append(((time.perf_counter() - t0) * 1e3, int(res.niter), float(res.relres)))
    per_iter = [ms / it for ms, it, _ in runs]
    print(json.dumps({"label": args.label or str(tree), "device": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu", "nvidia_smi": _card() if dev.type == "cuda" else None,
                      "n": bargs.n, "N": bargs.N, "afn_setup_s": setup_s, "iterations": sorted({it for _, it, _ in runs}),
                      "relres": max(r for _, _, r in runs), "ms_per_iteration": per_iter,
                      "median_ms_per_iteration": statistics.median(per_iter)}), flush=True)


if __name__ == "__main__":
    main()
