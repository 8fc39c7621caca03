"""Stage times of the port's large-n fastsum set-up; the port of
scripts/setup_timing.py.

Splits the plan build at the JAX script's size (n = 1e6 points uniform in
d = 10 features, five 2-D windows [i, i + 1], N = 32, gaussian (1, 0.5,
0.1), psd_clip) into stages and gives each stage's cold (first) and warm
(second) seconds:

  transfer    host -> device of X
  geometry    centre / scale and the folded phase tables of each window
  coeffs      torus sampling + FFT + fold (per parameters: every loss)
  packed      the packed phase table (pack_phase_table) and weights
  matvec      one packed_ndft_matvec: the table kernels on the card
              (bfloat16 tables: csrc/packed_ndft_tc.cu; float32 tables at
              N = 32: the float32-table pair of csrc/packed_ndft.cu, by
              ops/packed_ndft.table_route)
  matvec_tab  one additive_fastsum_matvec (the folded-NDFT products in
              torch, the table path)

The JAX script's first call of a stage includes its compile.  The port has
no compile per stage; its CUDA kernels are built (nvcc) and loaded before
the stages, and that build's seconds are printed on their own line, so
"cold" is the first call on a built kernel.  The JAX script's Mosaic
precision arguments (upcast, prec) are not ported.  Each stage ends in a
synchronization; seconds are host wall time, printed beside the card's
name and power limit.

  python scripts/torch_setup_timing.py                          # the card
  python scripts/torch_setup_timing.py --table-dtype float32
  python scripts/torch_setup_timing.py --platform cpu --n 20000
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label, device_of, sync  # noqa: E402

def build_argparser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=10)
    ap.add_argument("--N", type=int, default=32)
    ap.add_argument("--kind", default="gaussian")
    ap.add_argument("--json", default=None)
    ap.add_argument("--table-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="'bfloat16' (training default) | 'float32'")
    ap.add_argument("--platform", default=None, choices=[None, "cpu", "cuda"],
                    help="cpu runs on the CPU; the default is the card")
    return ap


def build_kernels():
    """Compile (if needed) and load the CUDA libraries; their seconds."""
    from nfft4gp_torch.ops import _cuda_build

    t0 = time.perf_counter()
    paths, _ = _cuda_build.build()
    for lib in paths:
        _cuda_build.library(lib)
    return time.perf_counter() - t0


def run_stages(args, device, log=print):
    """{name: {"cold_s", "warm_s"}} of the JAX script's stages."""
    import torch

    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    tdt = torch.bfloat16 if args.table_dtype == "bfloat16" else None
    windows = make_windows([[i, i + 1] for i in range(0, args.d, 2)])
    params = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    Xh = rng.uniform(size=(args.n, args.d)).astype(np.float32)
    stages = {}

    def stage(name, fn, repeat=True):
        t0 = time.perf_counter()
        r = fn()
        sync(device)
        cold = time.perf_counter() - t0
        warm = None
        if repeat:
            t0 = time.perf_counter()
            r = fn()
            sync(device)
            warm = time.perf_counter() - t0
        stages[name] = {"cold_s": cold, "warm_s": warm}
        log(f"{name:10s} cold {cold:8.3f}s  warm {(warm if warm is not None else float('nan')):8.3f}s")
        return r

    X = stage("transfer", lambda: torch.from_numpy(Xh).to(device), repeat=False)
    geom = stage("geometry", lambda: fs.additive_fastsum_geometry(X, windows, N=args.N, table_dtype=tdt))
    plan = stage("coeffs", lambda: fs.additive_fastsum_coeffs(args.kind, params, geom, psd_clip=True))
    pn = stage("packed", lambda: fs.packed_ndft_plan(plan, table_dtype=tdt))
    b = torch.from_numpy(rng.normal(size=(args.n,)).astype(np.float32)).to(device)
    stage("matvec", lambda: fs.packed_ndft_matvec(pn, b))
    stage("matvec_tab", lambda: fs.additive_fastsum_matvec(plan, b))
    return stages


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    device = device_of(args.platform, "torch_setup_timing")
    label = card_label(device)
    print(f"[device] {label}", flush=True)
    build_s = None
    if device.type == "cuda":
        build_s = build_kernels()
        print(f"build      {build_s:8.3f}s (nvcc and loading of the CUDA libraries, before the stages) | {label}",
              flush=True)
    stages = run_stages(args, device, log=lambda m: print(f"{m} | {label}", flush=True))
    out = {"n": args.n, "d": args.d, "N": args.N, "kind": args.kind, "table_dtype": args.table_dtype,
           "device": label, "build_s": build_s, "stages": stages}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
