"""Two costs of the port's solves at n = 1e6 on the card (card only).

1. The dense triangular solve of a (k, k) factor against n right-hand
   sides, as the Nystrom set-up's L^{-1} K1' runs it: in one
   torch.linalg.solve_triangular call and as ops/matops.tril_solve runs it
   (slices of TRI_COLS columns), at k = 16, 50, 64, 200 and n = 4e5, 7e5,
   1e6 (a one-call time over 1 s skips the larger n of that k).  cuBLAS's
   trsm falls off a cliff in one call for small k and many columns
   (PERF.md).
2. FGMRES, 60 steps (kdim 60, tol 1e-12 so that none stops early), on the
   stream engine at scripts/torch_sharded_scale_demo.py's problem (n = 1e6,
   d = 10, five 2-D windows, N = 32, gaussian (1, 0.5, 0.1), psd_clip, bf16
   tables), without a preconditioner and with Nystrom 200 (torch
   generator seeded 0), with and without compensated reductions; s a
   solve and ms a step, then one compensated Nystrom solve under
   torch.profiler: the card's busy time, the host's time and the kernels
   launched.  One matvec and one Nystrom apply are timed beside.

Times are host wall time around synchronized calls, beside the card's
name and power limit.

  python scripts/torch_scale_solve_probe.py
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_card import card_label  # noqa: E402

N_SCALE = 1_000_000
TRI_KS = (16, 50, 64, 200)
TRI_NS = (400_000, 700_000, N_SCALE)


def _seconds(fn, reps=1):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps, out


def tri_solves(dev, label):
    import torch

    from nfft4gp_torch.ops.matops import TRI_COLS, tril_solve

    g = torch.Generator(device=dev).manual_seed(0)
    for k in TRI_KS:
        A = torch.randn(k, k, generator=g, device=dev)
        L = torch.linalg.cholesky(A @ A.T / k + torch.eye(k, device=dev))
        slow = False
        for n in TRI_NS:
            B = torch.randn(n, k, generator=g, device=dev).T
            tril_solve(L, B)
            s_sliced, X = _seconds(lambda: tril_solve(L, B), 3)
            res = float(torch.linalg.norm(L @ X - B) / torch.linalg.norm(B))
            line = (f"[tri] k={k} n={n}: tril_solve (slices of {TRI_COLS} columns) {s_sliced * 1e3:.3f} ms, "
                    f"residual {res:.1e}")
            if slow:
                line += "; one call skipped (over 1 s at a smaller n)"
            else:
                s_one, _ = _seconds(lambda: torch.linalg.solve_triangular(L, B, upper=False))
                line += f"; one solve_triangular call {s_one * 1e3:.3f} ms"
                slow = s_one > 1.0
            print(f"{line} | {label}", flush=True)


def fgmres_steps(dev, label):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.preconds.nystrom import nystrom_setup
    from nfft4gp_torch.solvers.fgmres import fgmres
    from nfft4gp_torch.utils.datasets import rand_perm

    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.uniform(size=(N_SCALE, 10)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=(N_SCALE,)).astype(np.float32)).to(dev)
    windows = make_windows([[i, i + 1] for i in range(0, 10, 2)])
    params = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float32, device=dev)
    geom = fs.additive_fastsum_geometry(X, windows, table_dtype=torch.bfloat16)
    pn = fs.packed_ndft_plan(fs.additive_fastsum_coeffs("gaussian", params, geom, psd_clip=True),
                             table_dtype=torch.bfloat16)

    def mv(v):
        return fs.packed_ndft_matvec(pn, v)

    landmarks = rand_perm(torch.Generator().manual_seed(0), N_SCALE, 200).to(dev)
    pre = nystrom_setup("gaussian", params, X, landmarks, 200, windows=windows)
    mv(b)
    pre.solve(b)
    print(f"[fgmres] n={N_SCALE}: matvec {_seconds(lambda: mv(b), 20)[0] * 1e3:.3f} ms, Nystrom 200 apply "
          f"{_seconds(lambda: pre.solve(b), 20)[0] * 1e3:.3f} ms | {label}", flush=True)
    for comp in (False, True):
        for name, psolve in (("none", None), ("nystrom 200", pre.solve)):
            def solve():
                return fgmres(mv, b, precond=psolve, kdim=60, maxits=60, tol=1e-12, compensated=comp)
            solve()
            s, res = _seconds(solve)
            print(f"[fgmres] 60 steps, compensated={comp}, precond={name}: {s:.3f} s ({s / 60 * 1e3:.2f} ms a step), "
                  f"{int(res.niter)} steps, relres {float(res.relres):.3e} | {label}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fgmres(mv, b, precond=pre.solve, kdim=60, maxits=60, tol=1e-12, compensated=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the kernels' and copies' own entries (the aten:: ops' device time is
    # theirs again)
    kernels = [e for e in events if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    card_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"[fgmres] profiled compensated Nystrom solve: wall {wall:.3f} s (profiler on), card busy "
          f"{card_us / 1e6:.3f} s, {launches} kernel launches and copies | {label}", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12), flush=True)


def main():
    import torch

    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    if not torch.cuda.is_available():
        sys.exit("torch_scale_solve_probe: no CUDA device; this probe runs only on a card")
    device = torch.device("cuda")

    label = card_label(device)
    print(f"[device] {label}", flush=True)
    tri_solves(device, label)
    fgmres_steps(device, label)


if __name__ == "__main__":
    main()
