"""Time the port's bf16-table NDFT kernels against an earlier build of them,
and profile one gaussian loss step, on one NVIDIA GPU.

    python3 scripts/torch_table_kernels_ab.py --old-csrc OLD/csrc

OLD/csrc holds an earlier `packed_ndft.cu` (and its `packed_ndft.cuh`) whose
C interface takes a contiguous table and a bf16 flag (the CUDA-core kernels
the tensor-core ones replaced; unpack them from an earlier commit with
`git archive`).  At the training shapes of chip_smoke.py (n = 2e5, d = 10,
five 2-D windows, N = 32, bf16 table) it builds that source with nvcc into
`_chip_scratch/ab_build/`, checks the old kernels against the current ones,
then times them in turns, old, new, new, old (medians of CUDA-event
timings), at nv = 1, 10 (adjoint) and nsets = 1, 2, 10, 20 (forward), and
prints the ratios old / new.  Without --old-csrc only the current kernels
are timed.

Then it profiles one loss-and-gradient step of GPProblem(gaussian, five 2-D
windows, fastsum, nystrom, stream engine) at n = 2e5 under torch.profiler
after a warm-up step: wall time, device-busy time (the union of the device
kernels' intervals) and its share of the wall time, and the device time by
kernel.  Prints one JSON line at the end.  Exits non-zero without CUDA.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NVS = (1, 10)
NSETS = (1, 2, 10, 20)


def build_old(csrc: Path) -> ctypes.CDLL:
    from nfft4gp_torch.ops import _cuda_build

    out = ROOT / "_chip_scratch" / "ab_build" / "libpacked_ndft_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                    str(csrc / "packed_ndft.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, P, P]
    lib.forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, P, P]
    lib.adjoint_launch.restype = lib.forward_launch.restype = I
    return lib


def old_calls(lib, Tp, pairs):
    """The earlier kernels' adjoint(alpha) and forward(G2) on a contiguous
    bf16 table, chunked as their wrapper chunked them."""
    from nfft4gp_torch.ops import _cuda_build as cb

    T = Tp.contiguous()
    _, WR, n = T.shape
    pr = cb._ints(v for p in pairs for v in p)
    sg = cb._ints(())

    def adj(alpha):
        nv = alpha.shape[0]
        nchunks, chunk = cb._chunks(n, len(pairs) * -(-nv // cb.rhs_per_block(WR)))
        S = nv * len(pairs) * WR * WR
        part = torch.empty((nchunks, S), device=alpha.device)
        out = torch.empty(S, device=alpha.device)
        code = lib.adjoint_launch(T.data_ptr(), 1, alpha.data_ptr(), WR, n, nv, pr, len(pairs), sg, 0,
                                  part.data_ptr(), nchunks, chunk, out.data_ptr(), cb._stream(alpha))
        assert code == 0, code
        return out.reshape(nv, len(pairs), WR, WR)

    def fwd(G2):
        y = torch.empty((G2.shape[0], n), device=G2.device)
        g1 = torch.zeros(1, device=G2.device)
        code = lib.forward_launch(T.data_ptr(), 1, WR, n, pr, len(pairs), G2.data_ptr(), sg, 0, g1.data_ptr(),
                                  G2.shape[0], y.data_ptr(), cb._stream(G2))
        assert code == 0, code
        return y

    return adj, fwd


def ab(old_lib, X):
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    pn = fs.packed_ndft_plan(cs._plan(X, cs.WINDOWS), table_dtype=torch.bfloat16)
    Tp, pairs = pn.Tp, pn.pairs
    W2 = Tp.shape[1]
    gen = torch.Generator(device=X.device).manual_seed(3)
    calls = []
    for nv in NVS:
        alpha = torch.randn((nv, X.shape[0]), generator=gen, device=X.device)
        new = (lambda a: lambda: pk.packed_adjoint(Tp, a, pairs=pairs))(alpha)
        calls.append((f"adjoint nv={nv}", new, alpha))
    for nsets in NSETS:
        G2 = torch.randn((nsets, len(pairs), W2, W2), generator=gen, device=X.device)
        G2s = list(torch.unbind(G2, 1))
        new = (lambda g: lambda: pk.packed_forward(Tp, g, pairs=pairs))(G2s)
        calls.append((f"forward nsets={nsets}", new, G2))
    rows = []
    old_adj, old_fwd = old_calls(old_lib, Tp, pairs) if old_lib else (None, None)
    for name, new, arg in calls:
        row = {"call": name}
        if old_lib:
            old = (lambda: old_adj(arg)) if name.startswith("adjoint") else (lambda: old_fwd(arg))
            got = new()
            got = torch.stack(got[0], 1) if name.startswith("adjoint") else torch.stack(got)
            want = old()
            row["rel_old_new"] = float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))
            t = [cs.cuda_ms(old), cs.cuda_ms(new), cs.cuda_ms(new), cs.cuda_ms(old)]
            row.update(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]], ratio_old_over_new=(t[0] + t[3]) / (t[1] + t[2]))
        else:
            row["new_ms"] = [cs.cuda_ms(new)]
        print(f"[ab] {json.dumps(row)}", flush=True)
        rows.append(row)
    return rows


def profile_step(X, y):
    from torch.profiler import ProfilerActivity, profile

    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse

    prob = GPProblem(kernel="gaussian", windows=cs.WINDOWS, operator="fastsum", precond="nystrom",
                     rank=50, maxits=10, nvecs=10, fastsum_N=cs.FASTSUM_N, fastsum_engine="stream")
    loss_fn = prob.make_loss(X, y)
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1], device=X.device))
    loss_fn(raw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = loss_fn(raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    out = {"loss": float(loss), "wall_ms": wall_ms, "device_busy_ms": busy / 1e3 if spans else None,
           "busy_share": busy / 1e3 / wall_ms if spans else None, "device_kernels": len(spans),
           "device_ms_by_kernel": top}
    print(f"[profile] {json.dumps(out)}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_table_kernels_ab: no CUDA device")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {cs.nvidia_smi()}", flush=True)
    old_lib = build_old(args.old_csrc.resolve()) if args.old_csrc else None
    X, y = cs.make_data(cs.N_POINTS)
    rows = ab(old_lib, X)
    prof = profile_step(X, y)
    print(json.dumps({"ab": rows, "profile": prof}), flush=True)


if __name__ == "__main__":
    main()
