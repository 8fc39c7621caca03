"""Smoke run of the PyTorch port's training step on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: compiles csrc/packed_ndft.cu with nvcc (sm_90a) if needed;
  3. kernels: the CUDA adjoint and forward against their plain torch versions
     on the card at the training shapes (n = 2e5, d = 10, five 2-D windows,
     N = 32, bf16 table), plus a case with a 1-D window; relative Frobenius
     error <= 1e-4 (two f32 sums over 2e5 terms in different orders, about
     sqrt(n) eps); median times from CUDA events;
  4. main path: GPProblem(fastsum + Nystrom).fit for 3 Adam steps at
     n = 2e5; every loss finite and both kernels launched during the fit;
  5. engine agreement at n = 2e4: the streamed kernels against the torch
     table engine (loss rtol 4e-2, gradient rtol 2e-1 / atol 2e-2: the
     engines differ by the trimmed Nyquist mode and bf16 table rounding).

The line before the last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  Without CUDA the script exits non-zero.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS = 200_000
N_AGREE = 20_000
DIM = 10
WINDOWS = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
WINDOWS_1D = [[0, 1], [2, 3], [4]]
FASTSUM_N = 32
KERNEL_RTOL = 1e-4
SOURCE = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch/csrc/packed_ndft.cu"
TPU_KERNELS = {
    "packed_adjoint": "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu/ops/pallas_ndft.py:189",
    "packed_forward": "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu/ops/pallas_ndft.py:361",
}


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, DIM)).astype(np.float32)
    y = (np.sin(3.0 * X[:, 0]) + np.cos(2.0 * X[:, 3]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    dev = torch.device("cuda:0")
    return torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() from CUDA events, one event pair per rep."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _rel_err(got, want):
    got = torch.cat([g.reshape(-1) for g in got])
    want = torch.cat([w.reshape(-1) for w in want])
    diff = (got - want).double()
    return float(torch.linalg.norm(diff) / torch.linalg.norm(want.double())), float(diff.abs().max())


def check_kernels(X, windows, nvs, nsets_list, timed=True):
    """Kernel vs plain version on the card for one window layout.

    Returns a list of per-case dicts (kernel, shape, rel, max_abs, ms, plain_ms)."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    params = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float32, device=X.device)
    plan = fs.additive_fastsum_build("gaussian", params, X, make_windows(windows), N=FASTSUM_N,
                                     table_dtype=torch.bfloat16)
    pn = fs.packed_ndft_plan(plan, table_dtype=torch.bfloat16)
    Tp, pairs, singles = pn.Tp, pn.pairs, pn.singles
    gen = torch.Generator(device=X.device).manual_seed(1)
    cases = []

    for nv in nvs:
        alpha = torch.randn((nv, X.shape[0]), generator=gen, device=X.device)
        got = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
        torch.cuda.synchronize()
        want = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
        got = [torch.stack(g, dim=1) for g in got if g]
        rel, mx = _rel_err(got, [w for w in want if w.numel()])
        ms = cuda_ms(lambda: pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)) if timed else None
        pms = cuda_ms(lambda: pk.packed_adjoint_plain(Tp, alpha, pairs, singles)) if timed else None
        cases.append(dict(kernel="packed_adjoint", shape=f"nv={nv}", rel=rel, max_abs=mx, ms=ms, plain_ms=pms))

    # realistic combined weights: K and dK/dl sets of real adjoint outputs
    nmax = max(nsets_list)
    alpha = torch.randn((-(-nmax // 2), X.shape[0]), generator=gen, device=X.device)
    A2, A1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    G2all = [torch.stack([fs._folded_combine(W[i], A2[:, i], 2) for W in (pn.w2, pn.dw2)], 1)
             .reshape(-1, 2 * pn.P, 2 * pn.P) for i in range(len(pairs))]
    G1all = [torch.stack([fs._folded_combine(W[i], A1[:, i], 1) for W in (pn.w1, pn.dw1)], 1)
             .reshape(-1, 2 * pn.P) for i in range(len(singles))]
    for nsets in nsets_list:
        G2 = [g[:nsets].contiguous() for g in G2all]
        G1 = [g[:nsets].contiguous() for g in G1all]
        got = pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles)
        torch.cuda.synchronize()
        G2s = torch.stack(G2, 1) if pairs else None
        G1s = torch.stack(G1, 1) if singles else None
        want = pk.packed_forward_plain(Tp, G2s, G1s, pairs, singles)
        rel, mx = _rel_err(got, [want])
        ms = cuda_ms(lambda: pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles)) if timed else None
        pms = cuda_ms(lambda: pk.packed_forward_plain(Tp, G2s, G1s, pairs, singles)) if timed else None
        cases.append(dict(kernel="packed_forward", shape=f"nsets={nsets}", rel=rel, max_abs=mx, ms=ms, plain_ms=pms))

    for c in cases:
        print(f"[kernels] windows={windows} {c['kernel']} {c['shape']}: rel_err={c['rel']:.3e} "
              f"max_abs_err={c['max_abs']:.3e} ms={c['ms']} plain_ms={c['plain_ms']}", flush=True)
        if not c["rel"] <= KERNEL_RTOL:
            raise AssertionError(f"{c['kernel']} {c['shape']} disagrees with its plain version: {c['rel']}")
    return cases


def run_main_path(X, y):
    """3 Adam steps of the five-window fastsum + Nystrom fit; returns
    (losses, seconds per step, launch counts during the fit)."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.ops import packed_ndft as pk

    stamps = []

    def tick(*_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    prob = GPProblem(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom",
                     rank=50, maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stamps.append(t0)
    prob.fit(X, y, adam_maxits=3, callback=tick)
    counts = {"packed_adjoint": pk.packed_adjoint.launches, "packed_forward": pk.packed_forward.launches}
    steps = np.diff(stamps)
    return prob.loss_history_, steps, counts


def check_engines(X, y):
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse

    kw = dict(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom",
              rank=50, maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1], device=X.device))
    loss_s, grad_s = GPProblem(fastsum_engine="stream", **kw).make_loss(X, y)(raw)
    loss_t, grad_t = GPProblem(fastsum_engine="table", **kw).make_loss(X, y)(raw)
    print(f"[agree] n={X.shape[0]} stream loss={float(loss_s):.8e} grad={grad_s.tolist()} | "
          f"table loss={float(loss_t):.8e} grad={grad_t.tolist()}", flush=True)
    np.testing.assert_allclose(float(loss_s), float(loss_t), rtol=4e-2)
    np.testing.assert_allclose(grad_s.cpu().numpy(), grad_t.cpu().numpy(), rtol=2e-1, atol=2e-2)


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    from nfft4gp_torch.ops import _cuda_build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] torch: {name}, count {torch.cuda.device_count()}; nvidia-smi name, power.limit:", flush=True)
    print(smi, flush=True)

    path, secs = _cuda_build.build()
    _cuda_build.library()
    print(f"[build] {path.parent.name}/{path.name} compiled in {secs:.1f} s", flush=True)

    X, y = make_data(N_POINTS)
    cases = check_kernels(X, WINDOWS, nvs=(1, 10), nsets_list=(1, 2, 20))
    cases += check_kernels(X, WINDOWS_1D, nvs=(1, 10), nsets_list=(1, 20), timed=False)

    losses, steps, counts = run_main_path(X, y)
    print(f"[main] n={N_POINTS} losses={losses} s_per_step={steps.tolist()} "
          f"median_s_per_step={float(np.median(steps)):.4f} launches={counts}", flush=True)
    if not all(np.isfinite(losses)) or len(losses) != 3:
        raise AssertionError(f"main path losses not finite: {losses}")
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: {counts}")

    check_engines(X[:N_AGREE], y[:N_AGREE])

    summary = []
    for kname, shape in (("packed_adjoint", "nv=10"), ("packed_forward", "nsets=20")):
        c = next(c for c in cases if c["kernel"] == kname and c["shape"] == shape)
        summary.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": TPU_KERNELS[kname],
            "launches": counts[kname], "max_abs_err": max(d["max_abs"] for d in cases if d["kernel"] == kname),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
