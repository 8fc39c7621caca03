"""Smoke run of the PyTorch port's training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: compiles the two kernel libraries of csrc/ with nvcc (sm_90a),
     one nvcc per source, both at once, if needed;
  3. kernels: the table kernels (CUDA adjoint and forward) against their
     plain torch versions on the card at the training shapes (n = 2e5,
     d = 10, five 2-D windows, N = 32, bf16 table), plus a case with a 1-D
     window, plus the fused layout's windows trimmed to 2P = 32;
  4. kernels-regen: the phase-regenerating kernels against their plain
     versions at the fused layout WINDOWS_FUSED (its 2-D and 1-D windows;
     N = 32, untrimmed 2P = 34), both phase sources ("doubling", "direct"),
     nv = 1, 10 and nsets = 1, 2, 20;
     in 3 and 4 the limit is a relative Frobenius error <= 1e-4 (two f32
     sums over 2e5 terms in different orders, about sqrt(n) eps); median
     times from CUDA events;
  5. main: GPProblem(fastsum + Nystrom, gaussian, stream engine).fit for 3
     Adam steps at n = 2e5; every loss finite and both table kernels
     launched during the fit;
  6. agree: at n = 2e4, the streamed kernels against the torch table engine
     (loss rtol 4e-2, gradient rtol 2e-1 / atol 2e-2: the engines differ by
     the trimmed Nyquist mode and bf16 table rounding);
  7. fused: GPProblem(matern12, WINDOWS_FUSED, fastsum_fused=True).fit for 3
     Adam steps at n = 2e5: the KNN near-field built once (its form and row
     widths printed), the 3-feature window on the table path; every loss
     finite and both regenerating kernels launched during the fit;
  8. agree-fused: at n = 2e4, the fused engine against the table engine with
     float32 tables, the same probes, landmarks and near-field patterns, at
     (f, l, mu) = (1, 0.5, 1) (loss rtol 1e-3, gradient rtol 1e-2 / atol
     1e-3: the two apply the same untrimmed operator -- in float64 their
     losses agree to 1e-15 -- and in float32 differ only in summation order
     and phase evaluation, about 1e-7 on a matvec).  Not at mu = 0.1: there
     FGMRES stops unconverged after its 2 maxits = 20 steps (relres 7e-2 to
     9e-2 on the card), so yKy/n is set by float32 rounding (table engine
     float32 vs float64 on the card: 28% apart) and cannot tell the engines
     apart; the SLQ logdet term agrees to 5e-6 there.

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
WINDOWS_FUSED = [[0, 1, 2], [3, 4], [5, 6], [7, 8], [9]]
FASTSUM_N = 32
KERNEL_RTOL = 1e-4
PKG = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu"
SOURCES = {"table": f"{PKG}_torch/csrc/packed_ndft.cu", "regen": f"{PKG}_torch/csrc/packed_ndft_regen.cu"}
TPU_KERNELS = {"adjoint": f"{PKG}/ops/pallas_ndft.py:189", "forward": f"{PKG}/ops/pallas_ndft.py:361"}


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


def check_pair(tag, names, adj, adj_plain, fwd, fwd_plain, lay, P, X, nvs, nsets_list, timed):
    """One adjoint kernel and one forward kernel against their plain versions.

    adj(alpha) / fwd(G2, G1) are the wrappers on one layout; adj_plain /
    fwd_plain the plain versions.  Returns per-case dicts (kernel, mode,
    shape, rel, max_abs, ms, plain_ms)."""
    n, dev = X.shape[0], X.device
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    for nv in nvs:
        alpha = torch.randn((nv, n), generator=gen, device=dev)
        got = adj(alpha)
        torch.cuda.synchronize()
        want = adj_plain(alpha)
        rel, mx = _rel_err([torch.stack(g, dim=1) for g in got if g], [w for w in want if w.numel()])
        ms = cuda_ms(lambda: adj(alpha)) if timed else None
        pms = cuda_ms(lambda: adj_plain(alpha)) if timed else None
        cases.append(dict(kernel=names[0], shape=f"nv={nv}", rel=rel, max_abs=mx, ms=ms, plain_ms=pms))

    # realistic combined weights: K and dK/dl sets of real adjoint outputs
    from nfft4gp_torch.ops import fastsum as fs

    alpha = torch.randn((-(-max(nsets_list) // 2), n), generator=gen, device=dev)
    A2, A1 = adj_plain(alpha)
    G2all = [torch.stack([fs._folded_combine(W[i], A2[:, i], 2) for W in (lay.w2, lay.dw2)], 1)
             .reshape(-1, 2 * P, 2 * P) for i in range(len(lay.pairs))]
    G1all = [torch.stack([fs._folded_combine(W[i], A1[:, i], 1) for W in (lay.w1, lay.dw1)], 1)
             .reshape(-1, 2 * P) for i in range(len(lay.singles))]
    for nsets in nsets_list:
        G2 = [g[:nsets].contiguous() for g in G2all]
        G1 = [g[:nsets].contiguous() for g in G1all]
        got = fwd(G2, G1)
        torch.cuda.synchronize()
        G2s = torch.stack(G2, 1) if G2 else None
        G1s = torch.stack(G1, 1) if G1 else None
        rel, mx = _rel_err(got, [fwd_plain(G2s, G1s)])
        ms = cuda_ms(lambda: fwd(G2, G1)) if timed else None
        pms = cuda_ms(lambda: fwd_plain(G2s, G1s)) if timed else None
        cases.append(dict(kernel=names[1], shape=f"nsets={nsets}", rel=rel, max_abs=mx, ms=ms, plain_ms=pms))

    for c in cases:
        c["mode"] = tag.split(" ")[0]
        print(f"[{'kernels-regen' if names[0].endswith('regen') else 'kernels'}] {tag} {c['kernel']} "
              f"{c['shape']}: rel_err={c['rel']:.3e} max_abs_err={c['max_abs']:.3e} ms={c['ms']} "
              f"plain_ms={c['plain_ms']}", flush=True)
        if not c["rel"] <= KERNEL_RTOL:
            raise AssertionError(f"{c['kernel']} {tag} {c['shape']} disagrees with its plain version: {c['rel']}")
    return cases


def _plan(X, windows):
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    params = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float32, device=X.device)
    return fs.additive_fastsum_build("gaussian", params, X, make_windows(windows), N=FASTSUM_N)


def check_kernels(X, windows, nvs, nsets_list, timed=True):
    """The table kernels against their plain versions (bf16 table, 2P = 32)."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    pn = fs.packed_ndft_plan(_plan(X, windows), table_dtype=torch.bfloat16)
    Tp, pairs, singles = pn.Tp, pn.pairs, pn.singles
    return check_pair(
        f"table-bf16 windows={windows}", ("packed_adjoint", "packed_forward"),
        lambda a: pk.packed_adjoint(Tp, a, pairs=pairs, singles=singles),
        lambda a: pk.packed_adjoint_plain(Tp, a, pairs, singles),
        lambda G2, G1: pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles),
        lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, singles),
        pn, pn.P, X, nvs, nsets_list, timed)


def check_regen_kernels(X, nvs=(1, 10), nsets_list=(1, 2, 20)):
    """The regenerating kernels against their plain versions on the d <= 2
    windows of WINDOWS_FUSED, untrimmed (2P = 34), both phase sources."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    plan = _plan(X, WINDOWS_FUSED)
    lay = fs._packed_layout(plan)
    P = fs._nmodes(FASTSUM_N)
    xT, pairs, singles = lay.xT, lay.pairs, lay.singles
    cases = []
    for gen in pk.PHASE_GENS:
        kw = dict(P=P, pairs=pairs, singles=singles, phase_gen=gen)
        cases += check_pair(
            f"{gen} windows={WINDOWS_FUSED}", ("packed_adjoint_regen", "packed_forward_regen"),
            lambda a: pk.packed_adjoint_regen(xT, a, **kw),
            lambda a: pk.packed_adjoint_regen_plain(xT, a, P, pairs, singles, gen),
            lambda G2, G1: pk.packed_forward_regen(xT, G2, G1, **kw),
            lambda G2s, G1s: pk.packed_forward_regen_plain(xT, G2s, G1s, P, pairs, singles, gen),
            lay, P, X, nvs, nsets_list, True)
    return cases


def timed_fit(prob, X, y, counted):
    """3 Adam steps of prob.fit with the given kernels' launch counts set to 0
    just before and read just after.  Returns (losses, seconds to the end of
    each step from the call of fit, launch counts)."""
    from nfft4gp_torch.ops import packed_ndft as pk

    stamps = []

    def tick(*_):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    pk.reset_launch_counts()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    prob.fit(X, y, adam_maxits=3, callback=tick)
    counts = {fn.__name__: fn.launches for fn in pk.KERNEL_WRAPPERS}
    losses = prob.loss_history_
    if len(losses) != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"losses not finite: {losses}")
    if min(counts[k] for k in counted) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    return losses, np.diff(stamps), counts


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


FUSED = dict(kernel="matern12", windows=WINDOWS_FUSED, operator="fastsum", precond="nystrom",
             rank=50, maxits=10, nvecs=10, fastsum_N=FASTSUM_N)


def check_fused_engines(X, y):
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse

    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0], device=X.device))
    fused = GPProblem(fastsum_fused=True, **FUSED)
    loss_f, grad_f = fused.make_loss(X, y)(raw)
    loss_t, grad_t = GPProblem(fastsum_engine="table", fastsum_table_dtype="float32", **FUSED).make_loss(
        X, y, nf_patterns=fused.nf_patterns_)(raw)
    print(f"[agree-fused] n={X.shape[0]} (f, l, mu) = (1, 0.5, 1) fused loss={float(loss_f):.8e} grad={grad_f.tolist()} | "
          f"table(f32) loss={float(loss_t):.8e} grad={grad_t.tolist()}", flush=True)
    np.testing.assert_allclose(float(loss_f), float(loss_t), rtol=1e-3)
    np.testing.assert_allclose(grad_f.cpu().numpy(), grad_t.cpu().numpy(), rtol=1e-2, atol=1e-3)


def _summary(name, route, mode, cases, shape, launches):
    c = next(c for c in cases if c["kernel"] == name and c["shape"] == shape and c["mode"] == mode)
    base = "adjoint" if "adjoint" in name else "forward"
    return {"name": name, "route": "cuda", "source": SOURCES[route], "replaces": TPU_KERNELS[base],
            "mode": mode, "launches": launches[name],
            "max_abs_err": max(d["max_abs"] for d in cases if d["kernel"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"]}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.ops import _cuda_build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] torch: {name}, count {torch.cuda.device_count()}; nvidia-smi name, power.limit:", flush=True)
    print(smi, flush=True)

    paths, secs = _cuda_build.build()
    for lib in paths:
        _cuda_build.library(lib)
    print(f"[build] {', '.join(p.parent.name for p in paths.values())} compiled in {secs:.1f} s "
          "(one nvcc per source, in parallel)", flush=True)

    X, y = make_data(N_POINTS)
    cases = check_kernels(X, WINDOWS, nvs=(1, 10), nsets_list=(1, 2, 20))
    cases += check_kernels(X, WINDOWS_1D, nvs=(1, 10), nsets_list=(1, 20), timed=False)
    check_kernels(X, WINDOWS_FUSED, nvs=(1, 10), nsets_list=(1, 2, 20))
    regen = check_regen_kernels(X)

    prob = GPProblem(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom",
                     rank=50, maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
    losses, steps, counts = timed_fit(prob, X, y, ("packed_adjoint", "packed_forward"))
    print(f"[main] n={N_POINTS} losses={losses} s_per_step={steps.tolist()} "
          f"median_s_per_step={float(np.median(steps)):.4f} launches={counts}", flush=True)

    check_engines(X[:N_AGREE], y[:N_AGREE])

    fprob = GPProblem(fastsum_fused=True, **FUSED)
    flosses, fsteps, fcounts = timed_fit(fprob, X, y, ("packed_adjoint_regen", "packed_forward_regen"))
    nf = [None if p is None else (p[2], tuple(p[0].shape)) for p in fprob.nf_patterns_]
    print(f"[fused] n={N_POINTS} windows={WINDOWS_FUSED} nf (nf_sym, (windows, n, row width)) per group={nf} "
          f"losses={flosses} s_per_step={fsteps.tolist()} (the first includes the set-up: geometry, KNN, "
          f"symmetrization) median_steady_s_per_step={float(np.median(fsteps[1:])):.4f} launches={fcounts}",
          flush=True)
    if not any(p is not None for p in fprob.nf_patterns_):
        raise AssertionError("the matern12 fused path built no near-field")

    check_fused_engines(X[:N_AGREE], y[:N_AGREE])

    summary = [_summary("packed_adjoint", "table", "table-bf16", cases, "nv=10", counts),
               _summary("packed_forward", "table", "table-bf16", cases, "nsets=20", counts),
               _summary("packed_adjoint_regen", "regen", "doubling", regen, "nv=10", fcounts),
               _summary("packed_forward_regen", "regen", "doubling", regen, "nsets=20", fcounts)]
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
