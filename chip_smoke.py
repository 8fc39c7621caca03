"""Smoke run of the PyTorch port's training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. device: torch's device name and nvidia-smi's name and power limit;
  2. build: compiles the five kernel libraries of csrc/ with nvcc (sm_90a),
     prints ptxas's registers, spills and shared memory of the wide pair
     (none may spill) and its notes on the wgmma adjoint and forward,
     one nvcc per source, all at once, if needed, and checks grid.sync()
     with a tiny cooperative kernel over every resident block;
  3. kernels: the bf16-table kernels (the tensor-core adjoint and forward
     of csrc/packed_ndft_tc.cu) against their plain torch versions on the
     card at the training shapes (n = 2e5, d = 10, five 2-D windows, N = 32,
     bf16 table; nv = 1, 10 and nsets = 1, 2, 10, 20, the launch mix of an
     Adam step), plus a case with a 1-D window, plus the fused layout's
     windows trimmed to 2P = 32; and the float32-table kernels through the
     wrappers (csrc/packed_ndft.cu, CUDA cores fed by a TMA ring, or the
     wide pair where `table_route` sends the count) at 2P = 16 and 32, at
     [afn-pcg]'s one pair and at the AFN-PCG bench's default five pairs
     (n = 1e5, d = 10), adjoint nv = 1, 10 and forward nsets = 1, 2, 10,
     20, each bound on the units of the kernel the route picks, the wide
     pair on the same inputs beside each (held against the plain version,
     bitwise on a second launch, and timed) and one read of the table
     (torch.sum, the cold-read yardstick) timed beside; the shapes
     bound by bytes whose inputs fit the 50 MB L2 are timed cold too
     (`cuda_ms(cold=True)`: the L2 flushed before every call, an event pair
     a call), and their share is the cold one; a second launch of each must
     be bitwise equal to the first, and each prints its share of its bound;
  4. kernels-regen: the phase-regenerating kernels against their plain
     versions at the fused layout WINDOWS_FUSED (its 2-D and 1-D windows;
     N = 32, untrimmed 2P = 34), both phase sources ("doubling", "direct"),
     nv = 1, 10 and nsets = 1, 2, 10, 20 (both on the tensor cores in
     3xTF32, csrc/packed_ndft_regen.cu: the adjoint's bound and the
     forward's on 3 x their 2-D windows' flops at the TF32 peak or their
     CUDA-core flops at the float32 peak, whichever takes longer); a second
     launch of each must be bitwise equal to the first;
  4b. kernels-wide: the wide pair (csrc/packed_ndft_wide.cu, every even 2P
     the narrow kernels lack: the 2-D windows of the adjoint and of the
     forward on wgmma in 3xTF32, two products on a bf16 table; their 1-D
     windows on the CUDA cores; the regenerating sources write their phases
     into a float32 slab first) against its
     plain versions through the wrappers at n = 1e5: at the window [0, 1]
     ([afn-pcg-256]'s shape) float32 and bf16 tables at 2P = 64, 128, 256
     (nv = 1, 10; nsets = 1, 2, 10, 20), a 1-D window beside it at 2P = 128,
     both regenerating sources at 2P = 130, 258 (against the plain versions
     in float64: a float32 plain version's own phases at p ~ 128 err by
     more than the kernel); at WINDOWS ([wide-train]'s shape) the bf16
     table at 2P = 128 and both regenerating sources at 2P = 130 (nv = 1,
     10; nsets = 1, 2, 10, 20); and at 2P = 32 the wide pair beside the
     narrow bf16-table kernels on the same inputs (the float32 table's are
     in 3); a second launch of each must be
     bitwise equal, and no narrow kernel may serve a wide width; bound: the
     2-D products 3 x (bf16 tables 2 x) at the TF32 peak beside the 1-D
     windows' flops (and the forward's epilogue over a) at the float32
     peak, or the bytes; then one line each with the adjoint and the
     forward at the three shapes of their bounds tables ([afn-pcg-256]'s
     float32 table at 2P = 256, [wide-train]'s bf16 table at 128 and
     doubling slab at 130; nv = 1, 10; nsets = 1, 2, 10, 20): time, plain,
     library, bound with its unit, share; a shape that did not run fails;
     in 3, 4 and 4b the limit is a relative Frobenius error <= 1e-4 (two f32
     sums over 2e5 terms in different orders, about sqrt(n) eps); times
     from CUDA events around back-to-back calls queued behind a sleep
     kernel (`cuda_ms`: the card's time, not the host's time to issue);
  5. main: GPProblem(fastsum + Nystrom, gaussian, stream engine).fit for 3
     Adam steps at n = 2e5; every loss finite and both table kernels
     launched during the fit, their launches printed by shape (nv, nsets);
  5b. sharded: the row-sharded train step of parallel/ (NCCL, world 1, a
     file:// store) at [main]'s configuration: make_sharded_train_step
     (gaussian, Nystrom 50, engine "stream", bf16 tables), 3 Adam steps on
     the rank's shard from [main]'s start, probes and landmarks, s per step
     and losses beside [main]'s, the bf16 table kernels' launches by shape
     (both > 0: the rank's own table); then one step at (f, l, mu) =
     (1, 0.5, 1) against GPProblem(fastsum_engine="stream").make_loss at
     the same raw parameters, probes and landmarks (loss rtol 1e-4,
     gradient rtol 2e-2 / atol 2e-3, both gaps printed).  Not held at
     [main]'s mu = 0.1: there FGMRES stops unconverged and the float32
     loss moves by about 1e-4 under any rounding-level change; the line
     prints that yardstick (GPProblem's loss with y scaled by 1 + 1e-7
     noise, against [main]'s first loss) beside the first step's gap;
  5c. sharded-m12: matern12 at n = 2e4 with the lower-triangular KNN
     near-field (its transpose through the reduce-scatter) and AFN (rank
     100, lfil 16, one plan), engine "stream", world 1: one step against the
     same step on one device without the process group (the single-device
     stream engine, the same KNN near-field and plan), at (f, l, mu) =
     (1, 0.5, 1) (the matern12 float32 caveat of 8); limits as in 5b;
  6. agree: at n = 2e4, the streamed kernels against the torch table engine
     (loss rtol 4e-2, gradient rtol 2e-1 / atol 2e-2: the engines differ by
     the trimmed Nyquist mode and bf16 table rounding);
  7. fused: GPProblem(matern12, WINDOWS_FUSED, fastsum_fused=True).fit for 3
     Adam steps at n = 2e5: the KNN near-field built once (its form and row
     widths printed), the 3-feature window on the table path; every loss
     finite and both regenerating kernels launched during the fit, their
     launches printed by shape;
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

  9. dense-kernels: the cooperative CG and Lanczos kernels of
     csrc/fused_pcg.cu through their entry points (fused_pcg_dense,
     fused_lanczos_dense) on the additive gaussian K of make_data's points
     and WINDOWS, float32, n = 2048 and 4096, right-hand side y: CG at
     (f, l, mu) = (1, 0.5, 0.1) and (1, 0.5, 0.01), maxits 200, tol 1e-5;
     Lanczos with 10 Rademacher probes and 10 steps at mu = 0.1.  Limits,
     against the plain versions on the same inputs: where the plain CG
     stops early the kernel stops early too, with relres <= tol, a float64
     true residual <= 10 tol and niter within max(2, 10%) of the plain
     niter (float32 CG on a spectrum clustered at mu amplifies rounding, so
     two summation orders stop a few steps apart: 87 against 82 at
     n = 2048, mu = 0.1 on an NVIDIA H100 80GB HBM3 at 700 W); where the
     plain CG reaches maxits, the kernel's true
     residual is at most 2x the plain one's.  Lanczos alpha, beta, beta0
     within 1e-4 of max|alpha|, V within 1e-3 relative Frobenius (float32
     products over n = 4096 and 10 steps of CGS2 in other orders), and the
     SLQ logdet from its tridiagonals within 1e-4 relative of the port's
     slq_logdet on the same probes.  A second launch of each is bitwise
     equal to the first.  Each line also gives the launched plan's bytes of
     K held in shared memory and streamed a step, the grid barriers a step
     (CG 1, Lanczos 3), the measured microseconds of one (`barrier_us`: the
     counter barrier the kernels use, timed by the barrier probe at the
     plan's blocks, threads and shared memory) and the barrier floor (steps
     x barriers a step x that); these plan facts stay on the text line, the
     `kernels` line carries the measured `barrier_probe_us`.  Also the
     torch engines' time (`engine_ms`: solvers/pcg.py, lanczos_batch) and,
     for Lanczos, "product alone": steps x one torch.mm of (nv, n) x (n, n);
 10. dense-fit: GPProblem(gaussian, WINDOWS, operator="dense",
     precond="chol").fit for 3 Adam steps at n = 4096; every loss finite;
 11. stream-m12: GPProblem(matern12, WINDOWS_FUSED) with no engine argument
     (its defaults pick the stream engine on CUDA tensors).fit for 3 Adam
     steps at n = 1.6e5 (at 2e5 the 1-D window's grid would need more than
     the 2^15 cells build_cell_grid allows, and both packages then keep the
     KNN near-field on every window; checked): the radius near-field on the
     four windows of one or
     two features (per window the grid's cells, capacity, radius, in-radius
     pairs and bytes, beside the bytes of the JAX package's dense stencil),
     the KNN near-field's row width on [0, 1, 2]; every loss finite, both
     table kernels launched, their launches printed by shape; the
     near-field's value build and apply timed on the card;
 12. agree-stream-m12: at n = 2e4 and (f, l, mu) = (1, 0.5, 1), the radius
     near-field's K and dK/dl products on the card (float32) against the
     same calls on CPU float64 copies of the points, relative Frobenius
     error <= 5e-5 (float32 against float64 on the CPU: 1.7e-5; the values
     are small differences of O(1) terms), and the stream loss and gradient
     on the card with float32 tables against the stream engine's plain
     versions on CPU float64, with the same probes, landmarks and
     3-feature KNN pattern; both sides must build the radius near-field on
     the four windows of one or two features (limits as in 8; the grid is
     continuous in the points, so both sides build the same matrix to
     rounding);
 13. predict: [main]'s fitted problem at n = 2e5, the mean at 2000 test
     points and the std at 16 (one std_chunk); [stream-m12]'s problem, the
     mean at 2000 points (n > 20000: the fastsum branch and its warning);
     and at n = 2e4 with (f, l, mu) = (1, 0.5, 0.1), the fastsum predictor
     against the dense one, relative L2 gap of the mean <= 5e-3 and of the
     std <= 5e-4 (tests/test_torch_predict.py measured 3.7e-4 / 1.8e-5 at
     n = 1000, rising to 1.08e-3 / 8.1e-5 at n = 8000); values finite, std
     > 0, seconds printed;
 14. full: GPProblem(gaussian, windows=None) on the first two features at
     n = 2e5, 2 Adam steps, then the mean at 256 points; all finite;
 15. afn: GPProblem(matern12, WINDOWS_FUSED, precond="afn", rank=200,
     lfil=16) on the stream engine (bf16 tables, radius near-field) at
     n = 1.6e5, fit(init=(1, 0.1, 0.01), adam_maxits=3, replan_every=2):
     both plans on the AFN branch (k, use_ran and seconds of each), the
     seconds and repaired Schur rows of every factorization, seconds per
     step, one AFN dvp and solve over 10 probes, peak memory, both table
     kernels launched (by shape); then the mean at 2000 points (AFN planned
     at (1, 1, 0.1), as in the JAX package);
 16. agree-afn: at n = 2e4 and (f, l, mu) = (1, 0.1, 1), one plan made on
     the CPU (force_afn, rank 200) and the same probes on both sides: the
     AFN solve and dvp over 10 probes (relative Frobenius <= 5e-3), the
     stream loss (float32 tables; relative gap <= 5e-4) and gradient (rtol
     1e-2 / atol 1e-3) on the card against CPU float64 (the stream engine's
     plain versions); CPU float32 against float64 measured 4.3e-4 / 3.0e-4 /
     1.3e-5 and gradient entries within 1e-6 (PERF.md);
 17. afn-pcg: K x = y by the port's pcg to relres 1e-2 (at most 400
     iterations) on matern12, the first two features and the window
     [0, 1], (f, l, mu) = (1, 0.1, 0.01), n = 1e5, float32 tables
     (csrc/packed_ndft.cu): no
     preconditioner, Nystrom (200 landmarks), AFN (maxrank 200, lfil 16);
     iterations, final relres, set-up and solve seconds; AFN must converge,
     and the float32-table kernels' launches of its solve are read and
     printed by shape;
 17b. afn-pcg-256: AFN_PCG.md section 3's row at its full size through
     scripts/torch_afn_pcg_bench.py's functions: n = 1e5, d = 2, matern12,
     (f, l, mu) = (1, 0.1, 0.01), N = 256 (float32 tables at 2P = 256 on the
     wide kernels), the radius near-field of nf_lfil 128, psd_clip, a
     solve-only plan, compensated FGMRES reductions, replace_every 25, PCG
     to 1e-2 in at most 400 iterations with none, Nystrom (rank 200) and AFN
     (rank 200, lfil 16); iterations, relres, set-up, solve and
     per-iteration seconds, the table and near-field bytes, one matvec and
     one AFN solve on the card, the wide kernels' launches by shape (the
     narrow table kernels' must be 0); AFN must converge; the JAX
     package's 13 iterations (AFN_PCG_1e5_m12_f32.json) printed beside;
 17b'. many-windows: more windows than one launch takes, at n = 2e4 through
     GPProblem on the card: d = 66 as 33 2-D windows (gaussian, stream
     engine, bf16 tables at 2P = 32) and d = 65 as 65 1-D windows
     (matern12, fused engine, 2P = 34), one loss and gradient each against
     the torch table engine on the card (limits of 6 and 8); before each,
     its kernel wrappers at its shapes (the bf16-table pair at 33 pairs,
     the regenerating pair at 65 singles; nv = 1, 10, nsets = 1, 2, 10, 20)
     against their plain versions (1e-4; the regenerating ones in float64),
     a second call bitwise equal; every kernel wrapper launches twice a
     call (two window groups);
 17c. wide-train: GPProblem(matern12, WINDOWS, fastsum_N=128) at n = 1e5,
     2 Adam steps on the stream engine (bf16 tables, 2P = 128, radius
     near-field) and 2 with fastsum_fused=True (2P = 130); losses finite,
     the wide kernels launched (by shape); at n = 5e3 and (1, 0.5, 1) both
     engines' losses and gradients on the card against their plain
     versions on CPU float64 (limits of 8 and 12);
 18. fsai: GPProblem(gaussian, WINDOWS, precond="fsai", lfil=16) on the
     stream engine at n = 2e5, 2 Adam steps; losses finite;
 19. cli: the port's CLI as a subprocess on the card (--precond afn
     --adam-maxits 2) on synthetic files in the reference's text formats
     (n = 2e4 train, 2000 test points, WINDOWS as the 'g' windows, in a
     temporary directory); exit 0 and a finite RMSE.

Every kernel case also times one PyTorch call that computes the same
function from the same inputs (`library_ms`; the port never calls it): for
the NDFT kernels one torch.einsum per window family over the gathered rows
of a float32 phase table made outside the timed region (for the
regenerating kernels the phases are made there too), for CG
torch.linalg.solve; Lanczos has none.  Each kernel's bound is the larger of
its operations over the peak of the unit that runs them and its bytes (each
input read once, each output written once) over 3.35 TB/s.  The
tensor-core kernels' 2-D window products count three times (the three bf16
terms of the float32 operand over the 989 TFLOP/s bf16 peak for the table
kernels, 3xTF32 over the 495 TFLOP/s dense TF32 peak for the regenerating
ones and the wide pair; twice for the wide pair on a bf16 table,
whose values are exact in tf32); their CUDA-core flops (the 1-D windows,
the forwards' epilogue) over the 67 TFLOP/s float32 peak run beside them,
so the operations take the larger of the two times; the other kernels'
flops count over the float32 peak (on the CUDA cores alone, the sum); the
H100 SXM's published peaks at 700 W.  Each entry of the kernels JSON names
the units its operations run on
(`engine`); the wide pair's entries are its float32-table cases at
[afn-pcg-256]'s shape (2P = 256, nv = nsets = 1) with that solve's
launches, its launches by shape in [wide-train] and its times at
[wide-train]'s shapes in [kernels-wide]; the narrow bf16-table and
regenerating pairs' also carry their launches in [many-windows]; the
float32-table pair's are its [afn-pcg] shape (one pair, 2P = 32, nv =
nsets = 1; ms cold, ms_warm and the table's cold read beside) with that
solve's launches, and its times and the wide pair's at every [kernels]
float32 shape.

A `[done]` line gives the script's wall seconds from its start to the
summary, and each phase's.  The line before the last is a JSON summary of the kernels; the
last line is {"ok": true, "device": {...}}.  Without CUDA the script exits
non-zero.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

_T0 = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

N_POINTS = 200_000
N_AGREE = 20_000
# the matern12 stream run: its 1-D window's cell grid (about n / 5.33 cells,
# lfil 16) stays under build_cell_grid's 2^15-cell cap up to n = 1.74e5
N_STREAM_M12 = 160_000
DIM = 10
WINDOWS = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]]
WINDOWS_1D = [[0, 1], [2, 3], [4]]
WINDOWS_FUSED = [[0, 1, 2], [3, 4], [5, 6], [7, 8], [9]]
FASTSUM_N = 32
KERNEL_RTOL = 1e-4
PKG = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu"
SOURCES = {"table": f"{PKG}_torch/csrc/packed_ndft_tc.cu", "table_f32": f"{PKG}_torch/csrc/packed_ndft.cu",
           "regen": f"{PKG}_torch/csrc/packed_ndft_regen.cu", "wide": f"{PKG}_torch/csrc/packed_ndft_wide.cu",
           "fused": f"{PKG}_torch/csrc/fused_pcg.cu"}
TPU_KERNELS = {"adjoint": f"{PKG}/ops/pallas_ndft.py:189", "forward": f"{PKG}/ops/pallas_ndft.py:361",
               "pcg": f"{PKG}/solvers/pallas_pcg.py:36", "lanczos": f"{PKG}/solvers/pallas_pcg.py:174"}
# H100 SXM published peaks at its 700 W limit: float32 outside the tensor
# cores, bf16 and TF32 on the tensor cores (dense), and HBM3 bandwidth
F32_PEAK = 67e12
BF16_PEAK = 989e12
TF32_PEAK = 495e12
HBM_PEAK = 3.35e12
# the units a kernel's operations run on, and their rate: the CUDA cores, or
# three passes on the tensor cores (bf16: the three-term split of a float32
# operand; tf32: 3xTF32, big*big + big*small + small*big)
PEAKS = {"f32": F32_PEAK, "f32_tma": F32_PEAK, "bf16x3": BF16_PEAK / 3, "tf32x3": TF32_PEAK / 3,
         "wgmma_tf32x3": TF32_PEAK / 3, "wgmma_tf32x2": TF32_PEAK / 2}
CUDA_CORE_UNITS = ("f32", "f32_tma")
ENGINES = {"f32": "CUDA cores",
           "f32_tma": "CUDA cores fed by a TMA ring, every consumer warp busy at one right-hand side or weight set "
                      "(csrc/packed_ndft.cu); the 1-D windows of the adjoint on a CUDA-core template",
           "bf16x3": "tensor cores, mma.sync bf16, 3-term split of the float32 operand",
           "tf32x3": "tensor cores, mma.sync m16n8k8 3xTF32; the Nyquist mode's columns (adjoint) or rows "
                     "(forward), the forward's epilogue and the 1-D windows on the CUDA cores",
           "wgmma_tf32x3": "tensor cores, wgmma m64nNk8 3xTF32 fed by TMA (2-D windows); the 1-D windows on the "
                           "CUDA cores",
           "wgmma_tf32x2": "tensor cores, wgmma m64nNk8 TF32, two products (a bf16 table is exact in tf32; 2-D "
                           "windows); the 1-D windows on the CUDA cores"}
DENSE_NS = (2048, 4096)
DENSE_MUS = (0.1, 0.01)
PCG_MAXITS, PCG_TOL = 200, 1e-5
SLQ_NV, SLQ_ITS = 10, 10
# clock cycles of the sleep kernel that holds the stream while a timed batch
# is enqueued (about 20 ms on an H100)
SLEEP_CYCLES = 40_000_000
# bytes of each of the two scratch buffers of a cold timing (cuda_ms(cold=True)):
# past the H100's 50 MB L2
FLUSH_BYTES = 64 << 20


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


def cuda_ms(fn, reps=10, warmup=2, batches=3, cold=False):
    """Milliseconds of one fn() on the card: the median over `batches` of
    CUDA events around `reps` back-to-back calls, enqueued behind a sleep
    kernel so that the host's time to issue them does not count (where fn
    itself waits for the card, its host time still shows).

    cold: the 50 MB L2 is flushed before every call -- FLUSH_BYTES of
    scratch written, then another FLUSH_BYTES read, so that the call finds
    none of its inputs in L2 and no dirty line of the flush is left to be
    written back while it runs -- and each call has its own event pair, so
    the flush is not timed: the median over all calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if cold:
        flush = [torch.ones(FLUSH_BYTES // 4, device="cuda") for _ in range(2)]
        times = []
        for _ in range(batches):
            events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)] for _ in range(reps)]
            torch.cuda._sleep(SLEEP_CYCLES)
            for start, stop in events:
                flush[0].zero_()
                flush[1].sum()
                start.record()
                fn()
                stop.record()
            torch.cuda.synchronize()
            times += [start.elapsed_time(stop) for start, stop in events]
        return float(np.median(times))
    times = []
    for _ in range(batches):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return float(np.median(times))


def _rel_err(got, want):
    got = torch.cat([g.reshape(-1) for g in got])
    want = torch.cat([w.reshape(-1) for w in want])
    diff = (got - want).double()
    return float(torch.linalg.norm(diff) / torch.linalg.norm(want.double())), float(diff.abs().max())


def bound(flops, nbytes, unit="f32", f32_flops=0.0):
    """(ms, "operations" | "bytes"): the least time the card could take;
    flops on `unit` (a key of PEAKS) and f32_flops on the CUDA cores, each
    over its own peak: two units run side by side, so the larger time; on
    the CUDA cores alone the sum."""
    if unit in CUDA_CORE_UNITS:
        t_ops = (flops + f32_flops) / F32_PEAK * 1e3
    else:
        t_ops = max(flops / PEAKS[unit], f32_flops / F32_PEAK) * 1e3
    t_bytes = nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def library_calls(T, pairs, singles):
    """The yardstick: one torch.einsum per window family over the gathered
    rows of a float32 phase table T (Dtot, 2P, n) made outside the timed
    region.  Returns (adjoint(alpha) -> (A2, A1), forward(G2s, G1s) -> y)."""
    L0, L1 = T[[a for a, _ in pairs]], T[[b for _, b in pairs]]
    Ls = T[list(singles)]

    def adj(alpha):
        A2 = torch.einsum("wpi,ri,wqi->rwpq", L0, alpha, L1) if pairs else alpha.new_zeros(0)
        A1 = torch.einsum("wpi,ri->rwp", Ls, alpha) if singles else alpha.new_zeros(0)
        return A2, A1

    def fwd(G2s, G1s):
        y = torch.einsum("wpi,swpq,wqi->si", L0, G2s, L1) if pairs else 0.0
        return y + torch.einsum("kpi,skp->si", Ls, G1s) if singles else y

    return adj, fwd


def check_pair(tag, names, adj, adj_plain, fwd, fwd_plain, lay, P, X, nvs, nsets_list, timed, T32, src_bytes,
               units=("f32", "f32"), repeat=False, label=None, adj_ref=None, fwd_ref=None, cold=False,
               beside=None, route=None, read=None):
    """One adjoint kernel and one forward kernel against their plain versions.

    adj(alpha) / fwd(G2, G1) are the wrappers on one layout; adj_plain /
    fwd_plain the plain versions; T32 the float32 phases of the layout for
    the library yardstick; src_bytes the bytes of the kernels' phase source
    (table or coordinates); units: the PEAKS keys of the adjoint's and of
    the forward's 2-D window products (the adjoint's 1-D windows, the
    forward's epilogue over a and its 1-D windows count on the CUDA cores),
    or units(op, count) -> the key of the kernel that runs the case;
    repeat: a second launch must be bitwise equal to the first; label: the
    printed phase tag; adj_ref / fwd_ref: the references of the error when
    they are not the plain versions (the regenerating kernels' plain
    versions in float64); cold: where the bytes bound a case and its inputs
    fit the L2, its times are also taken with the L2 flushed before every
    call (`cuda_ms(cold=True)`), and ms and the share are those (ms_warm
    the warm time); beside: (adjoint, forward) of another kernel on the
    same inputs, returning the plain versions' outputs (stacked), held
    against the same reference and repeated bitwise as the case, then timed
    as the case (beside_ms); route(op, count): the kernel the wrappers'
    route rule picks, printed; read: a library call that reads the phase
    source once (a yardstick of the cold read), timed as the case (read_ms).
    Returns per-case dicts (kernel, mode, shape, rel, max_abs, ms, ms_warm,
    plain_ms, library_ms, beside_ms, beside_rel, read_ms, bound_ms,
    bound_by, bitwise, engine, route)."""
    n, dev = X.shape[0], X.device
    W2 = 2 * P
    npairs, nsingles = len(lay.pairs), len(lay.singles)
    lib_adj, lib_fwd = library_calls(T32, lay.pairs, lay.singles)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = []
    unit = units if callable(units) else lambda op, count: units[op == "forward"]
    for nv in nvs:
        alpha = torch.randn((nv, n), generator=gen, device=dev)
        got = adj(alpha)
        again = adj(alpha) if repeat else got
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for gs, hs in zip(got, again) for u, v in zip(gs, hs))
        want = (adj_ref or adj_plain)(alpha)
        want_flat = [w for w in want if w.numel()]
        rel, mx = _rel_err([torch.stack(g, dim=1) for g in got if g], want_flat)
        lib_rel, _ = _rel_err([w for w in lib_adj(alpha) if w.numel()], want_flat)
        side = None if beside is None else _beside_check(lambda: [w for w in beside[0](alpha) if w.numel()],
                                                         want_flat)
        out = nv * (npairs * W2 * W2 + nsingles * W2)
        nbytes = src_bytes + 4 * (nv * n + out)
        u = unit("adjoint", nv)
        b_ms, b_by = bound(2.0 * n * nv * npairs * W2 * W2, nbytes, u, f32_flops=2.0 * n * nv * nsingles * W2)
        times = _case_times(timed, cold and b_by == "bytes" and nbytes <= L2_BYTES,
                            [lambda: adj(alpha), lambda: adj_plain(alpha), lambda: lib_adj(alpha),
                             None if beside is None else lambda: beside[0](alpha), read])
        cases.append(dict(kernel=names[0], shape=f"nv={nv}", rel=rel, max_abs=mx, lib_rel=lib_rel, **times,
                          bound_ms=b_ms, bound_by=b_by, bitwise=bitwise, engine=ENGINES[u], beside=side,
                          route=route("adjoint", nv) if route else None))

    # realistic combined weights: K and dK/dl sets of real adjoint outputs
    from nfft4gp_torch.ops import fastsum as fs

    alpha = torch.randn((-(-max(nsets_list) // 2), n), generator=gen, device=dev)
    A2, A1 = adj_plain(alpha)
    G2all = [torch.stack([fs._folded_combine(W[i], A2[:, i], 2) for W in (lay.w2, lay.dw2)], 1)
             .reshape(-1, W2, W2) for i in range(npairs)]
    G1all = [torch.stack([fs._folded_combine(W[i], A1[:, i], 1) for W in (lay.w1, lay.dw1)], 1)
             .reshape(-1, W2) for i in range(nsingles)]
    for nsets in nsets_list:
        G2 = [g[:nsets].contiguous() for g in G2all]
        G1 = [g[:nsets].contiguous() for g in G1all]
        got = fwd(G2, G1)
        again = fwd(G2, G1) if repeat else got
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
        G2s = torch.stack(G2, 1) if G2 else None
        G1s = torch.stack(G1, 1) if G1 else None
        want = (fwd_ref or fwd_plain)(G2s, G1s)
        rel, mx = _rel_err(got, [want])
        lib_rel, _ = _rel_err([lib_fwd(G2s, G1s)], [want])
        side = None if beside is None else _beside_check(lambda: [beside[1](G2s, G1s)], [want])
        weights = nsets * (npairs * W2 * W2 + nsingles * W2)
        nbytes = src_bytes + 4 * (weights + nsets * n)
        u = unit("forward", nsets)
        b_ms, b_by = bound(2.0 * nsets * n * npairs * W2 * W2, nbytes, u,
                           f32_flops=2.0 * nsets * n * (npairs + nsingles) * W2)
        times = _case_times(timed, cold and b_by == "bytes" and nbytes <= L2_BYTES,
                            [lambda: fwd(G2, G1), lambda: fwd_plain(G2s, G1s), lambda: lib_fwd(G2s, G1s),
                             None if beside is None else lambda: beside[1](G2s, G1s), read])
        cases.append(dict(kernel=names[1], shape=f"nsets={nsets}", rel=rel, max_abs=mx, lib_rel=lib_rel, **times,
                          bound_ms=b_ms, bound_by=b_by, bitwise=bitwise, engine=ENGINES[u], beside=side,
                          route=route("forward", nsets) if route else None))

    for c in cases:
        c["mode"], c["tag"] = tag.split(" ")[0], tag
        print(f"[{label or ('kernels-regen' if names[0].endswith('regen') else 'kernels')}] {tag} {c['kernel']} "
              f"{c['shape']}: rel_err={c['rel']:.3e} max_abs_err={c['max_abs']:.3e} ms={c['ms']} "
              f"plain_ms={c['plain_ms']} library_ms={c['library_ms']} (einsum rel_err={c['lib_rel']:.1e}) "
              f"bound_ms={c['bound_ms']:.4f} ({c['bound_by']})"
              + (f" share_of_bound={c['bound_ms'] / c['ms']:.3f}" if c["ms"] else "")
              + (f" (L2 flushed; warm ms={c['ms_warm']})" if c["ms_warm"] is not None else "")
              + (f" beside_ms={c['beside_ms']}" if c["beside_ms"] is not None else "")
              + (f" beside_rel_err={c['beside'][0]:.3e} beside_bitwise_repeat={c['beside'][1]}" if c["beside"] else "")
              + (f" read_ms={c['read_ms']}" if c["read_ms"] is not None else "")
              + (f" route={c['route']}" if c["route"] else "")
              + (f" bitwise_repeat={c['bitwise']}" if repeat else ""), flush=True)
        if not c["bitwise"]:
            raise AssertionError(f"{c['kernel']} {tag} {c['shape']}: a second launch differs")
        if not c["rel"] <= KERNEL_RTOL:
            raise AssertionError(f"{c['kernel']} {tag} {c['shape']} disagrees with its plain version: {c['rel']}")
        if c["beside"] and not (c["beside"][0] <= KERNEL_RTOL and c["beside"][1]):
            raise AssertionError(f"the kernel beside {c['kernel']} {tag} {c['shape']} disagrees with the plain "
                                 f"version or with its second launch: {c['beside']}")
        if not c["lib_rel"] <= KERNEL_RTOL:
            raise AssertionError(f"the einsum yardstick of {c['kernel']} {tag} {c['shape']} computes "
                                 f"another function: {c['lib_rel']}")
    return cases


# bytes of the H100's L2: inputs up to it are also timed cold in check_pair
L2_BYTES = 50e6


def _beside_check(call, want):
    """(relative error against want, bitwise equal on a second call) of
    the kernel beside a check_pair case."""
    got, again = call(), call()
    torch.cuda.synchronize()
    return _rel_err(got, want)[0], all(torch.equal(u, v) for u, v in zip(got, again))


def _case_times(timed, cold, fns):
    """ms, ms_warm, plain_ms, library_ms, beside_ms, read_ms of one
    check_pair case from fns = [kernel, plain, library, beside or None, read
    or None]: cuda_ms warm, and for the kernel, beside and read cold instead
    when `cold` (ms_warm then the kernel's warm time)."""
    if not timed:
        return dict(ms=None, ms_warm=None, plain_ms=None, library_ms=None, beside_ms=None, read_ms=None)
    kern, plain, lib, other, read = fns
    out = dict(ms=cuda_ms(kern), ms_warm=None, plain_ms=cuda_ms(plain), library_ms=cuda_ms(lib))
    if cold:
        out.update(ms_warm=out["ms"], ms=cuda_ms(kern, cold=True))
    for key, fn in (("beside_ms", other), ("read_ms", read)):
        out[key] = None if fn is None else cuda_ms(fn, cold=cold)
    return out


def _plan(X, windows, N=FASTSUM_N):
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    params = KernelParams.make(1.0, 0.5, 0.1, dtype=torch.float32, device=X.device)
    return fs.additive_fastsum_build("gaussian", params, X, make_windows(windows), N=N)


def check_kernels(X, windows, nvs, nsets_list, timed=True):
    """The bf16-table kernels (the tensor-core ones of csrc/packed_ndft_tc.cu)
    against their plain versions (2P = 32)."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    pn = fs.packed_ndft_plan(_plan(X, windows), table_dtype=torch.bfloat16)
    Tp, pairs, singles = pn.Tp, pn.pairs, pn.singles
    return check_pair(
        f"table-bf16 windows={windows} n={X.shape[0]}", ("packed_adjoint", "packed_forward"),
        lambda a: pk.packed_adjoint(Tp, a, pairs=pairs, singles=singles),
        lambda a: pk.packed_adjoint_plain(Tp, a, pairs, singles),
        lambda G2, G1: pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles),
        lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, singles),
        pn, pn.P, X, nvs, nsets_list, timed, Tp.float(), Tp.numel() * Tp.element_size(),
        units=("bf16x3", "bf16x3"), repeat=True)


# the float32-table cases ([kernels]): 2P, the layouts at n = N_AFN_PCG
# ([afn-pcg]'s one pair; the AFN-PCG bench's default d = 10, five 2-D
# windows) and the adjoint's right-hand sides / the forward's weight sets
F32_WIDTHS = (16, 32)
F32_LAYOUTS = {"1pair": [[0, 1]], "5pairs": WINDOWS}
F32_NVS, F32_NSETS = (1, 10), (1, 2, 10, 20)
# the unit (PEAKS) of each kernel that `table_route` may pick for them
F32_UNITS = {"f32": "f32_tma", "wide": "wgmma_tf32x3"}


def check_f32_kernels(X):
    """The float32-table kernels through the wrappers (`packed_adjoint` /
    `packed_forward`: csrc/packed_ndft.cu, or the wide pair where
    `table_route` sends a count past its cut-over) against their plain
    versions at 2P = 16 and 32, one pair and five, n = N_AFN_PCG: nv = 1,
    10 and nsets = 1, 2, 10, 20; a second launch bitwise equal; the shapes
    bound by bytes whose inputs fit the L2 timed cold; each case's bound
    and engine those of the kernel the route picks (CUDA cores, or the wide
    pair's wgmma in 3xTF32); the wide pair on the same inputs beside each
    case, held against the plain version and timed (beside_ms); a sum of
    the table (torch.sum, one read of it) timed as the case (read_ms).
    Returns the case dicts, mode "table-f32@2P=..-<layout>"."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    Xn = X[:N_AFN_PCG]
    cases = []
    for lname, windows in F32_LAYOUTS.items():
        d = 1 + max(max(w) for w in windows)
        for W2 in F32_WIDTHS:
            pn = fs.packed_ndft_plan(_plan(Xn[:, :d].contiguous(), windows, N=W2), table_dtype=torch.float32)
            Tp, pairs = pn.Tp, pn.pairs
            cases += check_pair(
                f"table-f32@2P={W2}-{lname} windows={windows} n={Xn.shape[0]}", ("packed_adjoint", "packed_forward"),
                lambda a: pk.packed_adjoint(Tp, a, pairs=pairs),
                lambda a: pk.packed_adjoint_plain(Tp, a, pairs, ()),
                lambda G2, G1: pk.packed_forward(Tp, G2, G1, pairs=pairs),
                lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, ()),
                pn, pn.P, Xn, F32_NVS, F32_NSETS, True, Tp, Tp.numel() * Tp.element_size(),
                units=lambda op, count: F32_UNITS[pk.table_route(W2, torch.float32, op, count)],
                repeat=True, cold=True,
                beside=(lambda a: pk._adjoint_wide(Tp, a, pairs, ()),
                        lambda G2s, G1s: pk._forward_wide(Tp, *pk._dense_stacks(G2s, None, W2, Tp.device), pairs,
                                                          ())),
                route=lambda op, count: pk.table_route(W2, torch.float32, op, count), read=Tp.sum)
    return cases


def check_regen_kernels(X, nvs=(1, 10), nsets_list=(1, 2, 10, 20)):
    """The regenerating kernels against their plain versions on the d <= 2
    windows of WINDOWS_FUSED, untrimmed (2P = 34), both phase sources, both
    on the tensor cores (3xTF32); a second launch must be bitwise equal."""
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
            lay, P, X, nvs, nsets_list, True, pk.phase_slab(xT, P, gen), xT.numel() * xT.element_size(),
            units=("tf32x3", "tf32x3"), repeat=True)
    return cases


WIDE_TABLE_WIDTHS = (64, 128, 256)
WIDE_REGEN_WIDTHS = (130, 258)
# fastsum_N of [wide-train]: 2P = 128 on its bf16 tables, 130 regenerating
WIDE_TRAIN_N = 128
N_WIDE_TRAIN = 100_000
# the units of the wide pair's 2-D window products (PEAKS) by table type
WIDE_UNIT = {torch.float32: "wgmma_tf32x3", torch.bfloat16: "wgmma_tf32x2"}
# the shapes of the wide pair's bounds tables: (mode, where in the tag)
WIDE_BOUND_SHAPES = {"afn-pcg-256 f32 1 pair 2P=256": ("table-f32@2P=256", "windows=[[0, 1]] "),
                     "wide-train bf16 5 pairs 2P=128": ("table-bf16@2P=128", f"windows={WINDOWS}"),
                     "wide-train doubling slab 5 pairs 2P=130": ("doubling@2P=130", f"windows={WINDOWS}")}


def check_wide_kernels(X):
    """[kernels-wide]: the wide pair (csrc/packed_ndft_wide.cu, 2-D windows
    on wgmma in 3xTF32; the regenerating sources through a float32 phase
    slab) against its plain versions, through the wrappers at widths only
    it serves.  At [afn-pcg-256]'s shape (the first N_AFN_PCG points, the
    window [0, 1]): float32 and bf16 tables at 2P = 64, 128, 256 (nv = 1,
    10; nsets = 1, 2, 10, 20), a 1-D window beside it (2P = 128, untimed), both
    regenerating sources at 2P = 130, 258 against the plain versions in
    float64 (nv = 1, 10; nsets = 1, 2, 20).  At [wide-train]'s shape (the
    first N_WIDE_TRAIN points, the five 2-D windows of WINDOWS): the bf16
    table at 2P = 128 and both regenerating sources at 2P = 130, nv = 1, 10
    and nsets = 1, 2, 10, 20, the launch mix of its Adam steps.  And at
    2P = 32 the wide pair (its private entry) beside the narrow kernels on
    the same inputs.  A second launch of each is bitwise equal; no narrow
    kernel launches at the wide widths.  Returns the case dicts."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    names = ("packed_adjoint_wide", "packed_forward_wide")
    narrow = (pk.packed_adjoint, pk.packed_forward, pk.packed_adjoint_regen, pk.packed_forward_regen)
    narrow_before = [fn.launches for fn in narrow]
    Xa = X[:N_AFN_PCG, :3].contiguous()
    Xt = X[:N_WIDE_TRAIN]
    cases = []

    def tables(Xw, windows, W2, dtype, nvs, nsets, timed=True):
        pn = fs.packed_ndft_plan(_plan(Xw, windows, N=W2), table_dtype=dtype)
        Tp, pairs, singles = pn.Tp, pn.pairs, pn.singles
        tag = f"table-{'bf16' if dtype == torch.bfloat16 else 'f32'}@2P={W2} windows={windows} n={Xw.shape[0]}"
        return check_pair(
            tag, names,
            lambda a: pk.packed_adjoint(Tp, a, pairs=pairs, singles=singles),
            lambda a: pk.packed_adjoint_plain(Tp, a, pairs, singles),
            lambda G2, G1: pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles),
            lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, singles),
            pn, pn.P, Xw, nvs, nsets, timed, Tp.float(), Tp.numel() * Tp.element_size(), repeat=True,
            label="kernels-wide", units=(WIDE_UNIT[dtype], WIDE_UNIT[dtype]))

    def regen(Xw, windows, W2, gen, nvs, nsets):
        lay = fs._packed_layout(_plan(Xw, windows, N=W2 - 2))
        P = fs._nmodes(W2 - 2)
        xT, pairs, singles = lay.xT, lay.pairs, lay.singles
        kw = dict(P=P, pairs=pairs, singles=singles, phase_gen=gen)
        return check_pair(
            f"{gen}@2P={W2} windows={windows} n={Xw.shape[0]}", names,
            lambda a: pk.packed_adjoint_regen(xT, a, **kw),
            lambda a: pk.packed_adjoint_regen_plain(xT, a, P, pairs, singles, gen),
            lambda G2, G1: pk.packed_forward_regen(xT, G2, G1, **kw),
            lambda G2s, G1s: pk.packed_forward_regen_plain(xT, G2s, G1s, P, pairs, singles, gen),
            lay, P, Xw, nvs, nsets, True, pk.phase_slab(xT, P, gen), xT.numel() * xT.element_size(),
            repeat=True, label="kernels-wide", units=(WIDE_UNIT[torch.float32], WIDE_UNIT[torch.float32]),
            adj_ref=lambda a: pk.packed_adjoint_regen_plain(xT.double(), a.double(), P, pairs, singles, gen),
            fwd_ref=lambda G2s, G1s: pk.packed_forward_regen_plain(
                xT.double(), G2s.double(), None if G1s is None else G1s.double(), P, pairs, singles, gen))

    for dtype in (torch.float32, torch.bfloat16):
        for W2 in WIDE_TABLE_WIDTHS:
            cases += tables(Xa, [[0, 1]], W2, dtype, (1, 10), (1, 2, 10, 20))
    cases += tables(Xa, [[0, 1], [2]], 128, torch.float32, (1, 10), (1, 20), timed=False)
    for W2 in WIDE_REGEN_WIDTHS:
        for gen in pk.PHASE_GENS:
            cases += regen(Xa, [[0, 1]], W2, gen, (1, 10), (1, 2, 20))
    # [wide-train]'s shapes
    cases += tables(Xt, WINDOWS, WIDE_TRAIN_N, torch.bfloat16, (1, 10), (1, 2, 10, 20))
    for gen in pk.PHASE_GENS:
        cases += regen(Xt, WINDOWS, WIDE_TRAIN_N + 2, gen, (1, 10), (1, 2, 10, 20))
    if [fn.launches for fn in narrow] != narrow_before:
        raise AssertionError("kernels-wide: a narrow kernel served a wide width")
    # 2P = 32: the wide pair and the narrow bf16-table kernels on the same
    # inputs (the float32 table's are in [kernels])
    for dtype in (torch.bfloat16,):
        pn = fs.packed_ndft_plan(_plan(Xa, [[0, 1]], N=32), table_dtype=dtype)
        Tp, pairs = pn.Tp, pn.pairs
        kind = "bf16"
        wide = check_pair(
            f"table-{kind}@2P=32 windows=[[0, 1]] n={Xa.shape[0]}", names,
            lambda a: pk._adjoint_outputs(*pk._adjoint_wide(Tp, a, pairs, ()), True, len(pairs), 0),
            lambda a: pk.packed_adjoint_plain(Tp, a, pairs, ()),
            lambda G2, G1: list(torch.unbind(pk._forward_wide(
                Tp, *pk._dense_stacks(torch.stack(G2, 1), None, 32, Tp.device), pairs, ()))),
            lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, ()),
            pn, pn.P, Xa, (1, 10), (1, 20), True, Tp.float(), Tp.numel() * Tp.element_size(), repeat=True,
            label="kernels-wide", units=(WIDE_UNIT[dtype], WIDE_UNIT[dtype]))
        narrow_cases = check_pair(
            f"table-{kind}@2P=32 (narrow) n={Xa.shape[0]}",
            ("packed_adjoint", "packed_forward"),
            lambda a: pk.packed_adjoint(Tp, a, pairs=pairs),
            lambda a: pk.packed_adjoint_plain(Tp, a, pairs, ()),
            lambda G2, G1: pk.packed_forward(Tp, G2, G1, pairs=pairs),
            lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, ()),
            pn, pn.P, Xa, (1, 10), (1, 20), True, Tp.float(), Tp.numel() * Tp.element_size(), repeat=True,
            label="kernels-wide")
        print(f"[kernels-wide] 2P=32 {dtype}: wide / narrow ms = "
              f"{[(w['shape'], w['ms'], v['ms']) for w, v in zip(wide, narrow_cases)]}", flush=True)
        cases += wide
    # the wide adjoint (nv = 1, 10) and forward (nsets = 1, 2, 10, 20), 2-D
    # windows on wgmma, at the three shapes of their bounds tables
    for name, what, shapes in ((names[0], "adjoint", ("nv=1", "nv=10")),
                               (names[1], "forward", ("nsets=1", "nsets=2", "nsets=10", "nsets=20"))):
        table = {}
        for c in cases:
            for key, (mode, where) in WIDE_BOUND_SHAPES.items():
                if c["kernel"] == name and c["mode"] == mode and where in c["tag"] and c["shape"] in shapes:
                    table[f"{key} {c['shape']}"] = dict(
                        ms=c["ms"], plain_ms=c["plain_ms"], library_ms=c["library_ms"],
                        bound_ms=round(c["bound_ms"], 4), bound_by=c["bound_by"],
                        share=round(c["bound_ms"] / c["ms"], 3), rel_err=c["rel"])
        print(f"[kernels-wide] the wide {what} at its bounds-table shapes (2-D windows on wgmma; bound: 3 or, on a "
              f"bf16 table, 2 TF32 products at {TF32_PEAK / 1e12:.0f} TFLOP/s, or the bytes): {json.dumps(table)}",
              flush=True)
        if len(table) != len(shapes) * len(WIDE_BOUND_SHAPES):
            raise AssertionError(f"kernels-wide: the {what}'s bounds-table shapes were not all run: {sorted(table)}")
    return cases


def _launches():
    """The NDFT wrappers' launch counts, and by shape."""
    from nfft4gp_torch.ops import packed_ndft as pk

    counts = {fn.__name__: fn.launches for fn in pk.KERNEL_WRAPPERS}
    counts["by_shape"] = {fn.__name__: dict(sorted(fn.launches_by_shape.items())) for fn in pk.KERNEL_WRAPPERS
                          if fn.launches}
    return counts


def timed_fit(prob, X, y, counted, steps=3, **fit_kw):
    """`steps` Adam steps of prob.fit (with fit_kw) with the given kernels'
    launch counts set to 0 just before and read just after.  Every loss and
    gradient must be finite.  Returns (losses, seconds to the end of each
    step from the call of fit, launch counts)."""
    from nfft4gp_torch.ops import packed_ndft as pk

    stamps, grads_ok = [], []

    def tick(it, state, loss, grad):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        grads_ok.append(bool(torch.isfinite(grad).all()))

    pk.reset_launch_counts()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    prob.fit(X, y, adam_maxits=steps, callback=tick, **fit_kw)
    counts = _launches()
    losses = prob.loss_history_
    if len(losses) != steps or not all(np.isfinite(losses)) or not all(grads_ok):
        raise AssertionError(f"losses or gradients not finite: {losses}, gradients finite {grads_ok}")
    if counted and min(counts[k] for k in counted) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")
    return losses, np.diff(stamps), counts


SHARDED = dict(kernel="gaussian", precond="nystrom", nys_rank=50, slq_its=10, nvecs=10, fastsum_N=FASTSUM_N,
               engine="stream", table_dtype=torch.bfloat16)
# [sharded] / [sharded-m12] against the single-GPU loss: the same operator,
# preconditioner and probes, the sums over points through the process group;
# the gradient limit is a tenth of [agree]'s
SHARDED_LIMITS = dict(loss_rtol=1e-4, grad_rtol=2e-2, grad_atol=2e-3)


def _sharded_gaps(tag, loss, grad, loss_ref, grad_ref):
    """Print-ready gaps of a sharded loss and gradient against the
    single-GPU ones, then hold them to SHARDED_LIMITS."""
    g, gr = grad.cpu().double().numpy(), grad_ref.cpu().double().numpy()
    gaps = {"loss_rel": abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)),
            "grad_max_abs": float(np.max(np.abs(g - gr))),
            "grad_max_rel": float(np.max(np.abs(g - gr) / np.maximum(np.abs(gr), 1e-30)))}

    def hold():
        np.testing.assert_allclose(float(loss), float(loss_ref), rtol=SHARDED_LIMITS["loss_rtol"],
                                   err_msg=f"{tag}: sharded loss")
        np.testing.assert_allclose(g, gr, rtol=SHARDED_LIMITS["grad_rtol"], atol=SHARDED_LIMITS["grad_atol"],
                                   err_msg=f"{tag}: sharded gradient")

    return gaps, hold


def check_sharded(mesh, X, y, main_steps, main_losses):
    """[sharded] (phase 5b): parallel/'s train step at [main]'s width on the
    rank's shard.  Returns the bf16 table kernels' launch counts of its 3
    steps."""
    from nfft4gp_torch.models.adam import adam_init
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.ops import packed_ndft as pk
    from nfft4gp_torch.parallel.training import make_sharded_train_step, shard_training_data
    from nfft4gp_torch.solvers.lanczos import rademacher_probes
    from nfft4gp_torch.utils.datasets import rand_perm

    n = X.shape[0]
    probes = rademacher_probes(torch.Generator().manual_seed(1), SHARDED["nvecs"], n, X.dtype)
    landmarks = rand_perm(torch.Generator().manual_seed(0), n, SHARDED["nys_rank"])
    raw0 = transform_inverse("softplus", torch.tensor([1.0, 1.0, 0.1], device=X.device))
    step = make_sharded_train_step(WINDOWS, mesh=mesh, landmarks=landmarks, **SHARDED)
    Xs, ys, ps = shard_training_data(mesh, X, y, probes)
    state, losses, grads = adam_init(raw0), [], []
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]
    for _ in range(3):
        state, loss, grad = step(state, Xs, ys, ps)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(loss))
        grads.append(grad)
    counts = _launches()
    steps = np.diff(stamps)
    if not all(np.isfinite(losses)) or not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError(f"sharded: losses or gradients not finite: {losses}")
    if min(counts["packed_adjoint"], counts["packed_forward"]) <= 0:
        raise AssertionError(f"sharded: a bf16 table kernel was not launched: {counts}")
    raw_hold = transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0], device=X.device))
    _, loss_h, grad_h = step(adam_init(raw_hold), Xs, ys, ps)
    kw = dict(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom", rank=SHARDED["nys_rank"],
              maxits=SHARDED["slq_its"], nvecs=SHARDED["nvecs"], fastsum_N=FASTSUM_N, fastsum_engine="stream")
    loss_ref, grad_ref = GPProblem(**kw).make_loss(X, y, probes=probes, landmarks=landmarks)(raw_hold)
    gaps, hold = _sharded_gaps("sharded", loss_h, grad_h, loss_ref, grad_ref)
    noise = torch.randn(y.shape, generator=torch.Generator(device=y.device).manual_seed(7), device=y.device)
    loss_y, _ = GPProblem(**kw).make_loss(X, y * (1 + 1e-7 * noise), probes=probes, landmarks=landmarks)(raw0)
    rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))  # noqa: E731
    backend = torch.distributed.get_backend()
    print(f"[sharded] n={n} windows={WINDOWS} rank {mesh.rank} of world {mesh.world} ({backend}, file:// store), "
          f"{Xs.shape[0]} rows a rank; make_sharded_train_step(gaussian, nystrom 50, engine=stream, bf16 tables) "
          f"losses={losses} s_per_step={steps.tolist()} median_s_per_step={float(np.median(steps)):.4f} "
          f"(the first includes the set-up: X gathered, geometry) | [main] s_per_step={main_steps.tolist()} "
          f"median={float(np.median(main_steps)):.4f} losses={main_losses} | first loss's gap to [main]'s "
          f"{rel(losses[0], main_losses[0]):.2e}, GPProblem's with y*(1 + 1e-7 noise) "
          f"{rel(loss_y, main_losses[0]):.2e} (not held) | launches={counts} | at (f, l, mu) = (1, 0.5, 1) "
          f"against GPProblem(fastsum_engine='stream').make_loss: loss {float(loss_h):.8e} vs "
          f"{float(loss_ref):.8e}, grad {grad_h.tolist()} vs {grad_ref.tolist()}, gaps={gaps} "
          f"limits={SHARDED_LIMITS}", flush=True)
    hold()
    return counts


def check_sharded_m12(mesh, X, y):
    """[sharded-m12] (phase 5c): matern12 + KNN near-field + AFN, one
    sharded step against the same step on one device."""
    from nfft4gp_torch.models.adam import adam_init
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.ops import packed_ndft as pk
    from nfft4gp_torch.ops.kernels import KernelParams
    from nfft4gp_torch.parallel.training import make_sharded_train_step, shard_training_data
    from nfft4gp_torch.preconds.afn import afn_plan
    from nfft4gp_torch.solvers.lanczos import rademacher_probes

    n = X.shape[0]
    plan = afn_plan("matern12", KernelParams.make(1.0, 1.0, 0.1, dtype=X.dtype, device=X.device), X,
                    maxrank=100, lfil=16, rank=100, force_afn=True)
    kw = dict(kernel="matern12", precond="afn", afn_plan=plan, slq_its=10, nvecs=10, fastsum_N=FASTSUM_N,
              engine="stream", table_dtype=torch.bfloat16)
    probes = rademacher_probes(torch.Generator().manual_seed(2), 10, n, X.dtype).to(X.device)
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0], device=X.device))
    step = make_sharded_train_step(WINDOWS, mesh=mesh, **kw)
    Xs, ys, ps = shard_training_data(mesh, X, y, probes)
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loss, grad = step(adam_init(raw), Xs, ys, ps)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _launches()
    if not bool(torch.isfinite(loss)) or not bool(torch.isfinite(grad).all()):
        raise AssertionError(f"sharded-m12: loss or gradient not finite: {loss}, {grad}")
    if min(counts["packed_adjoint"], counts["packed_forward"]) <= 0:
        raise AssertionError(f"sharded-m12: a bf16 table kernel was not launched: {counts}")
    _, loss_ref, grad_ref = make_sharded_train_step(WINDOWS, mesh=None, **kw)(adam_init(raw), X, y, probes)
    gaps, hold = _sharded_gaps("sharded-m12", loss, grad, loss_ref, grad_ref)
    print(f"[sharded-m12] n={n} windows={WINDOWS} matern12 KNN near-field (lower-triangular), AFN k={plan.k} "
          f"lfil 16, engine=stream bf16, (f, l, mu) = (1, 0.5, 1), world {mesh.world}: one step {secs:.3f} s "
          f"(with the set-up) loss={float(loss):.8e} grad={grad.tolist()} | one device without the group: "
          f"loss={float(loss_ref):.8e} grad={grad_ref.tolist()} gaps={gaps} limits={SHARDED_LIMITS} | "
          f"launches={counts}", flush=True)
    hold()
    return counts


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


def _true_relres(K, x, b):
    Kd, xd, bd = K.double(), x.double(), b.double()
    return float(torch.linalg.norm(bd - Kd @ xd) / torch.linalg.norm(bd))


def _slq_from_tridiag(alpha, beta):
    """Mean over probes of sum_j (e1' v_j)^2 log|theta_j| (logdet(K)/n)."""
    from nfft4gp_torch.solvers.lanczos import _tridiag

    theta, vecs = torch.linalg.eigh(_tridiag(alpha.double(), beta.double()))
    return float(torch.mean(torch.sum(vecs[:, 0, :] ** 2 * torch.log(torch.abs(theta)), dim=1)))


def check_dense_kernels(X, y):
    """The cooperative CG and Lanczos kernels at n = 2048 and 4096 (module
    docstring, phase 9).  Returns (per-kernel case dicts, launch counts of
    the entry points' run)."""
    from nfft4gp_torch.ops import _cuda_build
    from nfft4gp_torch.ops.kernels import KernelParams, additive_kernel_matrix, make_windows
    from nfft4gp_torch.solvers import fused_pcg as fp
    from nfft4gp_torch.solvers.lanczos import lanczos_batch, rademacher_probes, slq_logdet
    from nfft4gp_torch.solvers.pcg import pcg

    dev, W = X.device, make_windows(WINDOWS)
    probs = {}
    for n in DENSE_NS:
        for mu in DENSE_MUS:
            p = KernelParams.make(1.0, 0.5, mu, dtype=torch.float32, device=dev)
            probs[n, mu] = (additive_kernel_matrix("gaussian", p, X[:n], W).contiguous(), y[:n].contiguous())
    gen = torch.Generator(device=dev).manual_seed(2)
    Zs = {n: rademacher_probes(gen, SLQ_NV, n, dtype=torch.float32) for n in DENSE_NS}

    # the entry points at every shape, their launch counts from 0
    fp.reset_launch_counts()
    torch.cuda.synchronize()
    sols = {key: fp.fused_pcg_dense(K, b, maxits=PCG_MAXITS, tol=PCG_TOL) for key, (K, b) in probs.items()}
    lans = {n: fp.fused_lanczos_dense(probs[n, DENSE_MUS[0]][0], Zs[n], maxits=SLQ_ITS) for n in DENSE_NS}
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fp.KERNEL_WRAPPERS}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a dense kernel was not launched: {launches}")

    # the plans the launches ran under, and one grid barrier of each at its
    # blocks, threads (CG has a producer warp only where rows stream) and
    # shared memory
    plans, barrier = {}, {}
    for n in DENSE_NS:
        plans["pcg", n] = cg = _cuda_build._grid("pcg", n, dev)[0]
        plans["lanczos", n] = lz = _cuda_build._grid("lanczos", n, dev, SLQ_NV, SLQ_ITS)[0]
        barrier["pcg", n] = _cuda_build.barrier_us(dev, 1, threads=fp.CG_CONS + (32 if cg.stages else 0),
                                                   smem=cg.smem, blocks=cg.blocks)[0]
        barrier["lanczos", n] = _cuda_build.barrier_us(dev, 1, threads=fp.LZ_CONS + 32, smem=lz.smem,
                                                       blocks=lz.blocks)[0]
    gs_us, gs_blocks, _ = _cuda_build.barrier_us(dev, 0)
    per_plan = {f"{k} n={n} blocks={plans[k, n].blocks}": round(v, 3) for (k, n), v in barrier.items()}
    print(f"[dense-kernels] one grid barrier at each launch's plan (blocks, threads, shared memory): the "
          f"kernels' counter barrier {per_plan} us; cooperative groups' grid.sync() {gs_us:.3f} us "
          f"({gs_blocks} blocks, 160 KB of shared memory, 288 threads)", flush=True)

    cases = []
    for (n, mu), (K, b) in probs.items():
        x, rr, it = sols[n, mu]
        again = fp.fused_pcg_dense(K, b, maxits=PCG_MAXITS, tol=PCG_TOL)
        bitwise = all(torch.equal(u, v) for u, v in zip((x, rr, it), again))
        xp, rp, itp = fp.fused_pcg_dense_plain(K, b, maxits=PCG_MAXITS, tol=PCG_TOL)
        it, itp, rr, rp = int(it), int(itp), float(rr), float(rp)
        true, true_p = _true_relres(K, x, b), _true_relres(K, xp, b)
        ms = cuda_ms(lambda: fp.fused_pcg_dense(K, b, maxits=PCG_MAXITS, tol=PCG_TOL))
        pms = cuda_ms(lambda: fp.fused_pcg_dense_plain(K, b, maxits=PCG_MAXITS, tol=PCG_TOL), reps=3, warmup=1)
        lms = cuda_ms(lambda: torch.linalg.solve(K, b))
        ems = cuda_ms(lambda: pcg(lambda v: K @ v, b, tol=PCG_TOL, maxits=PCG_MAXITS), reps=3, warmup=1)
        b_ms, b_by = bound(it * (2.0 * n * n + 10.0 * n), 4.0 * (n * n + 2 * n))
        plan = plans["pcg", n]
        floor_ms = it * 1 * barrier["pcg", n] * 1e-3
        c = dict(kernel="fused_pcg_dense", shape=f"n={n} mu={mu}", max_abs=float((x - xp).abs().max()), ms=ms,
                 plain_ms=pms, library_ms=lms, engine_ms=ems, bound_ms=b_ms, bound_by=b_by, engine=ENGINES["f32"],
                 steps=it, barrier_probe_us=barrier["pcg", n])
        cases.append(c)
        print(f"[dense-kernels] fused_pcg_dense n={n} (f, l, mu)=(1, 0.5, {mu}): niter={it} (plain {itp}) "
              f"relres={rr:.3e} (plain {rp:.3e}) true_relres_f64={true:.3e} (plain {true_p:.3e}) "
              f"max_abs_err={c['max_abs']:.3e} bitwise_repeat={bitwise} ms={ms:.4f} plain_ms={pms:.4f} "
              f"library_ms(linalg.solve)={lms:.4f} engine_ms(pcg)={ems:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share={b_ms / ms:.3f} barriers/step=1 barrier_us={barrier['pcg', n]:.3f} "
              f"barrier_floor_ms={floor_ms:.4f} blocks={plan.blocks} K resident={plan.resident_bytes} B "
              f"streamed/step={plan.streamed_bytes} B", flush=True)
        if not bitwise:
            raise AssertionError(f"fused_pcg_dense n={n} mu={mu}: a second launch differs")
        if itp < PCG_MAXITS:
            if not (it < PCG_MAXITS and rr <= PCG_TOL and true <= 10 * PCG_TOL
                    and abs(it - itp) <= max(2, 0.1 * itp)):
                raise AssertionError(f"fused_pcg_dense n={n} mu={mu} outside its limits against the plain CG")
        elif not true <= 2.0 * true_p:
            raise AssertionError(f"fused_pcg_dense n={n} mu={mu}: true residual {true} > 2x plain {true_p}")

    for n in DENSE_NS:
        K, Z = probs[n, DENSE_MUS[0]][0], Zs[n]
        out = lans[n]
        again = fp.fused_lanczos_dense(K, Z, maxits=SLQ_ITS)
        bitwise = all(torch.equal(u, v) for u, v in zip(out, again))
        a, bt, V, b0 = out
        ap, bp, Vp, b0p = fp.fused_lanczos_dense_plain(K, Z, maxits=SLQ_ITS)
        scale = float(ap.abs().max())
        coef_err = max(float((u - v).abs().max()) for u, v in ((a, ap), (bt, bp), (b0, b0p)))
        v_rel = float(torch.linalg.norm(V - Vp) / torch.linalg.norm(Vp))
        est = _slq_from_tridiag(a, bt)
        ref = float(slq_logdet(lambda R: R @ K, lambda R: R.new_zeros((R.shape[0], 1, n)), Z,
                               maxits=SLQ_ITS).logdet)
        ms = cuda_ms(lambda: fp.fused_lanczos_dense(K, Z, maxits=SLQ_ITS))
        pms = cuda_ms(lambda: fp.fused_lanczos_dense_plain(K, Z, maxits=SLQ_ITS), reps=3, warmup=1)
        ems = cuda_ms(lambda: lanczos_batch(lambda R: R @ K, Z, maxits=SLQ_ITS, tol=0.0), reps=3, warmup=1)
        # steps the launch ran: until every probe stopped (V's later rows stay 0)
        live = int(((V != 0).any(dim=2).sum(dim=1) - 1).max())
        steps = min(SLQ_ITS, live + 1)
        V0 = V[:, 0].contiguous()
        mm_ms = steps * cuda_ms(lambda: torch.mm(V0, K))
        flops = 2.0 * SLQ_NV * n * n * steps + 4.0 * SLQ_NV * n * steps * (steps + 1)
        b_ms, b_by = bound(flops, 4.0 * (n * n + SLQ_NV * n * (SLQ_ITS + 2) + SLQ_NV * 2 * SLQ_ITS))
        max_abs = max(coef_err, float((V - Vp).abs().max()))
        plan = plans["lanczos", n]
        floor_ms = steps * 3 * barrier["lanczos", n] * 1e-3
        cases.append(dict(kernel="fused_lanczos_dense", shape=f"n={n} mu={DENSE_MUS[0]}", max_abs=max_abs, ms=ms,
                          plain_ms=pms, library_ms=None, engine_ms=ems, product_alone_ms=mm_ms, bound_ms=b_ms,
                          bound_by=b_by, engine=ENGINES["f32"], steps=steps,
                          barrier_probe_us=barrier["lanczos", n]))
        print(f"[dense-kernels] fused_lanczos_dense n={n} nv={SLQ_NV} maxits={SLQ_ITS}: coef_err/max|alpha|="
              f"{coef_err / scale:.3e} V_rel_err={v_rel:.3e} logdet/n={est:.8e} (slq_logdet {ref:.8e}) "
              f"bitwise_repeat={bitwise} ms={ms:.4f} plain_ms={pms:.4f} library_ms=None "
              f"engine_ms(lanczos_batch)={ems:.4f} product_alone_ms({steps} x torch.mm)={mm_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) share={b_ms / ms:.3f} barriers/step=3 "
              f"barrier_us={barrier['lanczos', n]:.3f} barrier_floor_ms={floor_ms:.4f} blocks={plan.blocks} "
              f"panel={plan.width} K resident={plan.resident_bytes} B streamed/step={plan.streamed_bytes} B",
              flush=True)
        if not bitwise:
            raise AssertionError(f"fused_lanczos_dense n={n}: a second launch differs")
        if not (coef_err <= 1e-4 * scale and v_rel <= 1e-3 and abs(est - ref) <= 1e-4 * abs(ref)):
            raise AssertionError(f"fused_lanczos_dense n={n} outside its limits against the plain version")
    print(f"[dense-kernels] launches of the entry points' run: {launches}", flush=True)
    return cases, launches


def check_dense_fit(X, y):
    from nfft4gp_torch.models.problem import GPProblem

    prob = GPProblem(kernel="gaussian", windows=WINDOWS, operator="dense", precond="chol", maxits=10, nvecs=10)
    losses, steps, _ = timed_fit(prob, X, y, ())
    print(f"[dense-fit] n={X.shape[0]} windows={WINDOWS} precond=chol losses={losses} s_per_step={steps.tolist()} "
          f"median_s_per_step={float(np.median(steps)):.4f}", flush=True)


def _nf_values(stencils, params, geom):
    """The radius near-field entries (K and dK/dl values) of every window
    with a stencil, at params."""
    from nfft4gp_torch.ops import fastsum as fs

    return fs._packed_layout(fs.additive_fastsum_coeffs("matern12", params, geom, nearfield_lfil=0), stencils).nf


def _nf_apply(entries, V, which="k"):
    from nfft4gp_torch.ops import fastsum as fs

    return sum(fs._nf_trip_apply_batch(False, e, V, which) for e in entries)


def check_stream_m12(X, y):
    """[stream-m12]: the default matern12 engine on CUDA tensors (phase 11),
    on the first N_STREAM_M12 points of X; at all of X the radius
    near-field must refuse the 1-D window's grid, as the JAX package does."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_forward
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    full = fs.additive_fastsum_geometry(X, make_windows(WINDOWS_FUSED), N=FASTSUM_N, table_dtype=torch.bfloat16)
    if fs.additive_nearfield_stencil_direct(full, "matern12", 16) is not None:
        raise AssertionError(f"stream-m12: at n={X.shape[0]} the 1-D window's grid should exceed 2^15 cells")
    X, y = X[:N_STREAM_M12], y[:N_STREAM_M12]
    prob = GPProblem(**FUSED)
    losses, steps, counts = timed_fit(prob, X, y, ("packed_adjoint", "packed_forward"))
    dims = sorted({len(w) for w in WINDOWS_FUSED})
    names = [w for dw in dims for w in WINDOWS_FUSED if len(w) == dw]
    stens = [e for g in prob.nf_stencils_ or () if g is not None for e in g]
    form = []
    for w, e in zip(names, stens):
        n, width = e.idx.shape
        nbytes = e.idx.numel() * e.idx.element_size() + e.pos.numel() * e.pos.element_size() + 2 * n * width * 4
        form.append(dict(window=w, ncells=e.grid.ncells, c=e.grid.c, rho=e.rho, in_radius=int(e.pos.numel()),
                         ell_width=width, bytes=nbytes, dense_stencil_bytes=2 * 4 * e.grid.ncells * e.grid.c
                         * e.grid.noffs * e.grid.c))
    knn = [dict(windows=[w for w in WINDOWS_FUSED if len(w) == dw], nf_sym=p[2], row_width=int(p[0].shape[-1]))
           for dw, p in zip(dims, prob.nf_patterns_) if p is not None]
    if len(stens) != sum(len(w) <= 2 for w in WINDOWS_FUSED) or not knn:
        raise AssertionError(f"stream-m12: not every d <= 2 window has the radius near-field: {form} {knn}")
    # the near-field alone at the fitted hyperparameters
    tv, _ = transform_forward("softplus", prob.raw_params_)
    params = KernelParams(f=tv[0], l=tv[1], mu=tv[2])
    geom = fs.additive_fastsum_geometry(X, make_windows(WINDOWS_FUSED), N=FASTSUM_N, table_dtype=torch.bfloat16)
    entries = _nf_values(prob.nf_stencils_, params, geom)
    gen = torch.Generator(device=X.device).manual_seed(3)
    V10 = torch.randn((10, X.shape[0]), generator=gen, device=X.device)
    times = dict(values_ms=cuda_ms(lambda: _nf_values(prob.nf_stencils_, params, geom), reps=3, warmup=1),
                 apply_nv1_ms=cuda_ms(lambda: _nf_apply(entries, V10[:1])),
                 apply_nv10_ms=cuda_ms(lambda: _nf_apply(entries, V10)))
    print(f"[stream-m12] n={X.shape[0]} windows={WINDOWS_FUSED} engine=auto (stream) radius near-field per window="
          f"{form} knn near-field={knn} near-field on the card (4 windows, K values; values_ms builds K and "
          f"dK/dl)={times} losses={losses} s_per_step={steps.tolist()} (the first includes the set-up: geometry, "
          f"cell grids, in-radius pairs, KNN of [0, 1, 2]) median_steady_s_per_step="
          f"{float(np.median(steps[1:])):.4f} launches={counts} | at n={N_POINTS}: the 1-D window needs more "
          f"than 2^15 cells, no radius near-field on any window (KNN instead, as in the JAX package)", flush=True)
    return prob, counts


def check_stream_m12_agree(X, y):
    """[agree-stream-m12] (phase 12)."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    Xh, yh = X.cpu().double(), y.cpu().double()
    V = torch.randn((10, X.shape[0]), generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    out = []
    for Xs, Vs in ((X, V.to(X.device, torch.float32)), (Xh, V)):
        geom = fs.additive_fastsum_geometry(Xs, make_windows(WINDOWS_FUSED), N=FASTSUM_N)
        stens = fs.additive_nearfield_stencil_direct(geom, "matern12", 16)
        params = KernelParams.make(1.0, 0.5, 1.0, dtype=Xs.dtype, device=Xs.device)
        entries = _nf_values(stens, params, geom)
        out.append(torch.stack([_nf_apply(entries, Vs, w) for w in "kl"]).cpu().double())
    rel = [float(torch.linalg.norm(out[0][k] - out[1][k]) / torch.linalg.norm(out[1][k])) for k in range(2)]

    # both sides on the stream engine (on the CPU its plain versions), so
    # both build the radius near-field on the windows of one or two features
    kw = dict(FUSED, fastsum_table_dtype="float32", fastsum_engine="stream")
    card = GPProblem(**kw)
    loss_c, grad_c = card.make_loss(X, y)(transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0],
                                                                                    device=X.device)))
    pats = tuple(None if p is None else (p[0].cpu(), p[1].cpu(), p[2]) for p in card.nf_patterns_)
    host = GPProblem(**kw)
    loss_h, grad_h = host.make_loss(Xh, yh, nf_patterns=pats)(
        transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0], dtype=torch.float64)))
    n_sten = [sum(len(g) for g in p.nf_stencils_ or () if g is not None) for p in (card, host)]
    if n_sten != [sum(len(w) <= 2 for w in WINDOWS_FUSED)] * 2:
        raise AssertionError(f"agree-stream-m12: radius near-field windows (card, CPU) = {n_sten}")
    print(f"[agree-stream-m12] n={X.shape[0]} (f, l, mu) = (1, 0.5, 1) radius near-field card f32 vs CPU f64 "
          f"(K, dK/dl) rel_fro={rel} (limit 5e-5) | stream loss card f32 tables={float(loss_c):.8e} "
          f"grad={grad_c.tolist()} | CPU float64 (stream, plain versions) loss={float(loss_h):.8e} "
          f"grad={grad_h.tolist()} rel_loss_gap={abs(float(loss_c) - float(loss_h)) / abs(float(loss_h)):.3e}",
          flush=True)
    if not max(rel) <= 5e-5:
        raise AssertionError(f"agree-stream-m12: the near-field on the card disagrees with CPU float64: {rel}")
    np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-3)
    np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=1e-2, atol=1e-3)


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _finite(*ts):
    return all(bool(torch.isfinite(t).all()) for t in ts)


def check_predict(prob, sprob, X, y):
    """[predict] (phase 13)."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse

    Xt, _ = make_data(2000, seed=7)
    mean, s_mean = _timed(lambda: prob.predict(X, y, Xt))
    (m16, std), s_std = _timed(lambda: prob.predict(X, y, Xt[:16], with_std=True))
    print(f"[predict] main (gaussian, fastsum) n={X.shape[0]} mean at {Xt.shape[0]} points: {s_mean:.2f} s, "
          f"mean[:4]={mean[:4].tolist()}; mean and std at 16 points: {s_std:.2f} s, std[:4]={std[:4].tolist()}",
          flush=True)
    smean, s_smean = _timed(lambda: sprob.predict(X[:N_STREAM_M12], y[:N_STREAM_M12], Xt))
    print(f"[predict] stream-m12 (matern12, n={N_STREAM_M12}, auto rule at n > 20000: fastsum) mean at "
          f"{Xt.shape[0]} points: "
          f"{s_smean:.2f} s, mean[:4]={smean[:4].tolist()}", flush=True)
    if not (_finite(mean, m16, std, smean) and bool((std > 0).all())):
        raise AssertionError("predict: a mean or std is not finite, or a std is not positive")

    Xa, ya = X[:N_AGREE], y[:N_AGREE]
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1], device=X.device))
    res = {}
    for op in ("fastsum", "dense"):
        p = GPProblem(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom", rank=50, maxits=10,
                      nvecs=10, fastsum_N=FASTSUM_N, predict_operator=op, raw_params_=raw)
        (m, secs) = _timed(lambda: p.predict(Xa, ya, Xt))
        ((_, sd), secs_std) = _timed(lambda: p.predict(Xa, ya, Xt[:16], with_std=True))
        res[op] = (m, sd, secs, secs_std)
    gap = [float(torch.linalg.norm(res["fastsum"][k] - res["dense"][k]) / torch.linalg.norm(res["dense"][k]))
           for k in range(2)]
    print(f"[predict] n={N_AGREE} (f, l, mu) = (1, 0.5, 0.1) fastsum vs dense: mean gap {gap[0]:.3e} (limit 5e-3), "
          f"std gap {gap[1]:.3e} (limit 5e-4); seconds mean/std(16): fastsum {res['fastsum'][2]:.2f}/"
          f"{res['fastsum'][3]:.2f}, dense {res['dense'][2]:.2f}/{res['dense'][3]:.2f}", flush=True)
    if not (_finite(*res["fastsum"][:2], *res["dense"][:2]) and gap[0] <= 5e-3 and gap[1] <= 5e-4):
        raise AssertionError(f"predict: fastsum and dense disagree at n={N_AGREE}: {gap}")


def check_full(X, y):
    """[full] (phase 14)."""
    from nfft4gp_torch.models.problem import GPProblem

    X2 = X[:, :2].contiguous()
    prob = GPProblem(kernel="gaussian", operator="fastsum", precond="nystrom", rank=50, maxits=10, nvecs=10,
                     fastsum_N=FASTSUM_N)
    losses, steps, _ = timed_fit(prob, X2, y, (), steps=2)
    Xt, _ = make_data(256, seed=8)
    mean, secs = _timed(lambda: prob.predict(X2, y, Xt[:, :2].contiguous()))
    print(f"[full] n={X.shape[0]} windows=None features [0, 1] losses={losses} s_per_step={steps.tolist()} "
          f"mean at 256 points: {secs:.2f} s, mean[:4]={mean[:4].tolist()}", flush=True)
    if not _finite(mean):
        raise AssertionError("full: the mean is not finite")


AFN = dict(kernel="matern12", windows=WINDOWS_FUSED, operator="fastsum", precond="afn", rank=200, lfil=16,
           maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
AFN_INIT = (1.0, 0.1, 0.01)
N_AFN_PCG = 100_000
N_CLI = 20_000
# limits of [agree-afn], card float32 against CPU float64: about 10x the
# CPU float32-against-float64 gaps at n = 2e4 (solve 4.3e-4, dvp 3.0e-4,
# loss 1.3e-5, relative; gradient entries 1e-6), the card's kernels'
# rounding added
AFN_AGREE = dict(solve=5e-3, dvp=5e-3, loss=5e-4, grad_rtol=1e-2, grad_atol=1e-3)


def _instrument(module, name, record, summary):
    """Replace module.name by a wrapper that appends (seconds, summary(out))
    of each call (synchronized) to record; returns the function that puts
    the original back."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t, summary(out)))
        return out

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


def _params(raw):
    from nfft4gp_torch.models.transforms import transform_forward
    from nfft4gp_torch.ops.kernels import KernelParams

    tv, _ = transform_forward("softplus", raw)
    return KernelParams(f=tv[0], l=tv[1], mu=tv[2])


def check_afn(X, y):
    """[afn] (phase 15): the AFN slice at full width, fit with re-planning,
    then a mean."""
    from nfft4gp_torch.models import problem as pm
    from nfft4gp_torch.ops.kernels import make_windows
    from nfft4gp_torch.preconds.afn import afn_setup_from_plan
    from nfft4gp_torch.solvers.lanczos import rademacher_probes

    X, y = X[:N_STREAM_M12], y[:N_STREAM_M12]
    plans, facts = [], []
    restore = [_instrument(pm, "afn_plan", plans, lambda p: (p.k, p.use_ran)),
               _instrument(pm, "afn_setup_from_plan", facts, lambda pre: int(pre.breakdown))]
    torch.cuda.reset_peak_memory_stats()
    try:
        prob = pm.GPProblem(**AFN)
        losses, steps, counts = timed_fit(prob, X, y, ("packed_adjoint", "packed_forward"), init=AFN_INIT,
                                          replan_every=2)
    finally:
        for r in restore:
            r()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    plan = prob.afn_plan_
    pre = afn_setup_from_plan("matern12", _params(prob.raw_params_), X, plan, require_grad=True,
                              windows=make_windows(WINDOWS_FUSED))
    Z = rademacher_probes(torch.Generator(device=X.device).manual_seed(6), 10, X.shape[0], dtype=X.dtype)
    dvp_ms = cuda_ms(lambda: pre.dvp(Z), reps=2, warmup=1, batches=2)
    solve_ms = cuda_ms(lambda: pre.solve(Z), reps=3, warmup=1, batches=2)
    Xt, _ = make_data(2000, seed=9)
    mean, s_mean = _timed(lambda: prob.predict(X, y, Xt))
    print(f"[afn] n={X.shape[0]} {AFN} init={AFN_INIT} replan_every=2: plans (k, use_ran) and seconds="
          f"{[(p[1], round(p[0], 3)) for p in plans]} n2={X.shape[0] - plan.k} factorizations (seconds, repaired "
          f"rows)={[(round(f[0], 4), f[1]) for f in facts]} losses={losses} s_per_step={steps.tolist()} "
          f"dvp(nv=10) ms={dvp_ms:.2f} solve(nv=10) ms={solve_ms:.3f} transpose pattern width="
          f"{plan.pattern_t[0].shape[1]} peak_GiB={peak:.2f} launches={counts} | mean at {Xt.shape[0]} points "
          f"(AFN planned at (1, 1, 0.1)): {s_mean:.2f} s, mean[:4]={mean[:4].tolist()}", flush=True)
    train_plans = plans[:2]
    if len(train_plans) != 2 or any(use_ran for _, (_, use_ran) in train_plans):
        raise AssertionError(f"afn: expected two plans on the AFN branch, got {plans}")
    if not _finite(mean):
        raise AssertionError("afn: the mean is not finite")
    return counts


def check_afn_agree(X, y):
    """[agree-afn] (phase 16): card float32 against CPU float64 (the stream
    engine's plain versions), one injected AFN plan, the same probes."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.preconds.afn import afn_plan, afn_setup_from_plan
    from nfft4gp_torch.solvers.lanczos import rademacher_probes

    Xh, yh = X.cpu().double(), y.cpu().double()
    p = (1.0, 0.1, 1.0)
    plan_h = afn_plan("matern12", KernelParams.make(*p, dtype=torch.float64), Xh, maxrank=200, lfil=16,
                      rank=200, force_afn=True)
    plan_c = plan_h._replace(perm=plan_h.perm.to(X.device),
                             pattern=tuple(t.to(X.device) for t in plan_h.pattern),
                             pattern_t=tuple(t.to(X.device) for t in plan_h.pattern_t))
    probes = rademacher_probes(torch.Generator().manual_seed(5), 10, X.shape[0], dtype=torch.float64)
    kw = dict(AFN, fastsum_table_dtype="float32", fastsum_engine="stream")
    raw = transform_inverse("softplus", torch.tensor(p, dtype=torch.float64))
    card = GPProblem(**kw)
    loss_c, grad_c = card.make_loss(X, y, probes=probes.float().to(X.device), afn_plan=plan_c)(
        raw.float().to(X.device))
    pats = tuple(None if q is None else (q[0].cpu(), q[1].cpu(), q[2]) for q in card.nf_patterns_)
    host = GPProblem(**kw)
    loss_h, grad_h = host.make_loss(Xh, yh, probes=probes, nf_patterns=pats, afn_plan=plan_h)(raw)
    W = make_windows(WINDOWS_FUSED)
    pre_c = afn_setup_from_plan("matern12", _params(raw.float().to(X.device)), X, plan_c, require_grad=True,
                                windows=W)
    pre_h = afn_setup_from_plan("matern12", _params(raw), Xh, plan_h, require_grad=True, windows=W)
    Zc = probes.float().to(X.device)
    rel = {}
    for name in ("solve", "dvp"):
        got = getattr(pre_c, name)(Zc).cpu().double()
        want = getattr(pre_h, name)(probes)
        rel[name] = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
    gap = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    print(f"[agree-afn] n={X.shape[0]} (f, l, mu) = {p} plan k={plan_h.k} (force_afn) repaired rows card/CPU="
          f"{int(pre_c.breakdown)}/{int(pre_h.breakdown)} rel_fro card f32 vs CPU f64: {rel} | stream loss card "
          f"f32 tables={float(loss_c):.8e} grad={grad_c.tolist()} | CPU float64 loss={float(loss_h):.8e} "
          f"grad={grad_h.tolist()} rel_loss_gap={gap:.3e} limits={AFN_AGREE}", flush=True)
    if not (rel["solve"] <= AFN_AGREE["solve"] and rel["dvp"] <= AFN_AGREE["dvp"] and gap <= AFN_AGREE["loss"]):
        raise AssertionError(f"agree-afn: card and CPU disagree: {rel}, loss gap {gap}")
    np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=AFN_AGREE["grad_rtol"],
                               atol=AFN_AGREE["grad_atol"])


def check_afn_pcg(X, y):
    """[afn-pcg] (phase 17): K x = y by PCG to 1e-2, no preconditioner,
    Nystrom and AFN, on the float32-table kernels.  Returns the launch
    counts of the AFN solve and its iterations."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.ops import packed_ndft as pk
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.preconds.afn import afn_plan, afn_setup_from_plan
    from nfft4gp_torch.preconds.nystrom import nystrom_setup
    from nfft4gp_torch.solvers.pcg import pcg
    from nfft4gp_torch.utils.datasets import rand_perm

    # the first two features: the AFN plan orders and patterns the points
    # in the space the kernel of the one window sees
    X, y = X[:N_AFN_PCG, :2].contiguous(), y[:N_AFN_PCG]
    windows = [[0, 1]]
    W = make_windows(windows)
    prob = GPProblem(kernel="matern12", windows=windows, operator="fastsum", fastsum_engine="stream",
                     fastsum_table_dtype="float32", fastsum_N=FASTSUM_N)
    params = KernelParams.make(1.0, 0.1, 0.01, dtype=X.dtype, device=X.device)
    (mv, _), s_op = _timed(lambda: prob._build_ops_factory(X)(params))
    gen = torch.Generator(device=X.device).manual_seed(8)

    def afn():
        plan = afn_plan("matern12", params, X, maxrank=200, lfil=16, generator=gen)
        return afn_setup_from_plan("matern12", params, X, plan, windows=W), plan

    setups = {"none": lambda: (None, None),
              "nystrom": lambda: (nystrom_setup("matern12", params, X, rand_perm(gen, X.shape[0], 200), 200,
                                                windows=W), None),
              "afn": afn}
    rows, counts = {}, None
    for name, setup in setups.items():
        (pre, plan), s_setup = _timed(setup)
        pk.reset_launch_counts()
        res, s_solve = _timed(lambda: pcg(mv, y, precond=None if pre is None else pre.solve, tol=1e-2,
                                          maxits=400))
        if name == "afn":
            counts = _launches()
            counts["iterations"] = res.niter
        rows[name] = dict(niter=res.niter, relres=float(res.relres), setup_s=round(s_setup, 3),
                          solve_s=round(s_solve, 3))
        if plan is not None:
            rows[name].update(k=plan.k, use_ran=plan.use_ran)
    print(f"[afn-pcg] n={X.shape[0]} d=2 matern12 windows={windows} (f, l, mu) = (1, 0.1, 0.01) N={FASTSUM_N} "
          f"float32 tables, tol 1e-2, maxits 400 (operator set-up {s_op:.2f} s): {rows} launches of the AFN "
          f"solve={counts}", flush=True)
    by_shape = counts["by_shape"]
    print(f"[afn-pcg] the float32-table route's launches in the AFN solve by shape: csrc/packed_ndft.cu adjoint "
          f"{by_shape.get('packed_adjoint', {})} forward {by_shape.get('packed_forward', {})}; wide pair adjoint "
          f"{by_shape.get('packed_adjoint_wide', {})} forward {by_shape.get('packed_forward_wide', {})}", flush=True)
    if not (rows["afn"]["niter"] <= 400 and rows["afn"]["relres"] <= 1e-2):
        raise AssertionError(f"afn-pcg: AFN-PCG did not reach 1e-2 in 400 iterations: {rows['afn']}")
    if min(counts["packed_adjoint"], counts["packed_forward"]) <= 0:
        raise AssertionError(f"afn-pcg: a float32-table kernel was not launched: {counts}")
    return counts


N_MANY = 20_000
# one window past a launch's 32 pairs, and past its 64 singles
MANY_PAIRS_D, MANY_SINGLES_D = 66, 65
# the adjoint's right-hand sides and the forward's weight sets of its loss
# steps (their launches by shape)
MANY_NVS, MANY_NSETS = (1, 10), (1, 2, 10, 20)


def check_many_windows_kernels(engine, X, windows):
    """The kernel wrappers of one [many-windows] problem at its shapes, on
    its own coordinates, windows and width, against their plain versions
    (KERNEL_RTOL; the regenerating ones in float64), a second call bitwise
    equal: the bf16-table pair at 33 pairs (stream), the regenerating pair
    at 65 singles (fused, "doubling", the engine's phases).  Every call
    must launch twice (two window groups).  Returns the case dicts."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    plan = _plan(X, windows)
    if engine == "stream":
        names = ("packed_adjoint", "packed_forward")
        pn = fs.packed_ndft_plan(plan, table_dtype=torch.bfloat16)
        Tp, pairs, singles = pn.Tp, pn.pairs, pn.singles
        tag, lay, P, T32, units = "table-bf16", pn, pn.P, Tp.float(), ("bf16x3", "bf16x3")
        src_bytes = Tp.numel() * Tp.element_size()
        fns = (lambda a: pk.packed_adjoint(Tp, a, pairs=pairs, singles=singles),
               lambda a: pk.packed_adjoint_plain(Tp, a, pairs, singles),
               lambda G2, G1: pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles),
               lambda G2s, G1s: pk.packed_forward_plain(Tp, G2s, G1s, pairs, singles))
        refs = {}
    else:
        names = ("packed_adjoint_regen", "packed_forward_regen")
        lay = fs._packed_layout(plan)
        P, gen = fs._nmodes(FASTSUM_N), "doubling"
        xT, pairs, singles = lay.xT, lay.pairs, lay.singles
        tag, T32, units = gen, pk.phase_slab(xT, P, gen), ("tf32x3", "tf32x3")
        src_bytes = xT.numel() * xT.element_size()
        kw = dict(P=P, pairs=pairs, singles=singles, phase_gen=gen)
        fns = (lambda a: pk.packed_adjoint_regen(xT, a, **kw),
               lambda a: pk.packed_adjoint_regen_plain(xT, a, P, pairs, singles, gen),
               lambda G2, G1: pk.packed_forward_regen(xT, G2, G1, **kw),
               lambda G2s, G1s: pk.packed_forward_regen_plain(xT, G2s, G1s, P, pairs, singles, gen))
        x64 = (lambda t: None if t is None else t.double())  # noqa: E731
        refs = dict(adj_ref=lambda a: pk.packed_adjoint_regen_plain(xT.double(), a.double(), P, pairs, singles, gen),
                    fwd_ref=lambda G2s, G1s: pk.packed_forward_regen_plain(xT.double(), x64(G2s), x64(G1s), P, pairs,
                                                                           singles, gen))
    wrappers = [getattr(pk, name) for name in names]
    before = [fn.launches for fn in wrappers]
    cases = check_pair(f"{tag} {len(pairs)} pairs {len(singles)} singles n={X.shape[0]}", names, *fns, lay, P, X,
                       MANY_NVS, MANY_NSETS, False, T32, src_bytes, units=units, repeat=True, label="many-windows",
                       **refs)
    # two calls a case (the bitwise repeat), two window groups a call
    launched = [fn.launches - b for fn, b in zip(wrappers, before)]
    if launched != [4 * len(MANY_NVS), 4 * len(MANY_NSETS)]:
        raise AssertionError(f"many-windows: {names} launched {launched} times, not twice a call")
    return cases


def check_many_windows(dev):
    """[many-windows]: more windows than one kernel launch takes, through
    GPProblem on the card at n = N_MANY, one loss and gradient each: d = 66
    features as 33 2-D windows on the stream engine (gaussian, bf16 tables,
    2P = 32: the tensor-core table kernels), and d = 65 as 65 1-D windows on
    the fused engine (matern12, 2P = 34: the regenerating kernels), each
    against the torch table engine on the card (the fused engine with
    float32 tables and the same KNN patterns): the limits of [agree] and of
    [agree-fused].  Before each, its kernel wrappers at its shapes against
    their plain versions (`check_many_windows_kernels`).  Each kernel
    wrapper must launch twice a call (two window groups).  Returns {engine:
    launch counts}."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.ops import packed_ndft as pk

    out = {}
    for engine, d in (("stream", MANY_PAIRS_D), ("fused", MANY_SINGLES_D)):
        rng = np.random.default_rng(d)
        X = torch.from_numpy(rng.uniform(size=(N_MANY, d)).astype(np.float32)).to(dev)
        y = torch.from_numpy((np.sin(3.0 * X[:, 0].cpu().numpy()) + 0.1 * rng.normal(size=N_MANY))
                             .astype(np.float32)).to(dev)
        if engine == "stream":
            windows = [[2 * w, 2 * w + 1] for w in range(d // 2)]
            kw = dict(kernel="gaussian", windows=windows, operator="fastsum", precond="nystrom", rank=50,
                      maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
            mu, card_kw, rtol = 0.1, dict(fastsum_engine="stream"), (4e-2, 2e-1, 2e-2)
            counted = ("packed_adjoint", "packed_forward")
        else:
            windows = [[j] for j in range(d)]
            kw = dict(kernel="matern12", windows=windows, operator="fastsum", precond="nystrom", rank=50,
                      maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
            mu, card_kw, rtol = 1.0, dict(fastsum_fused=True), (1e-3, 1e-2, 1e-3)
            counted = ("packed_adjoint_regen", "packed_forward_regen")
        check_many_windows_kernels(engine, X, windows)
        raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, mu], device=dev))
        card = GPProblem(**card_kw, **kw)
        pk.reset_launch_counts()
        loss_c, grad_c = card.make_loss(X, y)(raw)
        counts = _launches()
        table_kw = dict(fastsum_engine="table") if engine == "stream" else dict(fastsum_engine="table",
                                                                              fastsum_table_dtype="float32")
        pats = None if engine == "stream" else card.nf_patterns_
        loss_t, grad_t = GPProblem(**table_kw, **kw).make_loss(X, y, nf_patterns=pats)(raw)
        calls = {k: counts["by_shape"].get(k, {}) for k in counted}
        print(f"[many-windows] n={N_MANY} d={d} {len(windows)} windows engine={engine} (f, l, mu) = (1, 0.5, {mu}): "
              f"loss={float(loss_c):.8e} grad={grad_c.tolist()} | table engine loss={float(loss_t):.8e} "
              f"grad={grad_t.tolist()} (limits: loss rtol {rtol[0]}, gradient rtol {rtol[1]} / atol {rtol[2]}); "
              f"launches by shape {calls}", flush=True)
        np.testing.assert_allclose(float(loss_c), float(loss_t), rtol=rtol[0])
        np.testing.assert_allclose(grad_c.cpu().numpy(), grad_t.cpu().numpy(), rtol=rtol[1], atol=rtol[2])
        if any(v % 2 for k in counted for v in calls[k].values()) or min(counts[k] for k in counted) < 2:
            raise AssertionError(f"many-windows: the {engine} kernels did not run in two window groups: {calls}")
        out[engine] = counts
    return out


AFN_PCG_256_ARGV = ["--n", "100000", "--d", "2", "--kernel", "matern12", "--l", "0.1", "--mu", "0.01", "--N", "256",
                    "--nf-lfil", "128", "--rank", "200", "--lfil", "16", "--tol", "1e-2", "--maxits", "400", "--comp",
                    "--replace-every", "25", "--engine", "stream", "--precs", "none,nystrom,afn", "--solvers", "pcg"]
# AFN_PCG_1e5_m12_f32.json (the JAX package's run of the same configuration)
JAX_AFN_PCG_256_ITERS = 13


def _bench_module():
    """scripts/torch_afn_pcg_bench.py, the port of scripts/afn_pcg_bench.py."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "torch_afn_pcg_bench.py")
    spec = importlib.util.spec_from_file_location("torch_afn_pcg_bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_afn_pcg_256(dev):
    """[afn-pcg-256]: AFN_PCG.md section 3's row at its full size through
    scripts/torch_afn_pcg_bench.py's functions (its data from
    np.random.default_rng(0), its operator recipe: float32 tables at
    2P = 256 on the wide kernels, the radius near-field of nf_lfil 128,
    psd_clip, a solve-only plan): PCG to 1e-2 with none, Nystrom and AFN,
    each solve run twice and the second timed (as the script does), the
    launches counted over the second.  AFN-PCG must converge within 400
    iterations, the wide kernels launched and no narrow float32-table
    kernel.  Also the parts of one AFN iteration on the card.  Returns the
    launch counts of the AFN solve and its iterations."""
    from nfft4gp_torch.ops import packed_ndft as pk
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    bench = _bench_module()
    args = bench.parse_args(AFN_PCG_256_ARGV)
    torch.cuda.reset_peak_memory_stats()
    X, b, dtype = bench.make_problem(args, dev)
    params = KernelParams.make(1.0, args.l, args.mu, dtype=dtype, device=dev)
    windows = make_windows(bench.windows_of(args.d))
    (mv, info), s_op = _timed(lambda: bench.build_operator(args, X, params, windows, log=lambda m: print(
        f"[afn-pcg-256] {m}", flush=True)))
    rows, counts, afn_pre = {}, None, None
    for name, setup_s, pre, plan in bench.preconditioners(args, X, params, windows, args.precs.split(",")):
        bench.solve(args, mv, b, pre, "pcg")
        pk.reset_launch_counts()
        res, s_solve = _timed(lambda: bench.solve(args, mv, b, pre, "pcg"))
        rec = bench.record(res, s_solve, setup_s, "pcg")
        rows[name] = {k: rec[k] for k in ("iters", "relres", "converged", "setup_s", "solve_s", "s_per_iter",
                                          "time_to_tol")}
        if plan is not None:
            rows[name].update(k=plan.k, use_ran=plan.use_ran)
        if name == "afn":
            counts, afn_pre = _launches(), pre
            counts["iterations"] = res.niter
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the parts of one AFN iteration
    parts = dict(matvec_ms=cuda_ms(lambda: mv(b)), afn_solve_ms=cuda_ms(lambda: afn_pre.solve(b)))
    print(f"[afn-pcg-256] n={args.n} d=2 matern12 windows={bench.windows_of(args.d)} (f, l, mu) = (1, {args.l}, "
          f"{args.mu}) N={args.N} (2P = {2 * info['P']}, float32 table {info['table_bytes']} bytes), radius "
          f"near-field nf_lfil {args.nf_lfil} ({info['nf']}, {info['nf_bytes']} bytes, K values only), psd_clip, "
          f"tol {args.tol}, maxits {args.maxits}, compensated FGMRES reductions, replace_every "
          f"{args.replace_every}: operator set-up {s_op:.2f} s; {rows}; one AFN iteration's parts on the card "
          f"{parts}; peak_GiB={peak:.2f}; launches of the AFN solve={counts} | JAX package, same configuration "
          f"(AFN_PCG_1e5_m12_f32.json, for comparison only): AFN-PCG {JAX_AFN_PCG_256_ITERS} iterations",
          flush=True)
    if not (rows["afn"]["converged"] and rows["afn"]["iters"] <= 400 and rows["afn"]["relres"] <= 1e-2):
        raise AssertionError(f"afn-pcg-256: AFN-PCG did not reach 1e-2 in 400 iterations: {rows['afn']}")
    if min(counts["packed_adjoint_wide"], counts["packed_forward_wide"]) <= 0:
        raise AssertionError(f"afn-pcg-256: a wide kernel was not launched: {counts}")
    if counts["packed_adjoint"] or counts["packed_forward"]:
        raise AssertionError(f"afn-pcg-256: a narrow table kernel was launched: {counts}")
    return counts


N_WIDE_AGREE = 5_000
WIDE_TRAIN = dict(kernel="matern12", windows=WINDOWS, operator="fastsum", precond="nystrom", rank=50, maxits=10,
                  nvecs=10, fastsum_N=WIDE_TRAIN_N)


def check_wide_train(X, y):
    """[wide-train]: GPProblem(matern12, WINDOWS, fastsum_N=128) at
    n = N_WIDE_TRAIN, 2 Adam steps on the stream engine (its default on the
    card: bf16 tables, 2P = 128, radius near-field) and 2 with
    fastsum_fused=True (regenerating, 2P = 130, KNN near-field), every loss
    finite and the wide kernels launched; then at n = N_WIDE_AGREE and
    (f, l, mu) = (1, 0.5, 1) both engines' losses and gradients on the card
    (the stream engine with float32 tables) against their plain versions
    on CPU float64 with the same probes and landmarks (the fused engine
    also with the card's KNN patterns): the limits of [agree-stream-m12]
    and [agree-fused].  Returns {engine: launch counts}."""
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse

    Xn, yn = X[:N_WIDE_TRAIN], y[:N_WIDE_TRAIN]
    out = {}
    for engine, kw in (("stream", {}), ("fused", dict(fastsum_fused=True))):
        prob = GPProblem(**WIDE_TRAIN, **kw)
        losses, steps, counts = timed_fit(prob, Xn, yn, ("packed_adjoint_wide", "packed_forward_wide"), steps=2)
        nf = ("radius" if prob.nf_stencils_ is not None and all(g is not None for g in prob.nf_stencils_)
              else "knn")
        print(f"[wide-train] n={Xn.shape[0]} windows={WINDOWS} matern12 fastsum_N=128 engine={engine} "
              f"near-field={nf} losses={losses} s_per_step={steps.tolist()} (the first includes the set-up) "
              f"launches={counts}", flush=True)
        out[engine] = counts

    Xa, ya = X[:N_WIDE_AGREE], y[:N_WIDE_AGREE]
    Xh, yh = Xa.cpu().double(), ya.cpu().double()
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0], dtype=torch.float64))
    for engine, kw in (("stream", dict(fastsum_engine="stream", fastsum_table_dtype="float32")),
                       ("fused", dict(fastsum_fused=True))):
        card = GPProblem(**WIDE_TRAIN, **kw)
        loss_c, grad_c = card.make_loss(Xa, ya)(raw.float().to(Xa.device))
        pats = None if card.nf_patterns_ is None else tuple(
            None if p is None else (p[0].cpu(), p[1].cpu(), p[2]) for p in card.nf_patterns_)
        host = GPProblem(**WIDE_TRAIN, **kw)
        loss_h, grad_h = host.make_loss(Xh, yh, nf_patterns=pats)(raw)
        gap = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
        print(f"[wide-train] agree n={Xa.shape[0]} (f, l, mu) = (1, 0.5, 1) engine={engine}: card loss="
              f"{float(loss_c):.8e} grad={grad_c.tolist()} | CPU float64 (plain versions) loss={float(loss_h):.8e} "
              f"grad={grad_h.tolist()} rel_loss_gap={gap:.3e} (limits: loss 1e-3, gradient 1e-2 / 1e-3)",
              flush=True)
        np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-3)
        np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=1e-2, atol=1e-3)
    return out


def check_fsai(X, y):
    """[fsai] (phase 18): gaussian, five 2-D windows, FSAI, 2 Adam steps."""
    from nfft4gp_torch.models.problem import GPProblem

    prob = GPProblem(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="fsai", lfil=16, maxits=10,
                     nvecs=10, fastsum_N=FASTSUM_N)
    losses, steps, counts = timed_fit(prob, X, y, ("packed_adjoint", "packed_forward"), steps=2)
    print(f"[fsai] n={X.shape[0]} windows={WINDOWS} lfil=16 losses={losses} s_per_step={steps.tolist()} "
          f"(the first includes the KNN pattern and its transpose) launches={counts}", flush=True)


def _write_text(path, header, values):
    """A file in the reference's text format: the header, then the values."""
    values = np.asarray(values).reshape(-1)
    with open(path, "w") as f:
        f.write(" ".join(str(h) for h in header) + "\n")
        np.savetxt(f, values, fmt="%.17g" if values.dtype.kind == "f" else "%d")


def check_cli(X, y):
    """[cli] (phase 19): the port's CLI as a subprocess on the card, on
    synthetic files of the first N_CLI points (the reference's text
    formats) with WINDOWS as the 'g' windows."""
    import os
    import tempfile

    Xn, yn = X[:N_CLI + 2000].cpu().double().numpy(), y[:N_CLI + 2000].cpu().double().numpy()
    with tempfile.TemporaryDirectory() as d:
        for part, rows in (("train", slice(0, N_CLI)), ("test", slice(N_CLI, N_CLI + 2000))):
            Xp = Xn[rows]
            _write_text(os.path.join(d, f"syn.{part}.feature"), Xp.shape, Xp.T)
            _write_text(os.path.join(d, f"syn.{part}.label"), (Xp.shape[0],), yn[rows])
        _write_text(os.path.join(d, "syn.g.window"), (len(WINDOWS), 2), np.asarray(WINDOWS).T)
        cmd = [sys.executable, "-m", f"{PKG}_torch.cli", "--data-dir", d, "--name", "syn", "--precond", "afn",
               "--adam-maxits", "2"]
        t = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t
    lines = proc.stdout.strip().splitlines()
    print(f"[cli] {' '.join(cmd[3:])} (n_train={N_CLI}): exit {proc.returncode} in {secs:.1f} s; "
          f"{' / '.join(lines[-4:])}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"cli: exit {proc.returncode}: {proc.stderr[-2000:]}")
    rmse = float(proc.stdout.split("prediction RMSE:")[1].split()[0])
    if not np.isfinite(rmse):
        raise AssertionError(f"cli: RMSE {rmse}")


def _summary(name, route, mode, cases, shape, launches):
    c = next(c for c in cases if c["kernel"] == name and c["shape"] == shape and c.get("mode") == mode)
    base = next(k for k in ("adjoint", "forward", "pcg", "lanczos") if k in name)
    out = {"name": name, "route": "cuda", "source": SOURCES[route], "replaces": TPU_KERNELS[base],
           "mode": mode, "shape": shape, "launches": launches[name],
           "max_abs_err": max(d["max_abs"] for d in cases if d["kernel"] == name),
           "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
           "library_ms": c["library_ms"], "engine": c["engine"]}
    if name in launches.get("by_shape", {}):
        out["launches_by_shape"] = launches["by_shape"][name]
        out["ms_by_shape"] = {d["shape"]: d["ms"] for d in cases
                              if d["kernel"] == name and d.get("mode") == mode and d["ms"] is not None}
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    try:
        import nfft4gp_torch  # noqa: F401  (switches TF32 off)
    except ModuleNotFoundError as e:
        sys.exit(f"chip_smoke: the port's package is not beside this script ({e}); run it from the root of a "
                 "checkout")
    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.ops import _cuda_build
    from nfft4gp_torch.parallel.mesh import close_mesh, make_mesh

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[device] torch: {name}, count {torch.cuda.device_count()}; nvidia-smi name, power.limit:", flush=True)
    print(smi, flush=True)

    phase_s, lap = {}, [_T0]

    def mark(phase):
        now = time.perf_counter()
        phase_s[phase] = round(now - lap[0], 1)
        lap[0] = now

    paths, secs = _cuda_build.build()
    for lib in paths:
        _cuda_build.library(lib)
    print(f"[build] {', '.join(p.parent.name for p in paths.values())} compiled in {secs:.1f} s "
          "(one nvcc per source, in parallel)", flush=True)
    wide_ptxas = _cuda_build.ptxas_report("packed_ndft_wide")
    print(f"[build] ptxas, csrc/packed_ndft_wide.cu (template arguments of the GEMMs: 0 float32 table, 1 bf16 "
          f"table, then the wgmma N tile; of the phase slab: 0 doubling, 1 direct): {wide_ptxas}", flush=True)
    if any(r["spill_bytes"] for r in wide_ptxas if r["kernel"].startswith("wide_")):
        raise AssertionError(f"a wide kernel spills registers: {wide_ptxas}")
    print(f"[build] ptxas, csrc/packed_ndft_wide.cu, its notes on the wgmma adjoint and forward (registers: the "
          f"entry count; their consumer warpgroups run at 224 after setmaxnreg): "
          f"{_cuda_build.ptxas_notes('packed_ndft_wide')}", flush=True)
    print(f"[build] ptxas, csrc/fused_pcg.cu (pcg_kernel<float4 chunks of r a thread>, "
          f"lanczos_kernel<probes>): {_cuda_build.ptxas_report('fused_pcg')} "
          f"notes: {_cuda_build.ptxas_notes('fused_pcg')}", flush=True)
    blocks, total = _cuda_build.grid_sync_probe(torch.device("cuda:0"))
    print(f"[build] grid.sync() over {blocks} resident blocks: sum {total} "
          f"(expected {blocks * (blocks + 1) // 2})", flush=True)
    if total != blocks * (blocks + 1) // 2:
        raise AssertionError("the cooperative grid-wide barrier does not hold")
    mark("build")

    X, y = make_data(N_POINTS)
    cases = check_kernels(X, WINDOWS, nvs=(1, 10), nsets_list=(1, 2, 10, 20))
    cases += check_kernels(X, WINDOWS_1D, nvs=(1, 10), nsets_list=(1, 2, 10, 20), timed=False)
    check_kernels(X, WINDOWS_FUSED, nvs=(1, 10), nsets_list=(1, 2, 10, 20))
    f32 = check_f32_kernels(X)
    regen = check_regen_kernels(X)
    mark("kernels")
    wide = check_wide_kernels(X)
    mark("kernels-wide")

    prob = GPProblem(kernel="gaussian", windows=WINDOWS, operator="fastsum", precond="nystrom",
                     rank=50, maxits=10, nvecs=10, fastsum_N=FASTSUM_N)
    losses, steps, counts = timed_fit(prob, X, y, ("packed_adjoint", "packed_forward"))
    print(f"[main] n={N_POINTS} losses={losses} s_per_step={steps.tolist()} "
          f"median_s_per_step={float(np.median(steps)):.4f} launches={counts}", flush=True)
    mark("main")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        mesh = make_mesh(1, rank=0, init_file=os.path.join(tmp, "store"), device="cuda")
        try:
            shcounts = check_sharded(mesh, X, y, steps, losses)
            mark("sharded")
            shm12counts = check_sharded_m12(mesh, X[:N_AGREE], y[:N_AGREE])
            mark("sharded-m12")
        finally:
            close_mesh()

    check_engines(X[:N_AGREE], y[:N_AGREE])
    mark("agree")

    fprob = GPProblem(fastsum_fused=True, **FUSED)
    flosses, fsteps, fcounts = timed_fit(fprob, X, y, ("packed_adjoint_regen", "packed_forward_regen"))
    nf = [None if p is None else (p[2], tuple(p[0].shape)) for p in fprob.nf_patterns_]
    print(f"[fused] n={N_POINTS} windows={WINDOWS_FUSED} nf (nf_sym, (windows, n, row width)) per group={nf} "
          f"losses={flosses} s_per_step={fsteps.tolist()} (the first includes the set-up: geometry, KNN, "
          f"symmetrization) median_steady_s_per_step={float(np.median(fsteps[1:])):.4f} launches={fcounts}",
          flush=True)
    if not any(p is not None for p in fprob.nf_patterns_):
        raise AssertionError("the matern12 fused path built no near-field")
    mark("fused")

    check_fused_engines(X[:N_AGREE], y[:N_AGREE])
    mark("agree-fused")

    Xd, yd = make_data(max(DENSE_NS))
    dense, dcounts = check_dense_kernels(Xd, yd)
    for c in dense:
        c["mode"] = "dense"
    check_dense_fit(Xd, yd)
    mark("dense")

    sprob, scounts = check_stream_m12(X, y)
    mark("stream-m12")
    check_stream_m12_agree(X[:N_AGREE], y[:N_AGREE])
    mark("agree-stream-m12")
    check_predict(prob, sprob, X, y)
    mark("predict")
    check_full(X, y)
    mark("full")
    acounts = check_afn(X, y)
    mark("afn")
    check_afn_agree(X[:N_AGREE], y[:N_AGREE])
    mark("agree-afn")
    pcounts = check_afn_pcg(X, y)
    mark("afn-pcg")
    wcounts = check_afn_pcg_256(X.device)
    mark("afn-pcg-256")
    mcounts = check_many_windows(X.device)
    mark("many-windows")
    tcounts = check_wide_train(X, y)
    mark("wide-train")
    check_fsai(X, y)
    mark("fsai")
    check_cli(X, y)
    mark("cli")

    summary = [_summary("packed_adjoint", "table", "table-bf16", cases, "nv=10", counts),
               _summary("packed_forward", "table", "table-bf16", cases, "nsets=20", counts),
               _summary("packed_adjoint", "table_f32", "table-f32@2P=32-1pair", f32, "nv=1", pcounts),
               _summary("packed_forward", "table_f32", "table-f32@2P=32-1pair", f32, "nsets=1", pcounts),
               _summary("packed_adjoint_regen", "regen", "doubling", regen, "nv=10", fcounts),
               _summary("packed_forward_regen", "regen", "doubling", regen, "nsets=20", fcounts),
               _summary("packed_adjoint_wide", "wide", "table-f32@2P=256", wide, "nv=1", wcounts),
               _summary("packed_forward_wide", "wide", "table-f32@2P=256", wide, "nsets=1", wcounts),
               _summary("fused_pcg_dense", "fused", "dense", dense, f"n={DENSE_NS[0]} mu={DENSE_MUS[0]}", dcounts),
               _summary("fused_lanczos_dense", "fused", "dense", dense, f"n={DENSE_NS[1]} mu={DENSE_MUS[0]}",
                        dcounts)]
    for k in summary[:2]:
        k["launches_sharded"] = shcounts[k["name"]]
        k["launches_by_shape_sharded"] = shcounts["by_shape"][k["name"]]
        k["launches_sharded_m12"] = shm12counts[k["name"]]
        k["launches_by_shape_sharded_m12"] = shm12counts["by_shape"][k["name"]]
        k["launches_stream_m12"] = scounts[k["name"]]
        k["launches_by_shape_stream_m12"] = scounts["by_shape"][k["name"]]
        k["launches_afn"] = acounts[k["name"]]
        k["launches_by_shape_afn"] = acounts["by_shape"][k["name"]]
    for k in summary[2:4]:
        k["pcg_iterations"] = pcounts["iterations"]
        case = next(c for c in f32 if c["kernel"] == k["name"] and c["mode"] == k["mode"] and c["shape"] == k["shape"])
        k["ms_warm"], k["table_read_ms"] = case["ms_warm"], case["read_ms"]
        k["ms_by_shape"] = {f"{c['mode']} {c['shape']}": c["ms"] for c in f32 if c["kernel"] == k["name"]}
        k["wide_ms_by_shape"] = {f"{c['mode']} {c['shape']}": c["beside_ms"] for c in f32 if c["kernel"] == k["name"]}
    for k, engine in ((summary[0], "stream"), (summary[1], "stream"), (summary[4], "fused"), (summary[5], "fused")):
        k[f"launches_by_shape_many_windows_{engine}"] = mcounts[engine]["by_shape"][k["name"]]
    for k in summary[6:8]:
        k["pcg_iterations"] = wcounts["iterations"]
        for engine, counts in tcounts.items():
            k[f"launches_by_shape_wide_train_{engine}"] = counts["by_shape"][k["name"]]
        k["ms_by_shape_wide_train"] = {f"{c['mode']} {c['shape']}": c["ms"] for c in wide
                                       if c["kernel"] == k["name"] and f"windows={WINDOWS}" in c["tag"]}
    for k in summary[8:10]:
        c = next(c for c in dense if c["kernel"] == k["name"] and c["shape"] == k["shape"])
        for key in ("engine_ms", "product_alone_ms", "steps", "barrier_probe_us"):
            if key in c:
                k[key] = c[key]
        k["ms_by_shape"] = {d["shape"]: d["ms"] for d in dense if d["kernel"] == k["name"]}
    print(f"[done] wall seconds from the start of chip_smoke.py to its summary: "
          f"{time.perf_counter() - _T0:.1f}; seconds by phase (the first from the script's start): {phase_s}",
          flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
