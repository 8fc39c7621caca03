"""Time the port's NDFT kernels against an earlier build of them, and
profile one loss step, on one NVIDIA GPU.

    python3 scripts/torch_table_kernels_ab.py --old-csrc OLD/csrc
    python3 scripts/torch_table_kernels_ab.py --kernels regen --old-csrc OLD/csrc
    python3 scripts/torch_table_kernels_ab.py --kernels wide --old-csrc OLD/csrc
    python3 scripts/torch_table_kernels_ab.py --kernels wide-chunks
    python3 scripts/torch_table_kernels_ab.py --kernels f32 --old-csrc OLD/csrc [--old-tree OLD]
    python3 scripts/torch_table_kernels_ab.py --kernels dense --old-csrc OLD/csrc [--variants]

OLD/csrc is an earlier `csrc/` (unpack it from an earlier commit with
`git archive`).  The script builds one of its sources with nvcc into
`_chip_scratch/ab_build/`, checks the old kernels against the current ones,
then times them in turns, old, new, new, old (medians of `cuda_ms`, the
card's time), and prints the ratios old / new.  Without --old-csrc only the
current kernels are timed.

--kernels table (the default): OLD/csrc/packed_ndft.cu, whose C interface
takes a contiguous table and a bf16 flag (the CUDA-core kernels the
bf16-table tensor-core ones replaced), at the training shapes of
chip_smoke.py (n = 2e5, d = 10, five 2-D windows, N = 32, bf16 table):
adjoint nv = 1, 10, forward nsets = 1, 2, 10, 20.  Then one profiled
loss-and-gradient step of GPProblem(gaussian, five 2-D windows, fastsum,
nystrom, stream engine) at n = 2e5.

--kernels regen: OLD/csrc/packed_ndft_regen.cu whose adjoint takes the
tensor-core launch configuration (as the current one does) and whose
forward takes the float32-table forward's arguments (the CUDA-core
regenerating forward that forward_regen_tc_kernel replaced), at
chip_smoke.py's [kernels-regen] shapes (WINDOWS_FUSED, n = 2e5, 2P = 34,
both phase sources): the adjoint at nv = 1, 10 (the same kernel in both
builds: its ratio shows the noise), the forward at nsets = 1, 2, 10, 20.
Then one profiled loss-and-gradient step of chip_smoke.py's [fused]
problem (GPProblem(matern12, WINDOWS_FUSED, fastsum_fused=True)) at
n = 2e5, whose `ndft_kernels_ms` gives the forward's card time in it.

--kernels wide: an earlier OLD/csrc/packed_ndft_wide.cu against the
current wide pair (the 2-D windows of both on wgmma in 3xTF32): one
whose GEMMs regenerate the phases of "doubling" and "direct"
inside every tile (source kinds 2 and 3, the coordinates as their source),
or one with a phase slab of its own (wide_phases_launch; the current
library writes the slab for it; its adjoint chunked by its own rule,
`_old_wide_chunks`); its forward's interface is read from its source (the
current split weights, the first wgmma forward's strided G2, or the
CUDA-core forward's contiguous G2), at chip_smoke.py's
[wide-train] shapes (the first N_WIDE_TRAIN = 1e5 points, WINDOWS, 2P =
130, both phase sources): the adjoint at nv = 1, 10, the forward at
nsets = 1, 2, 10, 20; the bf16 table at 2P = 128; and the float32 table
at [afn-pcg-256]'s shape (the window [0, 1], 2P = 256, adjoint nv = 1,
10, forward nsets = 1, 2, 10, 20).  Then one profiled
loss-and-gradient step of [wide-train]'s problem at n = 1e5 on the stream
engine and one on the fused engine, with the wide kernels' device time, and
one AFN-PCG solve of [afn-pcg-256] (ms per iteration, the wide kernels'
share), after the whole solve timed with the old forward in place of the
new one and with the new, in turns (host clock: the solve is host-bound).

--kernels wide-chunks: the current wide adjoint alone at the shapes of its
bounds table (chip_smoke.py WIDE_BOUND_SHAPES, nv = 1, 10), its chunk
count from `wide_chunks` against simple rules (the most chunks whose blocks
fit one wave, or four, of one block an SM), in turns; no profile.

--kernels f32: an earlier OLD/csrc/packed_ndft.cu (the CUDA-core
float32-table kernels before the TMA-fed ones, interface `_old_f32_signatures`,
chunked by their wrapper's rule) against the current one (its launchers
called directly), with the wide pair (csrc/packed_ndft_wide.cu, called
directly) and the einsum yardstick beside them, at 2P = 16 and 32 on one
pair ([afn-pcg]'s window [0, 1]) and on the AFN-PCG bench's default five
(d = 10), n = 1e5: the adjoint at nv = 1, 2, 4, 10, 16, the forward at nsets =
1, 2, 4, 10, 20 (random weights).  Each row checks every kernel against the
plain version, times them in turns (old, f32, wide, einsum, then the
yardsticks of the table's read: the current kernels built with
F32_STREAM_ONLY=1, whose consumers free each stage unread, torch.sum and
torch.clone of the table; then reversed) warm and, where the inputs fit the
50 MB L2, cold (`cuda_ms(cold=True)`), gives each kernel's bound on its own
units (bytes, float32 flops on the CUDA cores, or the wide pair's 3xTF32
products on the tensor cores, as chip_smoke.py) and its share, and names
the kernel the route rule picks (`table_route`).  With --old-tree
OLD (an earlier checkout, unpacked with `git archive`), then [afn-pcg]'s
solve at N = 32 on float32 tables (scripts/torch_afn_pcg_trees.py with
--N 32: AFN_PCG.md section 3's row at N = 32) with OLD's package and this
checkout's, each in its own process, in turns: ms per iteration on the host
clock (the solve is host-bound).  No profile.

--kernels dense: an earlier OLD/csrc/fused_pcg.cu (the cooperative CG and
Lanczos kernels whose C entry points size their own grid,
`_old_dense_signatures`) against the current ones under their launch plans
(solvers/fused_pcg.py), at chip_smoke.py's [dense-kernels] shapes (CG at
n = 2048, 4096 and mu = 0.1, 0.01, maxits 200, tol 1e-5; Lanczos with 10
probes and 10 steps at n = 2048, 4096) and at n = 2049 (mu = 0.1), whose
rows the wrappers copy to a padded stride (the copy is timed with the
call, and alone as `pad_copy_ms`).  First the yardsticks: one grid
barrier (`barrier_us`: the kernels' counter barrier and cooperative groups'
grid.sync() at each launch plan's blocks, threads and shared memory) and
the rate of a cyclic re-read of a 10-60 MB buffer (`reread_GBps`: from L2
where it stays there) beside a 256 MB one (from HBM); then per shape the
old outputs against the new (CG: niter, max |x_old - x_new| over
max |x_old|; Lanczos: alpha, beta and V), times in turns old, new, new,
old, the plan's bytes of K resident and streamed a step, and block 0's
time by phase, averaged over the steps (one launch of a copy of the
current csrc/fused_pcg.cu with its `// @phase:` marks switched on,
`phase_timed_source`: CG matvec on the resident and the streamed rows,
barrier, p'q + r update + sums, p update, the step-start barrier with the
producer; Lanczos product (to its first chunk, its chunks, its
reduction), each CGS pass's partials + barrier and totals + update, the
norm's partials + barrier, the rest).  --variants also times the current
kernels under other plans at n = 4096, made from the card's own with
`cg_variant` / `lanczos_variant` (CG's ring of 2 to 8 one-row stages;
Lanczos with its own columns of w and V in global memory, and its ring of
2 to 6 stages of 64-row chunks, 2 or 3 of 128 rows, 2 of 256).  Last,
whether a cooperative launch takes a cluster dimension (`cluster_coop`,
clusters of 2 and 4 blocks at the n = 4096 Lanczos plan's shared memory).
The probes and the phase-timed copy are built into
`_chip_scratch/ab_build/`.  No profile.

The profile (torch.profiler, after a warm-up step): wall time, device-busy
time (the union of the device kernels' intervals) and its share of the wall
time, and the device time by kernel.  Prints one JSON line at the end.
Exits non-zero without CUDA.
"""

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

NVS = (1, 10)
NSETS = (1, 2, 10, 20)


def _old_regen_signatures(lib):
    """The earlier packed_ndft_regen.cu: adjoint_launch as the current one,
    forward_launch as the float32-table library's."""
    from nfft4gp_torch.ops import _cuda_build

    _old_f32_signatures(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, I, I, I, P, P]


def _old_wide_signatures(lib, forward):
    """An earlier packed_ndft_wide.cu: wide_adjoint_launch as the current
    one; its forward's interface (`forward`): "split", as the current one
    (the weights split by wide_split_weights_launch first); "strided", G2
    with its strides, split inside the kernel (the first wgmma forward);
    "contiguous", G2 contiguous (the CUDA-core forward before it)."""
    from nfft4gp_torch.ops import _cuda_build

    if forward == "split":
        _cuda_build._ndft_wide_signatures(lib)
        return
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.wide_adjoint_launch.argtypes = [I, P, I, P, I, I, I, P, I, P, I, P, I, I, P, P]
    lib.wide_forward_launch.argtypes = (
        [I, P, I, I, I, P, I, P, L, L, L, P, I, P, I, P, P] if forward == "strided"
        else [I, P, I, I, I, P, I, P, P, I, P, I, P, P])
    lib.wide_adjoint_launch.restype = I
    lib.wide_forward_launch.restype = I


def _old_f32_signatures(lib):
    """An earlier packed_ndft.cu (the CUDA-core templates): adjoint_launch(table, its flag or row stride, alpha, WR, n,
    nv, pairs, npairs, singles, nsingles, part, nchunks, chunk, out, stream), forward_launch(table, flag
    or stride, WR, n, pairs, npairs, G2, singles, nsingles, G1, nsets, y, stream)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, P, P]
    lib.adjoint_launch.restype = I
    lib.forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, P, P]
    lib.forward_launch.restype = I


def _old_rhs_per_block(WR: int) -> int:
    """Right-hand sides per block of the earlier CUDA-core adjoint
    (AdjCfg<WR>::RB of that packed_ndft.cuh), by which its wrapper chunked."""
    wrp = -(-WR // 4) * 4
    tiles = (wrp // 4) * (wrp // (2 if wrp == 16 else 4))
    return min(8, 256 // tiles)


def _old_forward(lib, what, src, src_flag, G2, G1, WR, n, pairs, singles):
    """One launch of an earlier forward_launch of the interface of
    `_old_f32_signatures` (phase source, its flag or stride, ...): (nsets, n)."""
    from nfft4gp_torch.ops import _cuda_build as cb

    nsets = G2.shape[0]
    y = torch.empty((nsets, n), dtype=torch.float32, device=G2.device)
    pr, sg = cb._ints(v for pair in pairs for v in pair), cb._ints(singles)
    code = lib.forward_launch(src.data_ptr(), src_flag, WR, n, pr, len(pairs), G2.data_ptr(), sg, len(singles),
                              G1.data_ptr(), nsets, y.data_ptr(), cb._stream(G2))
    cb._check(lib, code, what)
    return y


def build_old(csrc: Path, source: str) -> ctypes.CDLL:
    """The earlier `source` of csrc, built and loaded: packed_ndft.cu's
    adjoint_launch / forward_launch take (phase source, its flag, ...)
    without a launch configuration; packed_ndft_regen.cu's as
    `_old_regen_signatures`."""
    from nfft4gp_torch.ops import _cuda_build

    out = ROOT / "_chip_scratch" / "ab_build" / f"lib{Path(source).stem}_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
                    str(csrc / source)], check=True)
    lib = ctypes.CDLL(str(out))
    if source == "packed_ndft_wide.cu":
        text = (csrc / source).read_text()
        lib.forward = ("split" if "wide_split_weights_launch" in text
                       else "strided" if "long long gset" in text else "contiguous")
        _old_wide_signatures(lib, lib.forward)
    else:
        {"packed_ndft_regen.cu": _old_regen_signatures,
         "fused_pcg.cu": _old_dense_signatures}.get(source, _old_f32_signatures)(lib)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def old_calls(lib, Tp, pairs, flag=1):
    """The earlier kernels' adjoint(alpha) and forward(G2) on a table,
    chunked as their wrapper chunked them: a contiguous bf16 table with the
    bf16 flag (the earliest interface), or, with flag None, a float32 table
    with its row stride (the later one)."""
    from nfft4gp_torch.ops import _cuda_build as cb

    T = Tp.contiguous() if flag is not None else Tp
    flag = T.stride(1) if flag is None else flag
    _, WR, n = T.shape
    pr = cb._ints(v for p in pairs for v in p)
    sg = cb._ints(())

    def adj(alpha):
        nv = alpha.shape[0]
        nchunks, chunk = cb._chunks(n, len(pairs) * -(-nv // _old_rhs_per_block(WR)))
        S = nv * len(pairs) * WR * WR
        part = torch.empty((nchunks, S), device=alpha.device)
        out = torch.empty(S, device=alpha.device)
        code = lib.adjoint_launch(T.data_ptr(), flag, alpha.data_ptr(), WR, n, nv, pr, len(pairs), sg, 0,
                                  part.data_ptr(), nchunks, chunk, out.data_ptr(), cb._stream(alpha))
        assert code == 0, code
        return out.reshape(nv, len(pairs), WR, WR)

    def fwd(G2):
        y = torch.empty((G2.shape[0], n), device=G2.device)
        g1 = torch.zeros(1, device=G2.device)
        code = lib.forward_launch(T.data_ptr(), flag, WR, n, pr, len(pairs), G2.data_ptr(), sg, 0, g1.data_ptr(),
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


def _ab_row(name, new, old, flat_new, flat_old):
    """One A/B row: old against new, then times old, new, new, old."""
    row = {"call": name}
    if old is not None:
        got, want = flat_new(new()), flat_old(old())
        row["rel_old_new"] = float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))
        t = [cs.cuda_ms(old), cs.cuda_ms(new), cs.cuda_ms(new), cs.cuda_ms(old)]
        row.update(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]], ratio_old_over_new=(t[0] + t[3]) / (t[1] + t[2]))
    else:
        row["new_ms"] = [cs.cuda_ms(new)]
    print(f"[ab] {json.dumps(row)}", flush=True)
    return row


def ab_regen(old_lib, X):
    """The regenerating adjoint and forward, current against old, at
    [kernels-regen]'s shapes (random weights for the forward)."""
    from nfft4gp_torch.ops import _cuda_build as cb
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    lay = fs._packed_layout(cs._plan(X, cs.WINDOWS_FUSED))
    P = fs._nmodes(cs.FASTSUM_N)
    W2 = 2 * P
    xT, pairs, singles = lay.xT, lay.pairs, lay.singles
    n = xT.shape[1]
    gen = torch.Generator(device=X.device).manual_seed(3)
    rows = []
    for phase_gen in pk.PHASE_GENS:
        code = cb.PHASE_GEN_CODES[phase_gen]
        for nv in NVS:
            alpha = torch.randn((nv, n), generator=gen, device=X.device)

            def new(alpha=alpha, phase_gen=phase_gen):
                return pk.packed_adjoint_regen(xT, alpha, P=P, pairs=pairs, singles=singles, phase_gen=phase_gen)

            def old(alpha=alpha, code=code):
                return cb._adjoint_tc(old_lib, "adjoint_launch", "old packed_adjoint_regen", xT, code, alpha, W2,
                                      n, pairs, singles)

            rows.append(_ab_row(f"adjoint_regen {phase_gen} nv={nv}", new, old if old_lib else None,
                                lambda r: torch.cat([torch.stack(v, 1).reshape(-1) for v in r if v]),
                                lambda r: torch.cat([v.reshape(-1) for v in r])))
        for nsets in NSETS:
            G2 = torch.randn((nsets, len(pairs), W2, W2), generator=gen, device=X.device)
            G1 = torch.randn((nsets, len(singles), W2), generator=gen, device=X.device)

            def new(G2=G2, G1=G1, phase_gen=phase_gen):
                return pk.packed_forward_regen(xT, list(torch.unbind(G2, 1)), list(torch.unbind(G1, 1)), P=P,
                                               pairs=pairs, singles=singles, phase_gen=phase_gen)

            def old(G2=G2, G1=G1, code=code):
                return _old_forward(old_lib, "old packed_forward_regen", xT, code, G2, G1, W2, n, pairs, singles)

            rows.append(_ab_row(f"forward_regen {phase_gen} nsets={nsets}", new, old if old_lib else None,
                                lambda r: torch.stack(r).reshape(-1), lambda r: r.reshape(-1)))
    return rows


# the earliest wide library's source kinds: 0 float32 table, 1 bf16 table,
# 2 doubling, 3 direct (coordinates as the source)
OLD_WIDE_KINDS = {"table_f32": 0, "table_bf16": 1, "doubling": 2, "direct": 3}


def _old_wide_chunks(WR, nv, n, npairs):
    """(nchunks, chunk) of the CUDA-core wide adjoint of an earlier source
    (its 64 x 64 output tiles of every window, about eight blocks an SM),
    as its wrapper chunked it."""
    from nfft4gp_torch.ops import _cuda_build as cb

    per_chunk = -(-WR // 64) * npairs * -(-nv * WR // 64)
    return cb._chunks(n, per_chunk, 1056)


def old_wide_calls(lib, src, kind, WR, pairs):
    """The earlier wide kernels' adjoint(alpha) -> (nv, npairs, WR, WR) and
    forward(G2) -> (nsets, n) on a table (Dtot, WR, n) or coordinates
    (Dtot, n), chunked as their wrapper chunked them; for a library with a
    phase slab (its own wide_phases_launch) the current library writes the
    slab each call (the same formulas; its interface changed between
    builds) and the old kernels run their float32-table GEMMs on it."""
    from nfft4gp_torch.ops import _cuda_build as cb

    n = src.shape[-1]
    stride = src.stride(1) if src.ndim == 3 else src.stride(0)
    pr, sg = cb._ints(v for p in pairs for v in p), cb._ints(())
    slab = hasattr(lib, "wide_phases_launch") and src.ndim == 2

    def source():
        """(kind code, pointer, row stride) of one call's phase source."""
        if not slab:
            return OLD_WIDE_KINDS[kind], src, stride
        ph = cb.phases_wide(src, WR // 2, kind)
        return 0, ph, ph.stride(1)

    def adj(alpha):
        nv = alpha.shape[0]
        nchunks, chunk = _old_wide_chunks(WR, nv, n, len(pairs))
        S = nv * len(pairs) * WR * WR
        part = torch.empty((nchunks, S), device=alpha.device)
        out = torch.empty(S, device=alpha.device)
        k, ph, st = source()
        code = lib.wide_adjoint_launch(k, ph.data_ptr(), st, alpha.data_ptr(), WR, n, nv, pr, len(pairs), sg, 0,
                                       part.data_ptr(), nchunks, chunk, out.data_ptr(), cb._stream(alpha))
        assert code == 0, code
        return out.reshape(nv, len(pairs), WR, WR)

    def fwd(G2):
        y = torch.empty((G2.shape[0], n), device=G2.device)
        g1 = torch.zeros(1, device=G2.device)
        k, ph, st = source()
        if lib.forward == "split":
            gs = torch.empty((2, *G2.shape[:3], -(-WR // 4) * 4), device=G2.device)
            code = lib.wide_split_weights_launch(G2.data_ptr(), *G2.stride()[:3], WR, len(pairs), G2.shape[0],
                                                 gs.data_ptr(), cb._stream(G2))
            assert code == 0, code
            code = lib.wide_forward_launch(k, ph.data_ptr(), st, WR, n, pr, len(pairs), gs.data_ptr(), sg, 0,
                                           g1.data_ptr(), G2.shape[0], y.data_ptr(), cb._stream(G2))
        elif lib.forward == "strided":
            rows = G2
            if WR % 4:  # 16-byte rows, as its wrapper padded them
                rows = G2.new_zeros((*G2.shape[:3], -(-WR // 4) * 4))[..., :WR]
                rows.copy_(G2)
            code = lib.wide_forward_launch(k, ph.data_ptr(), st, WR, n, pr, len(pairs), rows.data_ptr(),
                                           *rows.stride()[:3], sg, 0, g1.data_ptr(), G2.shape[0], y.data_ptr(),
                                           cb._stream(G2))
        else:
            code = lib.wide_forward_launch(k, ph.data_ptr(), st, WR, n, pr, len(pairs), G2.data_ptr(), sg, 0,
                                           g1.data_ptr(), G2.shape[0], y.data_ptr(), cb._stream(G2))
        assert code == 0, code
        return y

    return adj, fwd


def ab_wide(old_lib, X):
    """The wide adjoint and forward, current against old, at [wide-train]'s
    shapes (random weights for the forward)."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    Xw = X[:cs.N_WIDE_TRAIN]
    N = cs.WIDE_TRAIN_N
    pn = fs.packed_ndft_plan(cs._plan(Xw, cs.WINDOWS, N=N), table_dtype=torch.bfloat16)
    lay = fs._packed_layout(cs._plan(Xw, cs.WINDOWS, N=N))
    P = fs._nmodes(N)
    gen = torch.Generator(device=X.device).manual_seed(3)
    rows = []
    pa = fs.packed_ndft_plan(cs._plan(Xw[:, :2].contiguous(), [[0, 1]], N=256), table_dtype=torch.float32)
    old_adj, old_fwd = old_wide_calls(old_lib, pa.Tp, "table_f32", 256, pa.pairs) if old_lib else (None, None)
    for nv in NVS:
        alpha = torch.randn((nv, Xw.shape[0]), generator=gen, device=X.device)
        rows.append(_ab_row(f"adjoint table_f32@2P=256 nv={nv}",
                            (lambda a: lambda: pk.packed_adjoint(pa.Tp, a, pairs=pa.pairs))(alpha),
                            (lambda a: lambda: old_adj(a))(alpha) if old_lib else None,
                            lambda r: torch.stack(r[0], 1).reshape(-1), lambda r: r.reshape(-1)))
    for nsets in NSETS:
        G2 = torch.randn((nsets, 1, 256, 256), generator=gen, device=X.device)
        rows.append(_ab_row(f"forward table_f32@2P=256 nsets={nsets}",
                            (lambda g: lambda: pk.packed_forward(pa.Tp, list(torch.unbind(g, 1)), pairs=pa.pairs))(G2),
                            (lambda g: lambda: old_fwd(g))(G2) if old_lib else None,
                            lambda r: torch.stack(r).reshape(-1), lambda r: r.reshape(-1)))
    for kind in ("table_bf16", *pk.PHASE_GENS):
        src = pn.Tp if kind == "table_bf16" else lay.xT
        pairs = pn.pairs if kind == "table_bf16" else lay.pairs
        W2 = src.shape[1] if kind == "table_bf16" else 2 * P
        old_adj, old_fwd = old_wide_calls(old_lib, src, kind, W2, pairs) if old_lib else (None, None)
        for nv in NVS:
            alpha = torch.randn((nv, Xw.shape[0]), generator=gen, device=X.device)
            if kind == "table_bf16":
                new = (lambda a: lambda: pk.packed_adjoint(src, a, pairs=pairs))(alpha)
            else:
                new = (lambda a, g: lambda: pk.packed_adjoint_regen(src, a, P=P, pairs=pairs, phase_gen=g))(alpha,
                                                                                                            kind)
            old = (lambda a: lambda: old_adj(a))(alpha) if old_lib else None
            rows.append(_ab_row(f"adjoint {kind}@2P={W2} nv={nv}", new, old,
                                lambda r: torch.stack(r[0], 1).reshape(-1), lambda r: r.reshape(-1)))
        for nsets in NSETS:
            G2 = torch.randn((nsets, len(pairs), W2, W2), generator=gen, device=X.device)
            G2s = list(torch.unbind(G2, 1))
            if kind == "table_bf16":
                new = (lambda g: lambda: pk.packed_forward(src, g, pairs=pairs))(G2s)
            else:
                new = (lambda g, k: lambda: pk.packed_forward_regen(src, g, P=P, pairs=pairs, phase_gen=k))(G2s,
                                                                                                           kind)
            old = (lambda g: lambda: old_fwd(g))(G2) if old_lib else None
            rows.append(_ab_row(f"forward {kind}@2P={W2} nsets={nsets}", new, old,
                                lambda r: torch.stack(r).reshape(-1), lambda r: r.reshape(-1)))
    return rows


# the float32-table shapes: 2P, the adjoint's right-hand sides and the
# forward's weight sets, and the layouts at n = N_AFN_PCG: [afn-pcg]'s one
# pair and the AFN-PCG bench's default (d = 10: five 2-D windows)
F32_WIDTHS = (16, 32)
F32_NVS = (1, 2, 4, 10, 16)
F32_NSETS = (1, 2, 4, 10, 20)
F32_LAYOUTS = {"1 pair": [[0, 1]], "5 pairs": cs.WINDOWS}
# the tables that fit the H100's 50 MB L2 are also timed cold
L2_BYTES = 50e6


def _turns(fns, cold):
    """{name: [ms, ms]}: each fn timed twice, in turns (the order of fns,
    then reversed), by cuda_ms (cold: the L2 flushed before every call)."""
    times = {}
    for name in list(fns) + list(fns)[::-1]:
        times.setdefault(name, []).append(cs.cuda_ms(fns[name], cold=cold))
    return times


def _f32_row(call, fns, yardsticks, want, flat, flops, f32_flops, nbytes, route):
    """One [f32] row: every kernel of fns against the plain version (relative
    Frobenius), then the kernels and the yardsticks (timed only: their
    outputs are not the function's) timed warm and, where the inputs fit L2,
    cold, in turns.  The bound of each kernel on the units it runs on (as
    chip_smoke.py `bound`: bytes of the whole table, alpha or y and the
    outputs, or its operations: flops of the 2-D window products plus
    f32_flops, all at the 67 TFLOP/s float32 peak on the CUDA cores; the wide
    pair's products in 3xTF32 at a third of the 495 TFLOP/s TF32 peak beside
    f32_flops on the CUDA cores) and its share of it, from its cold time
    where there is one."""
    row = {"call": call, "route": route,
           "rel_err": {k: float(torch.linalg.norm((flat(f()) - want).double()) / torch.linalg.norm(want.double()))
                       for k, f in fns.items()}}
    timed = {**fns, **yardsticks}
    warm = _turns(timed, False)
    cold = _turns(timed, True) if nbytes <= L2_BYTES else None
    bounds = {k: cs.bound(flops, nbytes, F32_UNITS.get(k, "f32"), f32_flops=f32_flops) for k in fns}
    row.update(warm_ms=warm, cold_ms=cold, bound_ms={k: b[0] for k, b in bounds.items()},
               bound_by={k: b[1] for k, b in bounds.items()},
               median_ms={k: float(np.median((cold or warm)[k])) for k in timed})
    row["share"] = {k: bounds[k][0] / row["median_ms"][k] for k in fns}
    print(f"[f32] {json.dumps(row)}", flush=True)
    return row


# the units (chip_smoke.py PEAKS) of the f32 rows' kernels other than the
# CUDA-core ones
F32_UNITS = {"wide": "wgmma_tf32x3"}


def build_stream_only() -> ctypes.CDLL:
    """The current csrc/packed_ndft.cu built with F32_STREAM_ONLY=1 (its
    consumers free each stage unread: the kernels' data path alone), with
    the current library's interface."""
    from nfft4gp_torch.ops import _cuda_build as cb

    out = ROOT / "_chip_scratch" / "ab_build" / "libpacked_ndft_stream_only.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-DF32_STREAM_ONLY=1", "-I", str(cb.CSRC), "-o", str(out),
                    str(cb.SOURCES["packed_ndft"])], check=True)
    lib = ctypes.CDLL(str(out))
    cb._ndft_signatures(lib)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _with_library(cb, lib, fn, name="packed_ndft"):
    """fn run with `lib` in place of the library `name`."""
    def call():
        real = cb.library
        cb.library = lambda which: lib if which == name else real(which)
        try:
            return fn()
        finally:
            cb.library = real
    return call


def ab_f32(old_lib, X):
    """The float32-table adjoint and forward at 2P = 16 and 32: the
    current float32-table kernels ("f32", csrc/packed_ndft.cu, called
    directly) and the wide pair ("wide", csrc/packed_ndft_wide.cu, called
    directly), the einsum yardstick and, given old_lib, an earlier
    csrc/packed_ndft.cu ("old"), at the shapes of F32_LAYOUTS, F32_NVS and
    F32_NSETS (random weights for the forward); each row names the kernel
    that the wrappers' route rule picks (`table_route`).  Beside them, timed
    only, the yardsticks of the table's read: "stream_only" (the current
    kernels built with F32_STREAM_ONLY=1), "table_sum" (torch.sum: one read
    of the table) and "table_clone" (a read and a write)."""
    from nfft4gp_torch.ops import _cuda_build as cb
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    stream_lib = build_stream_only()
    Xn = X[:cs.N_AFN_PCG]
    n = Xn.shape[0]
    gen = torch.Generator(device=X.device).manual_seed(13)
    rows = []
    for lname, windows in F32_LAYOUTS.items():
        d = 1 + max(max(w) for w in windows)
        for W2 in F32_WIDTHS:
            pn = fs.packed_ndft_plan(cs._plan(Xn[:, :d].contiguous(), windows, N=W2), table_dtype=torch.float32)
            Tp, pairs = pn.Tp, pn.pairs
            npairs, tbytes = len(pairs), Tp.numel() * 4
            old_adj, old_fwd = old_calls(old_lib, Tp, pairs, flag=None) if old_lib else (None, None)
            lib_adj, lib_fwd = cs.library_calls(Tp, pairs, ())
            reads = {"table_sum": Tp.sum, "table_clone": Tp.clone}
            for nv in F32_NVS:
                alpha = torch.randn((nv, n), generator=gen, device=X.device)
                fns = {"f32": lambda a=alpha: cb.adjoint(Tp, a, pairs, ())[0],
                       "wide": lambda a=alpha: pk._adjoint_wide(Tp, a, pairs, ())[0],
                       "einsum": lambda a=alpha: lib_adj(a)[0]}
                if old_lib:
                    fns = {"old": lambda a=alpha: old_adj(a), **fns}
                yard = {"stream_only": _with_library(cb, stream_lib, lambda a=alpha: cb.adjoint(Tp, a, pairs, ())),
                        **reads}
                rows.append(_f32_row(f"adjoint {lname} 2P={W2} nv={nv}", fns, yard,
                                     pk.packed_adjoint_plain(Tp, alpha, pairs, ())[0].reshape(-1),
                                     lambda r: r.reshape(-1), 2.0 * n * nv * npairs * W2 * W2, 0.0,
                                     tbytes + 4 * (nv * n + nv * npairs * W2 * W2),
                                     _route_name(pk, W2, "adjoint", nv)))
            for nsets in F32_NSETS:
                G2 = torch.randn((nsets, npairs, W2, W2), generator=gen, device=X.device)
                G1 = torch.zeros((nsets, 0, W2), device=X.device)
                fns = {"f32": lambda g=G2, g1=G1: cb.forward(Tp, g, g1, pairs, ()),
                       "wide": lambda g=G2, g1=G1: pk._forward_wide(Tp, g, g1, pairs, ()),
                       "einsum": lambda g=G2: lib_fwd(g, None)}
                if old_lib:
                    fns = {"old": lambda g=G2: old_fwd(g), **fns}
                yard = {"stream_only": _with_library(cb, stream_lib,
                                                     lambda g=G2, g1=G1: cb.forward(Tp, g, g1, pairs, ())),
                        **reads}
                rows.append(_f32_row(f"forward {lname} 2P={W2} nsets={nsets}", fns, yard,
                                     pk.packed_forward_plain(Tp, G2, None, pairs, ()).reshape(-1),
                                     lambda r: r.reshape(-1), 2.0 * nsets * n * npairs * W2 * W2,
                                     2.0 * nsets * n * npairs * W2,
                                     tbytes + 4 * (nsets * npairs * W2 * W2 + nsets * n),
                                     _route_name(pk, W2, "forward", nsets)))
    return rows


def _route_name(pk, W2, op, count):
    """The kernel the wrappers' route rule picks for a float32 table."""
    return pk.table_route(W2, torch.float32, op, count)


def trees_f32(old_tree):
    """[afn-pcg]'s solve at N = 32 on float32 tables, AFN-PCG through
    scripts/torch_afn_pcg_trees.py (AFN_PCG.md section 3's row with --N 32),
    with the package of old_tree and of this checkout, each in its own
    process, in turns (old, this, this, old): ms per iteration, host clock."""
    script = ROOT / "scripts" / "torch_afn_pcg_trees.py"
    runs = []
    for label, tree in (("old", old_tree), ("this", ROOT), ("this", ROOT), ("old", old_tree)):
        out = subprocess.run([sys.executable, str(script), "--tree", str(tree), "--label", label, "--", "--N", "32"],
                             capture_output=True, text=True, check=True).stdout
        runs.append(json.loads(out.strip().splitlines()[-1]))
        print(f"[trees] {json.dumps(runs[-1])}", flush=True)
    med = {k: [r["median_ms_per_iteration"] for r in runs if r["label"] == k] for k in ("old", "this")}
    row = {"call": "afn-pcg N=32 float32 tables, AFN-PCG ms per iteration (host clock; the solve is host-bound)",
           "iterations": sorted({it for r in runs for it in r["iterations"]}), "median_ms_per_iteration": med}
    print(f"[ab] {json.dumps(row)}", flush=True)
    return row


# the simple rules the wide adjoint's chunk count (`wide_chunks`) is held
# against: the most chunks whose blocks fit `waves` waves of one block an SM
CHUNK_RULES = {"one wave": 1, "four waves": 4}


def ab_chunks(X):
    """The wide adjoint at its bounds-table shapes (chip_smoke.py
    WIDE_BOUND_SHAPES; nv = 1, 10) with its chunk count from `wide_chunks`
    (the current rule) and from each simple rule of CHUNK_RULES (the
    wrapper's `wide_chunks` swapped for the call), timed in turns (current,
    rules..., rules reversed, current); the outputs' relative difference."""
    from nfft4gp_torch.ops import _cuda_build as cb
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops import packed_ndft as pk

    current = cb.wide_chunks
    sms = cb._sm_count(X.device)

    def rule(waves):
        def chunks(WR, nv, n, npairs, nsingles, sms_):
            _, ntn, mblocks = cb.wide_tiles(WR, nv)
            return cb._chunks(n, npairs * ntn * mblocks, waves * sms_)
        return chunks

    def swapped(fn, chunks):
        def call():
            cb.wide_chunks = chunks
            try:
                return fn()
            finally:
                cb.wide_chunks = current
        return call

    Xw = X[:cs.N_WIDE_TRAIN]
    pa = fs.packed_ndft_plan(cs._plan(X[:cs.N_AFN_PCG, :2].contiguous(), [[0, 1]], N=256), table_dtype=torch.float32)
    pn = fs.packed_ndft_plan(cs._plan(Xw, cs.WINDOWS, N=cs.WIDE_TRAIN_N), table_dtype=torch.bfloat16)
    lay = fs._packed_layout(cs._plan(Xw, cs.WINDOWS, N=cs.WIDE_TRAIN_N))
    P = fs._nmodes(cs.WIDE_TRAIN_N)
    shapes = {"afn-pcg-256 f32 1 pair 2P=256": (lambda a: pk.packed_adjoint(pa.Tp, a, pairs=pa.pairs), 256, 1),
              "wide-train bf16 5 pairs 2P=128": (lambda a: pk.packed_adjoint(pn.Tp, a, pairs=pn.pairs), 128, 5),
              "wide-train doubling slab 5 pairs 2P=130": (lambda a: pk.packed_adjoint_regen(
                  lay.xT, a, P=P, pairs=lay.pairs, phase_gen="doubling"), 2 * P, 5)}
    gen = torch.Generator(device=X.device).manual_seed(5)
    rows = []
    for key, (adj, W2, npairs) in shapes.items():
        n = cs.N_AFN_PCG if W2 == 256 else cs.N_WIDE_TRAIN
        for nv in NVS:
            alpha = torch.randn((nv, n), generator=gen, device=X.device)
            fns = {"current": lambda a=alpha: adj(a)}
            fns.update({name: swapped(lambda a=alpha: adj(a), rule(w)) for name, w in CHUNK_RULES.items()})
            want = torch.stack(fns["current"]()[0], 1)
            row = {"call": f"{key} nv={nv}", "sms": sms,
                   "nchunks": {"current": current(W2, nv, n, npairs, 0, sms)[0],
                               **{name: rule(w)(W2, nv, n, npairs, 0, sms)[0] for name, w in CHUNK_RULES.items()}},
                   "rel_to_current": {name: float(torch.linalg.norm((torch.stack(fns[name]()[0], 1) - want).double())
                                                  / torch.linalg.norm(want.double())) for name in CHUNK_RULES}}
            order = list(fns) + list(fns)[::-1]
            times = {}
            for name in order:
                times.setdefault(name, []).append(cs.cuda_ms(fns[name]))
            row["ms"] = times
            row["ratio_over_current"] = {name: sum(times[name]) / sum(times["current"]) for name in CHUNK_RULES}
            print(f"[chunks] {json.dumps(row)}", flush=True)
            rows.append(row)
    return rows


def _device_summary(prof, wall_ms):
    """Device-busy time (the union of the device kernels' intervals), its
    share of wall_ms, and the device time by kernel."""
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
    return (busy / 1e3 if spans else None, busy / 1e3 / wall_ms if spans else None, len(spans), by_kernel)


def afn_pcg_256(old_lib):
    """chip_smoke.py's [afn-pcg-256] AFN-PCG solve (AFN_PCG.md section 3's
    row through scripts/torch_afn_pcg_bench.py), set up once.  Times the
    whole solve (host clock, synchronized) with the current wide forward
    and, given old_lib, with the old one in its place (the same operator
    otherwise), in turns old, new, new, old three times; then profiles one
    solve with the current kernels (`profile_afn_pcg_256`)."""
    from nfft4gp_torch.ops import _cuda_build as cb
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    bench = cs._bench_module()
    args = bench.parse_args(cs.AFN_PCG_256_ARGV)
    dev = torch.device("cuda:0")
    X, b, dtype = bench.make_problem(args, dev)
    params = KernelParams.make(1.0, args.l, args.mu, dtype=dtype, device=dev)
    windows = make_windows(bench.windows_of(args.d))
    mv, _ = bench.build_operator(args, X, params, windows, log=lambda m: None)
    (_, _, pre, _), = bench.preconditioners(args, X, params, windows, ["afn"])
    new_forward = cb.forward_wide

    def old_forward(Tp, G2, G1, pairs, singles):
        _, fwd = old_wide_calls(old_lib, Tp, "table_f32", Tp.shape[1], pairs)
        return fwd(G2.contiguous())

    def timed(forward):
        cb.forward_wide = forward
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = bench.solve(args, mv, b, pre, "pcg")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, int(res.niter)
        finally:
            cb.forward_wide = new_forward

    row = {"call": "afn-pcg-256 AFN-PCG solve, ms per iteration (host clock), old and new wide forward"}
    timed(new_forward)
    if old_lib is not None:
        timed(old_forward)
        runs = [timed(f) for _ in range(3) for f in (old_forward, new_forward, new_forward, old_forward)]
        old = [ms / it for k, (ms, it) in enumerate(runs) if k % 4 in (0, 3)]
        new = [ms / it for k, (ms, it) in enumerate(runs) if k % 4 in (1, 2)]
        row.update(iterations=sorted({it for _, it in runs}), old_ms=old, new_ms=new,
                   old_median=float(np.median(old)), new_median=float(np.median(new)))
    print(f"[ab] {json.dumps(row)}", flush=True)
    return row, profile_afn_pcg_256(args, bench, mv, b, pre)


def profile_afn_pcg_256(args, bench, mv, b, pre):
    """One AFN-PCG solve, profiled after a warm-up solve: wall time,
    iterations, device-busy share, the device time by kernel and the wide
    kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    bench.solve(args, mv, b, pre, "pcg")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = bench.solve(args, mv, b, pre, "pcg")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, share, nk, by_kernel = _device_summary(prof, wall_ms)
    wide = {k: v for k, v in by_kernel.items() if "wide" in k or "reduce_slices" in k}
    out = {"problem": "afn-pcg-256", "iterations": int(res.niter), "wall_ms": wall_ms,
           "ms_per_iteration": wall_ms / max(int(res.niter), 1), "device_busy_ms": busy, "busy_share": share,
           "device_kernels": nk, "device_ms_by_kernel": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]),
           "wide_kernels_ms": sum(wide.values()), "wide_share_of_wall": sum(wide.values()) / wall_ms}
    print(f"[profile] {json.dumps(out)}", flush=True)
    return out


def profile_step(X, y, kernels):
    from torch.profiler import ProfilerActivity, profile

    from nfft4gp_torch.models.problem import GPProblem
    from nfft4gp_torch.models.transforms import transform_inverse

    if kernels == "regen":
        prob = GPProblem(fastsum_fused=True, **cs.FUSED)
    elif kernels in ("wide-stream", "wide-fused"):
        X, y = X[:cs.N_WIDE_TRAIN], y[:cs.N_WIDE_TRAIN]
        prob = GPProblem(**cs.WIDE_TRAIN, **({"fastsum_fused": True} if kernels == "wide-fused" else {}))
    else:
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
    busy, share, nk, by_kernel = _device_summary(prof, wall_ms)
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    # the NDFT kernels of the port by name (csrc/), whether in the top or not
    ndft = {k: v for k, v in by_kernel.items()
            if any(s in k for s in ("adjoint", "forward", "reduce_slices", "split_", "phases"))}
    wide = {k: v for k, v in ndft.items() if "wide" in k}
    out = {"problem": kernels, "loss": float(loss), "wall_ms": wall_ms,
           "device_busy_ms": busy, "busy_share": share,
           "device_kernels": nk, "device_ms_by_kernel": top, "ndft_kernels_ms": ndft,
           "wide_kernels_ms": sum(wide.values()),
           "wide_share_of_wall": sum(wide.values()) / wall_ms}
    print(f"[profile] {json.dumps(out)}", flush=True)
    return out


def _old_dense_signatures(lib):
    """The earlier fused_pcg.cu: fused_pcg_grid / fused_lanczos_grid(n, *grid)
    and launches that take the grid and one scratch buffer."""
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.fused_pcg_grid.argtypes = [I, IP]
    lib.fused_pcg_launch.argtypes = [P, P, I, I, ctypes.c_float, I, P, P, P, P, P]
    lib.fused_lanczos_grid.argtypes = [I, IP]
    lib.fused_lanczos_launch.argtypes = [P, P, I, I, I, I, P, P, P, P, P, P]
    for fn in (lib.fused_pcg_grid, lib.fused_pcg_launch, lib.fused_lanczos_grid, lib.fused_lanczos_launch):
        fn.restype = I


def old_dense_calls(lib, dev):
    """The earlier kernels' CG (K, b, maxits, tol) -> (x, relres, niter) and
    Lanczos (K, Z, maxits) -> (alpha, beta, V, beta0), as their wrapper
    launched them."""
    from nfft4gp_torch.ops import _cuda_build as cb

    def grid(query, n):
        g = ctypes.c_int(0)
        cb._check(lib, getattr(lib, query)(n, ctypes.byref(g)), query)
        return g.value

    def pcg(K, b, maxits, tol):
        n = b.shape[0]
        G = grid("fused_pcg_grid", n)
        x = torch.empty(n, device=dev)
        scratch = torch.empty(3 * n + 2 * G, device=dev)
        relres = torch.empty((), device=dev)
        niter = torch.empty((), dtype=torch.int32, device=dev)
        cb._check(lib, lib.fused_pcg_launch(K.data_ptr(), b.data_ptr(), n, maxits, float(tol * tol), G, x.data_ptr(),
                                            scratch.data_ptr(), relres.data_ptr(), niter.data_ptr(), cb._stream(b)),
                  "old fused_pcg")
        return x, relres, niter

    def lanczos(K, Z, maxits):
        nv, n = Z.shape
        G = grid("fused_lanczos_grid", n)
        alpha = torch.ones((nv, maxits), device=dev)
        beta = torch.zeros((nv, maxits - 1), device=dev)
        V = torch.zeros((nv, maxits + 1, n), device=dev)
        beta0 = torch.empty(nv, device=dev)
        scratch = torch.empty(nv * n + G * nv * (2 * maxits + 3), device=dev)
        cb._check(lib, lib.fused_lanczos_launch(K.data_ptr(), Z.data_ptr(), n, nv, maxits, G, alpha.data_ptr(),
                                                beta.data_ptr(), V.data_ptr(), beta0.data_ptr(), scratch.data_ptr(),
                                                cb._stream(Z)), "old fused_lanczos")
        return alpha, beta, V, beta0

    return pcg, lanczos


def _dense_problems(dev):
    """chip_smoke.py check_dense_kernels' inputs at DENSE_AB_NS (its shapes
    and an n that is no multiple of 4): {(n, mu): (K, y)} and {n: Z}."""
    from nfft4gp_torch.ops.kernels import KernelParams, additive_kernel_matrix, make_windows
    from nfft4gp_torch.solvers.lanczos import rademacher_probes

    X, y = cs.make_data(max(DENSE_AB_NS))
    W = make_windows(cs.WINDOWS)
    probs = {}
    for n in DENSE_AB_NS:
        for mu in cs.DENSE_MUS if n in cs.DENSE_NS else cs.DENSE_MUS[:1]:
            p = KernelParams.make(1.0, 0.5, mu, dtype=torch.float32, device=dev)
            probs[n, mu] = (additive_kernel_matrix("gaussian", p, X[:n], W).contiguous(), y[:n].contiguous())
    gen = torch.Generator(device=dev).manual_seed(2)
    Zs = {n: rademacher_probes(gen, cs.SLQ_NV, n, dtype=torch.float32) for n in DENSE_AB_NS}
    return probs, Zs


# chip_smoke.py's [dense-kernels] n, and one whose K rows the wrappers pad
# to a multiple of 4 floats (a copy of K each call; PR 3's kernels read it
# in place)
DENSE_AB_NS = (2048, 2049, 4096)

# The timed copy of csrc/fused_pcg.cu: its `// @phase:` lines uncommented,
# block 0 writing the globaltimer at each into g_phase[kernel][step][mark],
# read back by fused_phase_times.
PHASE_STEPS, PHASE_MARKS = 256, 12
PHASE_DEFS = f"""
constexpr int PH_STEPS = {PHASE_STEPS}, PH_N = {PHASE_MARKS};
__device__ unsigned long long g_phase[2][PH_STEPS][PH_N];
__device__ __forceinline__ void phase(int kernel, int it, int k) {{
  if (blockIdx.x == 0 && threadIdx.x == 0 && it < PH_STEPS) {{
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_phase[kernel][it][k] = ns;
  }}
}}
"""
PHASE_READ = """
extern "C" int fused_phase_times(unsigned long long* host, int kernel) {
  const size_t bytes = sizeof(unsigned long long) * PH_STEPS * PH_N;
  return (int)cudaMemcpyFromSymbol(host, g_phase, bytes, bytes * kernel, cudaMemcpyDeviceToHost);
}
"""
PHASE_ANCHOR = "// @phase: "
INCLUDE_LAST = '#include "tma_common.cuh"\n'


def phase_timed_source(src: str) -> str:
    """csrc/fused_pcg.cu's text with its phase marks switched on (above).
    Raises ValueError where the source has no marks or no place for them."""
    if PHASE_ANCHOR not in src or src.count(INCLUDE_LAST) != 1:
        raise ValueError("fused_pcg.cu: no `// @phase:` marks, or no tma_common.cuh include to put them after")
    src = src.replace(PHASE_ANCHOR, "")
    return src.replace(INCLUDE_LAST, INCLUDE_LAST + PHASE_DEFS) + PHASE_READ


def build_phase_timed() -> ctypes.CDLL:
    """The timed copy of the current csrc/fused_pcg.cu (`phase_timed_source`),
    built into _chip_scratch/ab_build/ with the current library's interface."""
    from nfft4gp_torch.ops import _cuda_build as cb

    out = ROOT / "_chip_scratch" / "ab_build" / "libfused_pcg_phases.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_name("fused_pcg_phases.cu")
    src.write_text(phase_timed_source(cb.SOURCES["fused_pcg"].read_text()))
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC), "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    cb._fused_pcg_signatures(lib)
    lib.fused_phase_times.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fused_phase_times.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


# Yardsticks of the fused kernels' design, built into _chip_scratch/ab_build/:
# - reread_probe_launch: `passes` cyclic re-reads of a buffer by four
#   512-thread blocks an SM (16-byte loads through L2, eight in flight a
#   thread): how fast K's streamed part can come back each step;
# - cluster_coop_probe: whether a cooperative launch (cudaLaunchKernelEx
#   with cudaLaunchAttributeCooperative) also takes a cluster dimension, as
#   TMA multicast of v_it to a cluster's blocks would need; the largest
#   number of such clusters co-resident (cudaOccupancyMaxActiveClusters),
#   the launch's code, and whether a counter grid barrier (the fused
#   kernels' kind) held in it and every block saw a cluster of the size
#   asked for.
PROBES_CU = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(512) reread_probe_kernel(const float4* __restrict__ buf, long long n4, int passes,
                                                           float* out) {
  float acc = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 8
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
      const float4 v = __ldcg(buf + i);
      acc += v.x + v.y + v.z + v.w;
    }
  }
  if (acc == -1.f) out[0] = acc;  // keeps the loads
}

// check[1 + b] = b + 1 and sizes[b] = the block's cluster size; then a
// counter barrier over the grid (every block co-resident; the wait is
// bounded, so a grid that is not cannot hang), after which block 0 writes
// the sum of check[1..] to check[0]
__global__ void cluster_grid_kernel(unsigned* counter, int* check, int* sizes) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
    check[1 + blockIdx.x] = blockIdx.x + 1;
    sizes[blockIdx.x] = (int)cluster.num_blocks();
    __threadfence();
    atomicAdd(counter, 1u);
    for (int spins = 0; atomicAdd(counter, 0u) < gridDim.x && spins < (1 << 22); ++spins) {
    }
  }
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < (int)gridDim.x; ++k) total += __ldcg(check + 1 + k);
    check[0] = total;
  }
}

extern "C" {

int reread_probe_launch(const float* buf, long long n4, int passes, float* out, void* stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  reread_probe_kernel<<<4 * sms, 512, 0, static_cast<cudaStream_t>(stream)>>>(reinterpret_cast<const float4*>(buf),
                                                                             n4, passes, out);
  return (int)cudaGetLastError();
}

// *max_clusters: co-resident clusters of `cluster` 256-thread blocks with
// smem bytes each (or 0); *query: that query's code.  Launches
// `clusters` x `cluster` blocks cooperatively with the cluster dimension
// when clusters > 0 and returns the launch's code (counter: zero; check:
// 1 + blocks ints, zero; sizes: blocks ints).
int cluster_coop_probe(int cluster, int clusters, int smem, int* max_clusters, int* query, unsigned* counter,
                       int* check, int* sizes, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(cluster_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster > 8) {
    e = cudaFuncSetAttribute(cluster_grid_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * (clusters > 0 ? clusters : 1));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  *max_clusters = 0;
  *query = (int)cudaOccupancyMaxActiveClusters(max_clusters, (void*)cluster_grid_kernel, &cfg);
  cudaGetLastError();
  if (clusters <= 0) return 0;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, cluster_grid_kernel, counter, check, sizes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  e = cudaStreamSynchronize(cfg.stream);
  return (int)e;
}

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
"""


def build_probes() -> ctypes.CDLL:
    """PROBES_CU built into _chip_scratch/ab_build/."""
    from nfft4gp_torch.ops import _cuda_build as cb

    out = ROOT / "_chip_scratch" / "ab_build" / "libdense_probes.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = out.with_name("dense_probes.cu")
    src.write_text(PROBES_CU)
    subprocess.run([cb._nvcc(), *cb.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.reread_probe_launch.argtypes = [P, ctypes.c_longlong, I, P, P]
    lib.cluster_coop_probe.argtypes = [I, I, I, P, P, P, P, P, P]
    lib.reread_probe_launch.restype = lib.cluster_coop_probe.restype = I
    lib.error_string.argtypes = [I]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def reread_GBps(lib, device, mbytes: float, passes: int = 10, reps: int = 5) -> float:
    """GB/s of a cyclic re-read of an `mbytes` MB buffer (reread_probe_launch):
    CUDA events around launches of 1 and 1 + passes passes, the median of
    `reps` each."""
    from nfft4gp_torch.ops import _cuda_build as cb

    n4 = int(mbytes * 1e6) // 16
    buf = torch.ones(4 * n4, dtype=torch.float32, device=device)
    out = torch.zeros(1, dtype=torch.float32, device=device)

    def timed(k):
        times = []
        for _ in range(reps + 1):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cb._check(lib, lib.reread_probe_launch(buf.data_ptr(), n4, k, out.data_ptr(), cb._stream(buf)),
                      "reread_probe")
            stop.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(stop))
        return sorted(times[1:])[reps // 2]

    return 16 * n4 * passes / ((timed(1 + passes) - timed(1)) * 1e6)


def cluster_coop(lib, device, smem: int) -> dict:
    """cluster_coop_probe at clusters of 2 and 4 blocks of `smem` bytes of
    shared memory: the co-resident clusters, then a cooperative launch of
    that many (at least one), its code and message, and whether the grid
    barrier held and every block was in a cluster of that size."""
    from nfft4gp_torch.ops import _cuda_build as cb

    out = {}
    for cluster in (2, 4):
        most, query = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            cb._check(lib, lib.cluster_coop_probe(cluster, 0, smem, ctypes.byref(most), ctypes.byref(query), None,
                                                  None, None, None), "cluster query")
        clusters = max(1, most.value)
        blocks = cluster * clusters
        counter = torch.zeros(1, dtype=torch.int32, device=device)
        check = torch.zeros(1 + blocks, dtype=torch.int32, device=device)
        sizes = torch.zeros(blocks, dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            code = lib.cluster_coop_probe(cluster, clusters, smem, ctypes.byref(most), ctypes.byref(query),
                                          counter.data_ptr(), check.data_ptr(), sizes.data_ptr(), cb._stream(check))
        torch.cuda.synchronize(device)
        row = {"max_active_clusters": most.value, "query_code": query.value, "blocks": blocks,
               "launch_code": code, "launch_message": lib.error_string(code).decode()}
        if code == 0:
            row["grid_barrier_held"] = int(check[0]) == blocks * (blocks + 1) // 2
            row["cluster_sizes_seen"] = sorted(set(sizes.tolist()))
        out[f"cluster={cluster} smem={smem}"] = row
    return out


# the phases of each kernel's step (csrc/fused_pcg.cu `// @phase:` marks):
# the interval names between consecutive marks, then the step-start barrier
PHASES = {0: ("matvec_resident", "matvec_streamed", "barrier", "pq+r_update+sums", "p_update"),
          1: ("product", "cgs1_partials+barrier", "cgs1_totals+update", "cgs2_partials+barrier",
              "cgs2_totals+update", "norm_partials+barrier", "norm_totals+v_next+outputs")}
# marks inside the Lanczos product: the first chunk arrived, the last one consumed
PRODUCT_MARKS = (8, 9)


def phase_times(lib, kernel, call, steps):
    """Block 0's microseconds a step by phase, the mean over `steps` steps of
    one `call` run with the phase-timed library in place of the built one."""
    from nfft4gp_torch.ops import _cuda_build as cb

    _with_library(cb, lib, call, name="fused_pcg")()
    torch.cuda.synchronize()
    raw = (ctypes.c_ulonglong * (PHASE_STEPS * PHASE_MARKS))()
    cb._check(lib, lib.fused_phase_times(raw, kernel), "fused_phase_times")
    t = np.array(raw, dtype=np.float64).reshape(PHASE_STEPS, PHASE_MARKS)[:min(steps, PHASE_STEPS)]
    names = PHASES[kernel]
    marks = t[:, :len(names) + 1]
    out = {name: float(np.mean(np.diff(marks, axis=1)[:, i]) / 1e3) for i, name in enumerate(names)}
    if kernel == 1:
        first, last = PRODUCT_MARKS
        out["product: first chunk"] = float(np.mean(t[:, first] - t[:, 0]) / 1e3)
        out["product: chunks"] = float(np.mean(t[:, last] - t[:, first]) / 1e3)
        out["product: reduction+w"] = float(np.mean(t[:, 1] - t[:, last]) / 1e3)
    if len(t) > 1:
        out["step_start_barrier"] = float(np.mean(t[1:, 0] - t[:-1, len(names)]) / 1e3)
    out["step_total"] = float(np.mean(np.diff(t[:, 0])) / 1e3) if len(t) > 1 else None
    return out


def cg_variant(plan, stages: int, smem_per_block: int):
    """`plan` (a streaming solvers/fused_pcg.py CgPlan) with a ring of `stages`
    one-row stages and, as cg_plan does, as many resident rows a block as
    the rest of `smem_per_block` holds."""
    from nfft4gp_torch.solvers import fused_pcg as fp

    row = plan.row_bytes
    base = fp.SMEM_SLACK + fp.CG_FIXED + row
    keep = (smem_per_block - base - stages * row) // row
    resident = tuple(min(plan.starts[b + 1] - plan.starts[b], keep) for b in range(plan.blocks))
    return dataclasses.replace(plan, resident=resident, stages=stages, smem=base + (stages + max(resident)) * row)


def lanczos_variant(plan, smem_per_block: int, *, own: bool, rows_per_group: int, stages: int):
    """`plan` (a solvers/fused_pcg.py LanczosPlan) made to stream as
    lanczos_plan's streaming branch does, but with the blocks' own columns
    of w and V in shared memory or not (`own`), chunks of `rows_per_group`
    rows a consumer column group and a ring of `stages` stages."""
    from nfft4gp_torch.solvers import fused_pcg as fp

    per = [plan.pstarts[b + 1] - plan.pstarts[b] for b in range(plan.blocks)]
    base = fp.SMEM_SLACK + fp.LZ_FIXED + (fp._own_bytes(max(per) * plan.width, plan.nv, plan.maxits) if own else 0)
    rows = min(256, rows_per_group * (fp.LZ_CONS // (plan.width // 4)))
    chunks = -(-plan.n // rows)
    chunk = 4 * rows * plan.width
    stage = 4 * rows * fp._nvp4(plan.nv) + chunk
    avail = smem_per_block - base - stages * stage
    if avail < 0:
        raise ValueError(f"{stages} stages of {rows} rows do not fit {smem_per_block} bytes")
    resident = tuple(min(chunks - 1, avail // (chunk * p)) for p in per)
    held = max(p * r for p, r in zip(per, resident))
    return dataclasses.replace(plan, chunk_rows=rows, resident=resident, stages=stages, own=own,
                               smem=base + stages * stage + held * chunk)


def ab_dense(old_lib, variants):
    """The fused CG and Lanczos kernels, current against old, at
    DENSE_AB_NS, after the yardsticks (module docstring)."""
    from nfft4gp_torch.ops import _cuda_build as cb
    from nfft4gp_torch.solvers import fused_pcg as fp

    dev = torch.device("cuda:0")
    sms, smem = cb.device_limits(dev)
    probes = build_probes()
    rows = []
    yard = {"sms": sms, "smem_per_block": smem, "barrier_us": {}, "reread_GBps": {}}
    for kind in ("pcg", "lanczos"):
        for n in cs.DENSE_NS:
            plan = cb._grid(kind, n, dev, cs.SLQ_NV, cs.SLQ_ITS)[0] if kind == "lanczos" else cb._grid(kind, n, dev)[0]
            threads = fp.LZ_CONS + 32 if kind == "lanczos" else fp.CG_CONS + (32 if plan.stages else 0)
            for bk, name in ((1, "counter"), (0, "grid_sync")):
                us, blocks, _ = cb.barrier_us(dev, bk, threads=threads, smem=plan.smem, blocks=plan.blocks)
                yard["barrier_us"][f"{name} {kind} n={n} blocks={blocks} smem={plan.smem}"] = us
    for mb in (10, 20, 30, 40, 45, 50, 60, 256):
        yard["reread_GBps"][f"{mb} MB"] = reread_GBps(probes, dev, mb, passes=3 if mb > 100 else 10)
    print(f"[dense-yardsticks] {json.dumps(yard)}", flush=True)
    rows.append(yard)

    probs, Zs = _dense_problems(dev)
    old_pcg, old_lz = old_dense_calls(old_lib, dev) if old_lib else (None, None)
    phase_lib = build_phase_timed()
    for (n, mu), (K, b) in probs.items():
        new = (lambda K, b: lambda: fp.fused_pcg_dense(K, b, maxits=cs.PCG_MAXITS, tol=cs.PCG_TOL))(K, b)
        plan = cb._grid("pcg", n, dev)[0]
        row = {"call": f"pcg n={n} mu={mu}", "k_resident_bytes": plan.resident_bytes,
               "k_streamed_bytes_per_step": plan.streamed_bytes, "niter_new": int(new()[2])}
        if n % 4:
            row["pad_copy_ms"] = cs.cuda_ms(lambda: cb._padded_rows(K))
        if old_pcg:
            old = (lambda K, b: lambda: old_pcg(K, b, cs.PCG_MAXITS, cs.PCG_TOL))(K, b)
            xo, _, ito = old()
            xn = new()[0]
            row.update(niter_old=int(ito), rel_x_old_new=float((xn - xo).abs().max() / xo.abs().max()))
            t = [cs.cuda_ms(old), cs.cuda_ms(new), cs.cuda_ms(new), cs.cuda_ms(old)]
            row.update(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]], ratio_old_over_new=(t[0] + t[3]) / (t[1] + t[2]))
        else:
            row["new_ms"] = [cs.cuda_ms(new)]
        row["phase_us"] = phase_times(phase_lib, 0, new, row["niter_new"])
        print(f"[ab] {json.dumps(row)}", flush=True)
        rows.append(row)
    for n in DENSE_AB_NS:
        K, Z = probs[n, cs.DENSE_MUS[0]][0], Zs[n]
        new = (lambda K, Z: lambda: fp.fused_lanczos_dense(K, Z, maxits=cs.SLQ_ITS))(K, Z)
        plan = cb._grid("lanczos", n, dev, cs.SLQ_NV, cs.SLQ_ITS)[0]
        row = {"call": f"lanczos n={n} nv={cs.SLQ_NV} steps={cs.SLQ_ITS}", "k_resident_bytes": plan.resident_bytes,
               "k_streamed_bytes_per_step": plan.streamed_bytes}
        if n % 4:
            row["pad_copy_ms"] = cs.cuda_ms(lambda: cb._padded_rows(K))
        if old_lz:
            old = (lambda K, Z: lambda: old_lz(K, Z, cs.SLQ_ITS))(K, Z)
            ao, bo, Vo, _ = old()
            an, bn, Vn, _ = new()
            row.update(coef_old_new=float(max((an - ao).abs().max(), (bn - bo).abs().max()) / ao.abs().max()),
                       rel_V_old_new=float(torch.linalg.norm(Vn - Vo) / torch.linalg.norm(Vo)))
            t = [cs.cuda_ms(old), cs.cuda_ms(new), cs.cuda_ms(new), cs.cuda_ms(old)]
            row.update(old_ms=[t[0], t[3]], new_ms=[t[1], t[2]], ratio_old_over_new=(t[0] + t[3]) / (t[1] + t[2]))
        else:
            row["new_ms"] = [cs.cuda_ms(new)]
        row["phase_us"] = phase_times(phase_lib, 1, new, cs.SLQ_ITS)
        print(f"[ab] {json.dumps(row)}", flush=True)
        rows.append(row)
    if variants:
        n = max(cs.DENSE_NS)
        K, b = probs[n, cs.DENSE_MUS[0]]
        Z = Zs[n]
        cg0 = cb._grid("pcg", n, dev)[0]
        lz0 = cb._grid("lanczos", n, dev, cs.SLQ_NV, cs.SLQ_ITS)[0]
        runs = [(f"pcg n={n} ring of {s} one-row stages", cg_variant(cg0, s, smem),
                 lambda plan: cb.fused_pcg(K, b, cs.PCG_MAXITS, cs.PCG_TOL, plan=plan)) for s in (2, 3, 4, 8)]
        settings = [(lz0.own, 8, 2, ""), (False, 8, 2, ", own columns of w and V in global memory")]
        settings += [(lz0.own, g, s, "") for g, s in ((2, 2), (2, 3), (2, 4), (2, 6), (4, 2), (4, 3))]
        for own, per_group, stages, note in settings:
            plan = lanczos_variant(lz0, smem, own=own, rows_per_group=per_group, stages=stages)
            runs.append((f"lanczos n={n} {stages} stages of {plan.chunk_rows} rows{note}", plan,
                         lambda plan: cb.fused_lanczos(K, Z, cs.SLQ_ITS, plan=plan)))
        for name, plan, run in runs:
            row = {"variant": name, "ms": cs.cuda_ms(lambda: run(plan)), "k_resident_bytes": plan.resident_bytes,
                   "k_streamed_bytes_per_step": plan.streamed_bytes}
            print(f"[variant] {json.dumps(row)}", flush=True)
            rows.append(row)
    # last: a launch the card may refuse
    clusters = cluster_coop(probes, dev, cb._grid("lanczos", max(cs.DENSE_NS), dev, cs.SLQ_NV, cs.SLQ_ITS)[0].smem)
    print(f"[dense-cluster] {json.dumps(clusters)}", flush=True)
    rows.append({"cooperative_cluster_launch": clusters})
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, default=None)
    ap.add_argument("--kernels", choices=("table", "regen", "wide", "wide-chunks", "f32", "dense"), default="table")
    ap.add_argument("--old-tree", type=Path, default=None)
    ap.add_argument("--variants", action="store_true", help="--kernels dense: also time other launch plans")
    return ap.parse_args(argv)


def main():
    args = parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_table_kernels_ab: no CUDA device")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {cs.nvidia_smi()}", flush=True)
    source = {"regen": "packed_ndft_regen.cu", "wide": "packed_ndft_wide.cu",
              "dense": "fused_pcg.cu"}.get(args.kernels, "packed_ndft.cu")
    old_lib = build_old(args.old_csrc.resolve(), source) if args.old_csrc else None
    if args.kernels == "dense":
        print(json.dumps({"ab": ab_dense(old_lib, args.variants)}), flush=True)
        return
    X, y = cs.make_data(cs.N_POINTS)
    if args.kernels == "wide-chunks":
        print(json.dumps({"chunks": ab_chunks(X)}), flush=True)
        return
    if args.kernels == "f32":
        rows = ab_f32(old_lib, X)
        if args.old_tree is not None:
            rows.append(trees_f32(args.old_tree.resolve()))
        print(json.dumps({"ab": rows}), flush=True)
        return
    rows = {"regen": ab_regen, "wide": ab_wide}.get(args.kernels, ab)(old_lib, X)
    if args.kernels == "wide":
        row, afn_prof = afn_pcg_256(old_lib)
        rows.append(row)
        prof = [profile_step(X, y, "wide-stream"), profile_step(X, y, "wide-fused"), afn_prof]
    else:
        prof = profile_step(X, y, args.kernels)
    print(json.dumps({"ab": rows, "profile": prof}), flush=True)


if __name__ == "__main__":
    main()
