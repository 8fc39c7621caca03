"""Time the port's NDFT kernels against an earlier build of them, and
profile one loss step, on one NVIDIA GPU.

    python3 scripts/torch_table_kernels_ab.py --old-csrc OLD/csrc
    python3 scripts/torch_table_kernels_ab.py --kernels regen --old-csrc OLD/csrc
    python3 scripts/torch_table_kernels_ab.py --kernels wide --old-csrc OLD/csrc
    python3 scripts/torch_table_kernels_ab.py --kernels wide-chunks

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

The profile (torch.profiler, after a warm-up step): wall time, device-busy
time (the union of the device kernels' intervals) and its share of the wall
time, and the device time by kernel.  Prints one JSON line at the end.
Exits non-zero without CUDA.
"""

import argparse
import ctypes
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

    _cuda_build._ndft_signatures(lib)
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
        {"packed_ndft_regen.cu": _old_regen_signatures}.get(source, _cuda_build._ndft_signatures)(lib)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
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
                return cb._forward(old_lib, "old packed_forward_regen", xT, code, G2, G1, W2, n, pairs, singles)

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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-csrc", type=Path, default=None)
    ap.add_argument("--kernels", choices=("table", "regen", "wide", "wide-chunks"), default="table")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_table_kernels_ab: no CUDA device")
    import nfft4gp_torch  # noqa: F401  (switches TF32 off)

    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi name, power.limit: {cs.nvidia_smi()}", flush=True)
    source = {"regen": "packed_ndft_regen.cu", "wide": "packed_ndft_wide.cu"}.get(args.kernels, "packed_ndft.cu")
    old_lib = build_old(args.old_csrc.resolve(), source) if args.old_csrc else None
    X, y = cs.make_data(cs.N_POINTS)
    if args.kernels == "wide-chunks":
        print(json.dumps({"chunks": ab_chunks(X)}), flush=True)
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
