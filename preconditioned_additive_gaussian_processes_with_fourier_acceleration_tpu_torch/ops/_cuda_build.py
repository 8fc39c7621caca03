"""Build, load and launch the CUDA kernels of csrc/.

Five shared libraries with a plain C interface, one per source:

- `packed_ndft_tc`: csrc/packed_ndft_tc.cu, the tensor-core NDFT kernels for
  bf16 tables (the training path);
- `packed_ndft`: csrc/packed_ndft.cu, the NDFT kernels for float32 tables
  at 2P = 16 and 32 (CUDA cores fed by a TMA ring, csrc/tma_common.cuh; the
  1-D windows of the adjoint on csrc/packed_ndft.cuh's template);
- `packed_ndft_regen`: csrc/packed_ndft_regen.cu, the phase-regenerating
  kernels ("doubling", "direct"), both on the tensor cores in 3xTF32 with
  the Nyquist mode's two rows or columns and the 1-D windows on the CUDA
  cores in the same kernel;
- `packed_ndft_wide`: csrc/packed_ndft_wide.cu, the NDFT kernels for every
  even width 2P the three narrow libraries are not built for, on float32
  and bf16 tables (the 2-D windows of the adjoint and of the forward on
  the tensor cores, wgmma in 3xTF32 fed by TMA copies, csrc/wgmma_tf32.cuh,
  the forward's weights split into tf32 halves first; their 1-D windows on
  the CUDA cores), and the kernel that writes the phases of "doubling" and
  "direct" into a float32 slab for them;
- `fused_pcg`: csrc/fused_pcg.cu, the cooperative CG and Lanczos kernels.

Each is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v

into `_build/<name>-<hash of source, headers and flags>/lib<name>.so` inside
the package (the directory is git-ignored) and loaded with ctypes; ptxas's
report (registers, spills, shared memory per kernel) is kept beside it
(`ptxas_report`).  `build()`
starts one nvcc per missing library, all at once, and waits for them.  The
hash key means a changed source builds anew and an unchanged one loads at
once.  Nothing here runs at import time: the CPU tests import the package
without nvcc.
"""

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = {"packed_ndft_tc": CSRC / "packed_ndft_tc.cu",
           "packed_ndft": CSRC / "packed_ndft.cu",
           "packed_ndft_regen": CSRC / "packed_ndft_regen.cu",
           "packed_ndft_wide": CSRC / "packed_ndft_wide.cu",
           "fused_pcg": CSRC / "fused_pcg.cu"}
# the headers of csrc/ each source includes: part of its build key
HEADERS = {"packed_ndft_tc": (CSRC / "packed_ndft.cuh", CSRC / "tc_common.cuh"),
           "packed_ndft": (CSRC / "packed_ndft.cuh", CSRC / "tc_common.cuh", CSRC / "tma_common.cuh"),
           "packed_ndft_regen": (CSRC / "packed_ndft.cuh", CSRC / "tc_common.cuh"),
           "packed_ndft_wide": (CSRC / "packed_ndft.cuh", CSRC / "tc_common.cuh", CSRC / "tma_common.cuh",
                                CSRC / "wgmma_tf32.cuh"),
           "fused_pcg": ()}
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# points per tile of the adjoint kernels (TP in the header); chunks are whole tiles
_TILE = 64
# aim for a few blocks per SM of an H100 (132 SMs) in the adjoint
_TARGET_BLOCKS = 528
# the float32-table kernels (csrc/packed_ndft.cu): a stage holds 16 KB of
# each table operand, 4096 / 2P points (F32Tile::TP); their forward's limits
# (weight sets a pass, points a block) come from the library
# (forward_max_sets, forward_max_chunk)
_F32_STAGE_FLOATS = 4096
# rows (right-hand sides x 2P) per block of the tensor-core adjoints: 32 tiles of 16
_TC_ROWS = 512
# phase_gen codes of packed_ndft_regen.cu
PHASE_GEN_CODES = {"doubling": 0, "direct": 1}
# table kinds of packed_ndft_wide.cu's GEMMs (WideKind)
WIDE_KINDS = {torch.float32: 0, torch.bfloat16: 1}
# the wide adjoint's 1-D windows (wide_singles_kernel): about eight
# 256-thread blocks per SM of an H100, 64 x 64 output tiles (ABM = ABN)
_WIDE_TARGET_BLOCKS = 1056
_WIDE_TILE = 64
# its 2-D windows (wide_adjoint_wg_kernel): 128 M rows a block in 64-row
# wgmma tiles, N tiles of the compiled widths (WG_WIDTHS), at most 144
_WG_MTILE = 64
_WG_WIDTHS = (64, 72, 128, 136, 144)
# the forward's 2-D windows (wide_forward_wg_kernel): N tiles of FW_WIDTHS,
# at most 136 (its L0 tile and three stages fill shared memory)
_FW_WIDTHS = (64, 72, 128, 136)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    key = b"".join(f.read_bytes() for f in (SOURCES[name], *HEADERS[name]))
    key += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def build() -> tuple[dict, float]:
    """Compile the missing libraries, one nvcc each, all started together.

    Returns ({name: path}, wall seconds spent)."""
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    if not todo:
        return paths, 0.0
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, out in todo.items():
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True), tmp)
        errors = []
        for name, (proc, tmp) in procs.items():
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                errors.append(f"nvcc {SOURCES[name].name} failed ({proc.returncode}):\n{err}")
            else:
                (todo[name].parent / "ptxas.txt").write_text(err)
                os.replace(tmp, todo[name])
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return paths, time.perf_counter() - t0


def _kernel_name(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    symbol: "wide_adjoint_wg_kernel<0,128>"."""
    k = re.search(r"(?<=\d)([a-z][a-z_]*_kernel)(I(?:L[ij]\d+E)+E)?", mangled)
    if not k:
        return mangled
    args = re.findall(r"L[ij](\d+)E", k.group(2) or "")
    return k.group(1) + (f"<{','.join(args)}>" if args else "")


def ptxas_report(name: str) -> list[dict]:
    """Per kernel of a built library, from ptxas's report: {kernel (its
    name and template arguments, from the mangled symbol), registers,
    spill_bytes (stores + loads), smem (static bytes)}."""
    rows, kernel = [], None
    for line in (library_path(name).parent / "ptxas.txt").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            rows.append(dict(kernel=kernel, registers=None, spill_bytes=0, smem=0))
        elif kernel and "spill stores" in line:
            rows[-1]["spill_bytes"] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "Used" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["smem"] = int(smem.group(1)) if smem else 0
    return rows


def ptxas_notes(name: str) -> list[str]:
    """ptxas's performance notes on a built library (as "(C7511) ... in
    <kernel>"), each once: what it could not schedule as asked."""
    notes = []
    for line in (library_path(name).parent / "ptxas.txt").read_text().splitlines():
        m = re.search(r"(\(C\d+\) Potential Performance Loss: .*?) in the function '(\S+)'", line)
        if m:
            note = f"{m.group(1)} in {_kernel_name(m.group(2))}"
            if note not in notes:
                notes.append(note)
    return notes


def _ndft_signatures(lib):
    """The float32-table library: adjoint_launch (table, row stride, alpha,
    WR, n, nv, pairs, npairs, singles, nsingles, rhs per block, part,
    nchunks, chunk, out, stream) and forward_launch (table, row stride, WR,
    n, pairs, npairs, G2, singles, nsingles, G1, nsets, chunk, y, stream);
    its forward's limits per pass and per block at a width WR."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, I, P, I, I, P, P]
    lib.forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, I, P, P]
    for fn in (lib.adjoint_launch, lib.forward_launch, lib.forward_max_sets, lib.forward_max_chunk):
        fn.restype = I
    lib.forward_max_sets.argtypes = [I]
    lib.forward_max_chunk.argtypes = [I]


def _ndft_regen_signatures(lib):
    """adjoint_launch / forward_launch, their first two arguments the phase
    source (coordinates and phase_gen code); the adjoint takes the
    tensor-core launch configuration (nw, wk, mpw) before out, as
    tc_adjoint_launch does, and the forward (one pass) the split-weight
    scratch before y; the library gives the forward's pass limit and
    scratch size."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, I, I, I, P, P]
    lib.forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, P, P, P]
    lib.adjoint_launch.restype = I
    lib.forward_launch.restype = I
    lib.forward_max_sets.argtypes = []
    lib.forward_max_sets.restype = I
    lib.forward_scratch_words.argtypes = [I, I, I]
    lib.forward_scratch_words.restype = ctypes.c_longlong


def _ndft_tc_signatures(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tc_adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, I, I, I, P, P]
    lib.tc_adjoint_launch.restype = I
    lib.tc_forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, P, P, P]
    lib.tc_forward_launch.restype = I


def _fused_pcg_signatures(lib):
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.fused_pcg_grid.argtypes = [I, IP]
    lib.fused_pcg_launch.argtypes = [P, P, I, I, ctypes.c_float, I, P, P, P, P, P]
    lib.fused_lanczos_grid.argtypes = [I, IP]
    lib.fused_lanczos_launch.argtypes = [P, P, I, I, I, I, P, P, P, P, P, P]
    lib.grid_sync_probe.argtypes = [P, IP, P]
    lib.probe_grid_size.argtypes = [IP]
    for fn in (lib.fused_pcg_grid, lib.fused_pcg_launch, lib.fused_lanczos_grid,
               lib.fused_lanczos_launch, lib.grid_sync_probe, lib.probe_grid_size):
        fn.restype = I


def _ndft_wide_signatures(lib):
    """wide_adjoint_launch / wide_forward_launch: the table's kind
    (WIDE_KINDS), its pointer and row stride first; wide_phases_launch."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.wide_phases_launch.argtypes = [I, P, I, I, I, I, I, P, P]
    lib.wide_phases_launch.restype = I
    lib.wide_adjoint_launch.argtypes = [I, P, I, P, I, I, I, P, I, P, I, P, I, I, P, P]
    L = ctypes.c_longlong
    lib.wide_split_weights_launch.argtypes = [P, L, L, L, I, I, I, P, P]
    lib.wide_split_weights_launch.restype = I
    lib.wide_forward_launch.argtypes = [I, P, I, I, I, P, I, P, P, I, P, I, P, P]
    lib.wide_adjoint_launch.restype = I
    lib.wide_forward_launch.restype = I


_SIGNATURES = {"packed_ndft_tc": _ndft_tc_signatures, "packed_ndft": _ndft_signatures,
               "packed_ndft_regen": _ndft_regen_signatures, "packed_ndft_wide": _ndft_wide_signatures,
               "fused_pcg": _fused_pcg_signatures}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Load one library (ctypes, RTLD_LOCAL) with its own C signatures; each
    also exports error_string."""
    paths, _ = build()
    lib = ctypes.CDLL(str(paths[name]))
    _SIGNATURES[name](lib)
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def _ints(values):
    values = [int(v) for v in values] or [0]
    return (ctypes.c_int * len(values))(*values)


def _check(lib, code: int, what: str):
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _chunks(n, per_chunk, target=_TARGET_BLOCKS):
    """(nchunks, chunk): whole 64-point tiles per chunk, at most `target`
    blocks for `per_chunk` blocks per chunk (four per SM of an H100 by
    default, so no wave of blocks runs nearly empty)."""
    ntiles = -(-n // _TILE)
    nchunks = max(1, min(ntiles, target // max(per_chunk, 1)))
    chunk = -(-ntiles // nchunks) * _TILE
    return -(-n // chunk), chunk


def f32_stage_points(WR: int) -> int:
    """Points of one stage of the float32-table kernels (F32Tile::TP):
    128 at 2P = 32, 256 at 16; their chunks are whole stages."""
    return _F32_STAGE_FLOATS // WR


def f32_rhs_per_block(WR: int, nv: int) -> int:
    """Right-hand sides of one block of the float32-table adjoint (the
    compiled instances of f32_adjoint_kernel: 1 or 2 at 2P = 32, their
    outputs in the registers of every consumer warp; 1, 2 or 4 at 16)."""
    return 1 if nv == 1 else 2 if nv == 2 or WR == 32 else 4


def f32_adjoint_chunks(WR: int, nv: int, n: int, npairs: int, nsingles: int, sms: int) -> tuple[int, int]:
    """(nchunks, chunk) of the float32-table adjoint: chunks of whole
    stages.  With 2-D windows about one block an SM (a block streams its
    chunk through a four-stage ring, one block fits an SM): the most chunks
    whose (chunk, window, right-hand-side group) blocks do not pass `sms`;
    without, the 1-D windows' 256-thread blocks at about four an SM."""
    tp = f32_stage_points(WR)
    tiles = -(-n // tp)
    if npairs:
        want = sms // (npairs * -(-nv // f32_rhs_per_block(WR, nv)))
    else:
        want = _TARGET_BLOCKS // (nsingles * -(-nv // (256 // WR)))
    nchunks = max(1, min(tiles, want))
    chunk = -(-tiles // nchunks) * tp
    return -(-n // chunk), chunk


def f32_forward_chunk(WR: int, n: int, sms: int, max_chunk: int) -> int:
    """Points of one block of the float32-table forward: whole stages,
    about one block an SM, at most max_chunk (the library's
    forward_max_chunk(WR): its y in shared memory)."""
    tp = f32_stage_points(WR)
    return min(max_chunk, -(-(-(-n // tp)) // sms) * tp)


def adjoint(Tp, alpha, pairs, singles):
    """Launch the float32-table adjoint (csrc/packed_ndft.cu) on a table
    (Dtot, WR, n) whose rows start on 16-byte boundaries: ((nv, npairs, WR,
    WR), (nv, nsingles, WR))."""
    lib = library("packed_ndft")
    _, WR, n = Tp.shape
    nv = alpha.shape[0]
    np_, ns = len(pairs), len(singles)
    nchunks, chunk = f32_adjoint_chunks(WR, nv, n, np_, ns, _sm_count(alpha.device))
    S2 = nv * np_ * WR * WR
    S = S2 + nv * ns * WR
    part = torch.empty((nchunks, S), dtype=torch.float32, device=alpha.device)
    out = torch.empty(S, dtype=torch.float32, device=alpha.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    with torch.cuda.device(alpha.device):
        code = lib.adjoint_launch(Tp.data_ptr(), Tp.stride(1), alpha.data_ptr(), WR, n, nv, pr, np_, sg, ns,
                                  f32_rhs_per_block(WR, nv), part.data_ptr(), nchunks, chunk, out.data_ptr(),
                                  _stream(alpha))
    _check(lib, code, "packed_adjoint")
    return out[:S2].reshape(nv, np_, WR, WR), out[S2:].reshape(nv, ns, WR)


def forward(Tp, G2, G1, pairs, singles):
    """Launch the float32-table forward (csrc/packed_ndft.cu) on a table
    (Dtot, WR, n) whose rows start on 16-byte boundaries, one launch per
    pass of at most the library's forward_max_sets(WR) weight sets
    (`forward_regen_split`); G2 and G1 contiguous and 16-byte aligned:
    (nsets, n) float32."""
    lib = library("packed_ndft")
    _, WR, n = Tp.shape
    nsets = G2.shape[0]
    y = torch.empty((nsets, n), dtype=torch.float32, device=G2.device)
    chunk = f32_forward_chunk(WR, n, _sm_count(G2.device), lib.forward_max_chunk(WR))
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    with torch.cuda.device(G2.device):
        for s0, ns in forward_regen_split(nsets, lib.forward_max_sets(WR)):
            code = lib.forward_launch(Tp.data_ptr(), Tp.stride(1), WR, n, pr, len(pairs), G2[s0:].data_ptr(), sg,
                                      len(singles), G1[s0:].data_ptr(), ns, chunk, y[s0:].data_ptr(), _stream(G2))
            _check(lib, code, "packed_forward")
    return y


def adjoint_tc_split(WR: int, nv: int) -> tuple[int, int, int]:
    """(nw, wk, mpw) of the tensor-core adjoints for nv right-hand sides: the
    warps of a block, their split of a tile's k-steps, and the 16-row M
    tiles per warp (nw / wk warps along M); the instances that
    csrc/packed_ndft_tc.cu and csrc/packed_ndft_regen.cu compile.  A block
    holds up to _TC_ROWS // WR right-hand sides, WR rows each, in
    ceil(rows / 16) M tiles."""
    mtiles = -(-min(nv, _TC_ROWS // WR) * WR // 16)
    for limit, split in ((2, (8, 4, 1)), (4, (8, 2, 1)), (8, (8, 1, 1)), (16, (8, 1, 2)), (24, (12, 1, 2))):
        if mtiles <= limit:
            return split
    return 8, 1, 4


def _adjoint_tc(lib, fn, what, src, src_flag, alpha, WR, n, pairs, singles):
    """One tensor-core adjoint launch (lib's function fn: tc_adjoint_launch or
    the regenerating adjoint_launch): one block per (2-D window, chunk,
    group of up to _TC_ROWS // WR right-hand sides), one per (1-D window,
    chunk, rhs group of the CUDA-core template).  Returns
    ((nv, npairs, WR, WR), (nv, nsingles, WR))."""
    nv = alpha.shape[0]
    np_, ns = len(pairs), len(singles)
    nw, wk, mpw = adjoint_tc_split(WR, nv)
    nchunks, chunk = _chunks(n, np_ * -(-nv // (_TC_ROWS // WR)) + ns)
    S2 = nv * np_ * WR * WR
    S = S2 + nv * ns * WR
    part = torch.empty((nchunks, S), dtype=torch.float32, device=alpha.device)
    out = torch.empty(S, dtype=torch.float32, device=alpha.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    with torch.cuda.device(alpha.device):
        code = getattr(lib, fn)(src.data_ptr(), src_flag, alpha.data_ptr(), WR, n, nv, pr, np_, sg, ns,
                                part.data_ptr(), nchunks, chunk, nw, wk, mpw, out.data_ptr(), _stream(alpha))
    _check(lib, code, what)
    return out[:S2].reshape(nv, np_, WR, WR), out[S2:].reshape(nv, ns, WR)


def adjoint_tc(Tp, alpha, pairs, singles):
    """Launch the bf16-table tensor-core adjoint (csrc/packed_ndft_tc.cu):
    ((nv, npairs, WR, WR), (nv, nsingles, WR))."""
    _, WR, n = Tp.shape
    return _adjoint_tc(library("packed_ndft_tc"), "tc_adjoint_launch", "packed_adjoint", Tp, Tp.stride(1), alpha,
                       WR, n, pairs, singles)


# weight sets per pass of the tensor-core forward (FWD_SMAX in the source)
_TC_SETS = 32


def forward_tc(Tp, G2, G1, pairs, singles):
    """Launch the bf16-table tensor-core forward (csrc/packed_ndft_tc.cu):
    (nsets, n) float32."""
    lib = library("packed_ndft_tc")
    _, WR, n = Tp.shape
    nsets = G2.shape[0]
    y = torch.empty((nsets, n), dtype=torch.float32, device=G2.device)
    # the split weights of one pass: 3 bf16 terms per entry, 2 per word
    gf = torch.empty(max(1, len(pairs) * min(nsets, _TC_SETS) * WR * WR * 3 // 2), dtype=torch.int32,
                     device=G2.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    with torch.cuda.device(G2.device):
        code = lib.tc_forward_launch(Tp.data_ptr(), Tp.stride(1), WR, n, pr, len(pairs), G2.data_ptr(), sg,
                                     len(singles), G1.data_ptr(), nsets, gf.data_ptr(), y.data_ptr(),
                                     _stream(G2))
    _check(lib, code, "packed_forward")
    return y


def adjoint_regen(xT, alpha, WR, pairs, singles, phase_gen):
    """Launch the regenerating adjoint on coordinates xT (Dtot, n)
    (csrc/packed_ndft_regen.cu): the 2-D windows on the tensor cores
    (3xTF32), the 1-D windows on the CUDA cores."""
    return _adjoint_tc(library("packed_ndft_regen"), "adjoint_launch", "packed_adjoint_regen", xT,
                       PHASE_GEN_CODES[phase_gen], alpha, WR, xT.shape[1], pairs, singles)


def forward_regen_split(nsets: int, max_sets: int) -> list:
    """The passes [(s0, ns)] of the regenerating forward and of the
    float32-table forward: consecutive runs of at most max_sets weight sets
    (the library's forward_max_sets()), one launch (pair: weight split,
    forward) each."""
    return [(s0, min(max_sets, nsets - s0)) for s0 in range(0, nsets, max_sets)]


def forward_regen(xT, G2, G1, WR, pairs, singles, phase_gen):
    """Launch the regenerating forward on coordinates xT (Dtot, n)
    (csrc/packed_ndft_regen.cu), one launch pair per pass of
    `forward_regen_split`: (nsets, n) float32."""
    lib = library("packed_ndft_regen")
    n, nsets = xT.shape[1], G2.shape[0]
    passes = forward_regen_split(nsets, lib.forward_max_sets())
    y = torch.empty((nsets, n), dtype=torch.float32, device=G2.device)
    gf = torch.empty(max(1, lib.forward_scratch_words(WR, len(pairs), passes[0][1])), dtype=torch.int32,
                     device=G2.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    with torch.cuda.device(G2.device):
        for s0, ns in passes:
            code = lib.forward_launch(xT.data_ptr(), PHASE_GEN_CODES[phase_gen], WR, n, pr, len(pairs),
                                      G2[s0:].data_ptr(), sg, len(singles), G1[s0:].data_ptr(), ns,
                                      gf.data_ptr(), y[s0:].data_ptr(), _stream(G2))
            _check(lib, code, "packed_forward_regen")
    return y


def wide_tiles(WR: int, nv: int) -> tuple[int, int, int]:
    """(nt, ntn, mblocks) of the wide adjoint's 2-D windows: the N tile
    width (WR in ceil(WR / 144) tiles, each the narrowest compiled width
    that holds its share), the N tiles, and the blocks of 128 M rows (nv WR
    rows in 64-row tiles, two a block); wg_tiles in
    csrc/packed_ndft_wide.cu computes the same."""
    ntn = -(-WR // _WG_WIDTHS[-1])
    nt = next(w for w in _WG_WIDTHS if w * ntn >= WR)
    return nt, ntn, -(-(-(-nv * WR // _WG_MTILE)) // 2)


def wide_forward_tiles(WR: int) -> tuple[int, int]:
    """(nt, ntn) of the wide forward's 2-D windows: WR in ceil(WR / 136)
    N tiles, each the narrowest compiled width that holds its share;
    fw_tile in csrc/packed_ndft_wide.cu computes the same."""
    ntn = -(-WR // _FW_WIDTHS[-1])
    return next(w for w in _FW_WIDTHS if w * ntn >= WR), ntn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def wide_chunks(WR: int, nv: int, n: int, npairs: int, nsingles: int, sms: int) -> tuple[int, int]:
    """(nchunks, chunk) of the wide adjoint: chunks of whole 64-point tiles.

    With 2-D windows, one block an SM (its shared memory): the number of
    chunks k that minimises waves(k) (ceil(k blocks per chunk / sms)) times
    a block's time in 32-point stages (2 ceil(tiles / k), plus 3 for its
    prologue and epilogue), plus the k partial slices' write and read (8
    bytes an output a chunk at 3e12 B/s) in stages of nt columns (3xTF32 at
    about half the tensor cores' rate: nt * 1.5e-8 s).  Without, the 1-D
    windows' 64 x 64 output tiles (nv rows, WR columns) at about eight
    blocks an SM.  Kept per shape: a solver calls it every iteration."""
    if npairs == 0:
        cols = -(-WR // _WIDE_TILE)
        return _chunks(n, cols * nsingles * -(-nv // _WIDE_TILE), _WIDE_TARGET_BLOCKS)
    nt, ntn, mblocks = wide_tiles(WR, nv)
    per_chunk = npairs * ntn * mblocks
    tiles = -(-n // _TILE)
    out_stages = 8.0 * nv * (npairs * WR * WR + nsingles * WR) / 3e12 / (nt * 1.5e-8)
    best = min(range(1, min(tiles, 65535) + 1),
               key=lambda k: (-(-k * per_chunk // sms) * (2 * -(-tiles // k) + 3) + k * out_stages, k))
    chunk = -(-tiles // best) * _TILE
    return -(-n // chunk), chunk


def phases_wide(xT, P: int, phase_gen: str):
    """The phases of the coordinate rows xT (Dtot, n) float32 as the wide
    kernels' float32 table: (Dtot, 2P, n), the view of storage padded to
    TABLE_PAD points as pack_phase_table's (rows on 256-byte boundaries, as
    the adjoint's TMA copies need), regenerated by `phase_gen`'s formula
    (csrc/packed_ndft_wide.cu wide_phases_kernel)."""
    lib = library("packed_ndft_wide")
    Dtot, n = xT.shape
    ld = -(-n // _TILE) * _TILE
    slab = torch.empty((Dtot, 2 * P, ld), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        code = lib.wide_phases_launch(PHASE_GEN_CODES[phase_gen], xT.data_ptr(), xT.stride(0), Dtot, P, n, ld,
                                      slab.data_ptr(), _stream(xT))
    _check(lib, code, "wide phases")
    return slab[:, :, :n]


def adjoint_wide(Tp, alpha, pairs, singles):
    """Launch the wide adjoint (csrc/packed_ndft_wide.cu) on a float32 or
    bf16 table (Dtot, WR, n) whose rows start on 16-byte boundaries:
    ((nv, npairs, WR, WR), (nv, nsingles, WR))."""
    lib = library("packed_ndft_wide")
    _, WR, n = Tp.shape
    nv = alpha.shape[0]
    np_, ns = len(pairs), len(singles)
    nchunks, chunk = wide_chunks(WR, nv, n, np_, ns, _sm_count(alpha.device))
    S2 = nv * np_ * WR * WR
    S = S2 + nv * ns * WR
    part = torch.empty((nchunks, S), dtype=torch.float32, device=alpha.device)
    out = torch.empty(S, dtype=torch.float32, device=alpha.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    with torch.cuda.device(alpha.device):
        code = lib.wide_adjoint_launch(WIDE_KINDS[Tp.dtype], Tp.data_ptr(), Tp.stride(1), alpha.data_ptr(), WR, n,
                                       nv, pr, np_, sg, ns, part.data_ptr(), nchunks, chunk, out.data_ptr(),
                                       _stream(alpha))
    _check(lib, code, "wide adjoint")
    return out[:S2].reshape(nv, np_, WR, WR), out[S2:].reshape(nv, ns, WR)


def split_weights_wide(G2):
    """The wide forward's weight split (csrc/packed_ndft_wide.cu
    wide_split_weights_kernel) of G2 (nsets, npairs, WR, WR) float32, any
    strides with a unit last one: (2, nsets, npairs, WR, WRp) float32, big
    and small tf32 halves, WRp = WR rounded up to 4, zeros in the pad
    (packed_ndft.split_weights_plain computes the same)."""
    lib = library("packed_ndft_wide")
    nsets, npairs, WR, _ = G2.shape
    if G2.stride(3) != 1:
        raise ValueError(f"G2 must have unit stride along b, got strides {G2.stride()}")
    out = torch.empty((2, nsets, npairs, WR, -(-WR // 4) * 4), dtype=torch.float32, device=G2.device)
    with torch.cuda.device(G2.device):
        code = lib.wide_split_weights_launch(G2.data_ptr(), *G2.stride()[:3], WR, npairs, nsets, out.data_ptr(),
                                             _stream(G2))
    _check(lib, code, "wide weight split")
    return out


def forward_wide(Tp, G2, G1, pairs, singles):
    """Launch the wide forward (csrc/packed_ndft_wide.cu) on a float32 or
    bf16 table (Dtot, WR, n): (nsets, n) float32.  With 2-D windows the
    weights' split first (`split_weights_wide`), then the forward; the
    table's rows start on 16-byte boundaries, or the library refuses the
    launch.  G1 is contiguous."""
    lib = library("packed_ndft_wide")
    _, WR, n = Tp.shape
    nsets = G2.shape[0]
    y = torch.empty((nsets, n), dtype=torch.float32, device=G2.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    gsplit = split_weights_wide(G2) if pairs else None
    with torch.cuda.device(G2.device):
        code = lib.wide_forward_launch(WIDE_KINDS[Tp.dtype], Tp.data_ptr(), Tp.stride(1), WR, n, pr, len(pairs),
                                       None if gsplit is None else gsplit.data_ptr(), sg, len(singles),
                                       G1.data_ptr(), nsets, y.data_ptr(), _stream(G2))
    _check(lib, code, "wide forward")
    return y


@functools.lru_cache(maxsize=None)
def _grid(query: str, n: int, device: torch.device) -> int:
    """Blocks of a cooperative launch of n on `device`, from the occupancy
    query (`fused_pcg_grid` or `fused_lanczos_grid`): asked once per (kernel,
    n, card), so a launch pays no host query."""
    lib = library("fused_pcg")
    g = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, getattr(lib, query)(n, ctypes.byref(g)), query)
    return g.value


def fused_pcg(K, b, maxits: int, tol: float):
    """Launch the cooperative CG kernel on b's card: (x (n,), relres (),
    niter () int32)."""
    lib = library("fused_pcg")
    n, dev = b.shape[0], b.device
    G = _grid("fused_pcg_grid", n, dev)
    x = torch.empty(n, dtype=torch.float32, device=dev)
    scratch = torch.empty(3 * n + 2 * G, dtype=torch.float32, device=dev)
    relres = torch.empty((), dtype=torch.float32, device=dev)
    niter = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.fused_pcg_launch(K.data_ptr(), b.data_ptr(), n, maxits, float(tol * tol), G,
                                    x.data_ptr(), scratch.data_ptr(), relres.data_ptr(),
                                    niter.data_ptr(), _stream(b))
    _check(lib, code, "fused_pcg")
    return x, relres, niter


def fused_lanczos(K, Z, maxits: int):
    """Launch the cooperative Lanczos kernel on Z's card: (alpha, beta, V,
    beta0)."""
    lib = library("fused_pcg")
    nv, n = Z.shape
    dev = Z.device
    G = _grid("fused_lanczos_grid", n, dev)
    alpha = torch.ones((nv, maxits), dtype=torch.float32, device=dev)
    beta = torch.zeros((nv, maxits - 1), dtype=torch.float32, device=dev)
    V = torch.zeros((nv, maxits + 1, n), dtype=torch.float32, device=dev)
    beta0 = torch.empty(nv, dtype=torch.float32, device=dev)
    scratch = torch.empty(nv * n + G * nv * (2 * maxits + 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.fused_lanczos_launch(K.data_ptr(), Z.data_ptr(), n, nv, maxits, G,
                                        alpha.data_ptr(), beta.data_ptr(), V.data_ptr(),
                                        beta0.data_ptr(), scratch.data_ptr(), _stream(Z))
    _check(lib, code, "fused_lanczos")
    return alpha, beta, V, beta0


def grid_sync_probe(device) -> tuple[int, int]:
    """Run the grid-wide barrier check: (blocks, the sum block 0 read after
    grid.sync(), which must be blocks (blocks + 1) / 2)."""
    lib = library("fused_pcg")
    g = ctypes.c_int(0)
    with torch.cuda.device(device):
        _check(lib, lib.probe_grid_size(ctypes.byref(g)), "probe_grid_size")
        out = torch.zeros(1 + g.value, dtype=torch.int32, device=device)
        code = lib.grid_sync_probe(out.data_ptr(), ctypes.byref(g),
                                   ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _check(lib, code, "grid_sync_probe")
    return g.value, int(out[0])
