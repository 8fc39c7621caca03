"""Build, load and launch the CUDA kernels of csrc/.

Two shared libraries with a plain C interface, one per source, both from the
kernel templates of csrc/packed_ndft.cuh:

- `packed_ndft`: csrc/packed_ndft.cu, the table phase source;
- `packed_ndft_regen`: csrc/packed_ndft_regen.cu, the regenerating phase
  sources ("doubling", "direct").

Each is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `_build/<name>-<hash of source, header and flags>/lib<name>.so` inside
the package (the directory is git-ignored) and loaded with ctypes.  `build()`
starts one nvcc per missing library, all at once, and waits for them.  The
hash key means a changed source builds anew and an unchanged one loads at
once.  Nothing here runs at import time: the CPU tests import the package
without nvcc.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
HEADER = CSRC / "packed_ndft.cuh"
SOURCES = {"packed_ndft": CSRC / "packed_ndft.cu",
           "packed_ndft_regen": CSRC / "packed_ndft_regen.cu"}
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# points per tile of the adjoint kernels (TP in the header); chunks are whole tiles
_TILE = 64
# aim for a few blocks per SM of an H100 (132 SMs) in the adjoint
_TARGET_BLOCKS = 528
# phase_gen codes of packed_ndft_regen.cu
PHASE_GEN_CODES = {"doubling": 0, "direct": 1}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    key = SOURCES[name].read_bytes() + HEADER.read_bytes() + " ".join(NVCC_FLAGS).encode()
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


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Load one library.  Both export the same C functions (adjoint_launch,
    forward_launch, error_string), their first two arguments being the
    phase source (table pointer and bf16 flag, or coordinates and
    phase_gen code); ctypes loads each with RTLD_LOCAL."""
    paths, _ = build()
    lib = ctypes.CDLL(str(paths[name]))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, P, P]
    lib.adjoint_launch.restype = I
    lib.forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, P, P]
    lib.forward_launch.restype = I
    lib.error_string.argtypes = [I]
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


def rhs_per_block(WR: int) -> int:
    """RB of AdjCfg<WR> in the header: right-hand sides per adjoint block."""
    wrp = -(-WR // 4) * 4
    tiles = (wrp // 4) * (wrp // (2 if wrp == 16 else 4))
    return min(8, 256 // tiles)


def _adjoint(lib, what, src, src_flag, alpha, WR, n, pairs, singles):
    nv = alpha.shape[0]
    np_, ns = len(pairs), len(singles)
    per_chunk = np_ * -(-nv // rhs_per_block(WR)) + ns
    ntiles = -(-n // _TILE)
    nchunks = max(1, min(ntiles, -(-_TARGET_BLOCKS // max(per_chunk, 1))))
    chunk = -(-ntiles // nchunks) * _TILE
    nchunks = -(-n // chunk)
    S2 = nv * np_ * WR * WR
    S = S2 + nv * ns * WR
    part = torch.empty((nchunks, S), dtype=torch.float32, device=alpha.device)
    out = torch.empty(S, dtype=torch.float32, device=alpha.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    code = lib.adjoint_launch(src.data_ptr(), src_flag, alpha.data_ptr(), WR, n, nv, pr, np_, sg,
                              ns, part.data_ptr(), nchunks, chunk, out.data_ptr(), _stream(alpha))
    _check(lib, code, what)
    return out[:S2].reshape(nv, np_, WR, WR), out[S2:].reshape(nv, ns, WR)


def _forward(lib, what, src, src_flag, G2, G1, WR, n, pairs, singles):
    nsets = G2.shape[0]
    y = torch.empty((nsets, n), dtype=torch.float32, device=G2.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    code = lib.forward_launch(src.data_ptr(), src_flag, WR, n, pr, len(pairs), G2.data_ptr(), sg,
                              len(singles), G1.data_ptr(), nsets, y.data_ptr(), _stream(G2))
    _check(lib, code, what)
    return y


def adjoint(Tp, alpha, pairs, singles):
    """Launch the table adjoint kernels: ((nv, npairs, WR, WR), (nv, nsingles, WR))."""
    _, WR, n = Tp.shape
    return _adjoint(library("packed_ndft"), "packed_adjoint", Tp, int(Tp.dtype == torch.bfloat16),
                    alpha, WR, n, pairs, singles)


def forward(Tp, G2, G1, pairs, singles):
    """Launch the table forward kernel: (nsets, n) float32."""
    _, WR, n = Tp.shape
    return _forward(library("packed_ndft"), "packed_forward", Tp, int(Tp.dtype == torch.bfloat16),
                    G2, G1, WR, n, pairs, singles)


def adjoint_regen(xT, alpha, WR, pairs, singles, phase_gen):
    """Launch the regenerating adjoint kernels on coordinates xT (Dtot, n)."""
    return _adjoint(library("packed_ndft_regen"), "packed_adjoint_regen", xT,
                    PHASE_GEN_CODES[phase_gen], alpha, WR, xT.shape[1], pairs, singles)


def forward_regen(xT, G2, G1, WR, pairs, singles, phase_gen):
    """Launch the regenerating forward kernel: (nsets, n) float32."""
    return _forward(library("packed_ndft_regen"), "packed_forward_regen", xT,
                    PHASE_GEN_CODES[phase_gen], G2, G1, WR, xT.shape[1], pairs, singles)
