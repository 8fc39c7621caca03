"""Build, load and launch the CUDA kernels of csrc/packed_ndft.cu.

The source is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `_build/packed_ndft-<source hash>/libpacked_ndft.so` inside the package
(the directory is git-ignored), and loaded with ctypes.  The hash key means
a changed source builds anew and an unchanged one loads at once.  Nothing
here runs at import time: the CPU tests import the package without nvcc.
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
SOURCE = _PKG / "csrc" / "packed_ndft.cu"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# points per tile of the adjoint kernel (TP in the source); chunks are whole tiles
_TILE = 64
# aim for a few blocks per SM of an H100 (132 SMs) in the adjoint
_TARGET_BLOCKS = 528


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"packed_ndft-{digest}" / "libpacked_ndft.so"


def build() -> tuple[Path, float]:
    """Compile the library if it is missing.  Returns (path, seconds spent)."""
    out = library_path()
    if out.exists():
        return out, 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.packed_adjoint_launch.argtypes = [P, I, P, I, I, I, P, I, P, I, P, I, I, P, P]
    lib.packed_adjoint_launch.restype = I
    lib.packed_forward_launch.argtypes = [P, I, I, I, P, I, P, P, I, P, I, P, P]
    lib.packed_forward_launch.restype = I
    lib.packed_ndft_error_string.argtypes = [I]
    lib.packed_ndft_error_string.restype = ctypes.c_char_p
    return lib


def _ints(values):
    values = [int(v) for v in values] or [0]
    return (ctypes.c_int * len(values))(*values)


def _check(lib, code: int, what: str):
    if code != 0:
        msg = lib.packed_ndft_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _stream(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def adjoint(Tp, alpha, pairs, singles):
    """Launch the adjoint kernels: ((nv, npairs, WR, WR), (nv, nsingles, WR))."""
    lib = library()
    _, WR, n = Tp.shape
    nv = alpha.shape[0]
    np_, ns = len(pairs), len(singles)
    rhs_per_block = min(8, 4096 // (WR * WR))          # RB of AdjCfg in the source
    per_chunk = np_ * -(-nv // rhs_per_block) + ns
    ntiles = -(-n // _TILE)
    nchunks = max(1, min(ntiles, -(-_TARGET_BLOCKS // max(per_chunk, 1))))
    chunk = -(-ntiles // nchunks) * _TILE
    nchunks = -(-n // chunk)
    S2 = nv * np_ * WR * WR
    S = S2 + nv * ns * WR
    part = torch.empty((nchunks, S), dtype=torch.float32, device=Tp.device)
    out = torch.empty(S, dtype=torch.float32, device=Tp.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    code = lib.packed_adjoint_launch(
        Tp.data_ptr(), int(Tp.dtype == torch.bfloat16), alpha.data_ptr(), WR, n, nv,
        pr, np_, sg, ns, part.data_ptr(), nchunks, chunk, out.data_ptr(), _stream(Tp))
    _check(lib, code, "packed_adjoint")
    return out[:S2].reshape(nv, np_, WR, WR), out[S2:].reshape(nv, ns, WR)


def forward(Tp, G2, G1, pairs, singles):
    """Launch the forward kernel: (nsets, n) float32."""
    lib = library()
    _, WR, n = Tp.shape
    nsets = G2.shape[0]
    y = torch.empty((nsets, n), dtype=torch.float32, device=Tp.device)
    pr, sg = _ints(v for pair in pairs for v in pair), _ints(singles)
    code = lib.packed_forward_launch(
        Tp.data_ptr(), int(Tp.dtype == torch.bfloat16), WR, n, pr, len(pairs),
        G2.data_ptr(), sg, len(singles), G1.data_ptr(), nsets, y.data_ptr(), _stream(Tp))
    _check(lib, code, "packed_forward")
    return y
