"""Readers for the reference's text data formats (a copy of io/readers.py:
the JAX package's io module imports no jax, but importing it loads the
package, which does).

Formats (ref TESTS/TEST4/foo.cpp:9-120):
- features: header "n d" then n*d values, column-major (all of feature 0,
  then feature 1, ...)
- labels:   header "n" then n values
- windows:  header "nwindow dwindow" then column-major feature indices,
  -1 = padding (skip logic nfft_interface.c:630-636)

Parsing uses the native C++ tokenizer (fastio.cpp, built at first use with
g++ into the package's git-ignored _build/ directory and bound via ctypes;
the reference's test-program IO is C++ too); falls back to pure Python if no
compiler is available.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_LOCK = threading.Lock()
_LIB = None
_LIB_TRIED = False


def _load_fastio():
    """Build (once) and load the native parser; None if unavailable."""
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        src = os.path.join(_HERE, "fastio.cpp")
        lib_path = os.path.join(_BUILD, "_fastio.so")
        try:
            os.makedirs(_BUILD, exist_ok=True)
            if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(src):
                # build beside and rename: processes that build at once never
                # load a half-written library
                tmp = f"{lib_path}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, lib_path)
        except (OSError, subprocess.SubprocessError):
            return None
        try:
            lib = ctypes.CDLL(lib_path)
            lib.parse_doubles.restype = ctypes.c_long
            lib.parse_doubles.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_double),
            ]
            lib.parse_header.restype = ctypes.c_long
            lib.parse_header.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_long)
            ]
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def _native_header(path, nvals):
    lib = _load_fastio()
    if lib is None:
        return None
    out = (ctypes.c_long * nvals)()
    got = lib.parse_header(str(path).encode(), nvals, out)
    if got != nvals:
        return None
    return [int(v) for v in out]


def _native_values(path, skip, count):
    lib = _load_fastio()
    if lib is None:
        return None
    out = np.empty(count, dtype=np.float64)
    got = lib.parse_doubles(
        str(path).encode(), skip, count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != count:
        return None
    return out


def _py_tokens(path):
    with open(path) as f:
        return f.read().split()


def read_features(path):
    hdr = _native_header(path, 2)
    if hdr is not None:
        n, d = hdr
        vals = _native_values(path, 2, n * d)
        if vals is not None:
            return vals.reshape(d, n).T.copy()  # column-major -> (n, d)
    toks = _py_tokens(path)
    n, d = int(toks[0]), int(toks[1])
    vals = np.asarray([float(t) for t in toks[2 : 2 + n * d]])
    return vals.reshape(d, n).T.copy()


def read_labels(path):
    hdr = _native_header(path, 1)
    if hdr is not None:
        n = hdr[0]
        vals = _native_values(path, 1, n)
        if vals is not None:
            return vals
    toks = _py_tokens(path)
    n = int(toks[0])
    return np.asarray([float(t) for t in toks[1 : 1 + n]])


def read_windows(path):
    """Returns a (W, dw) int array with -1 padding."""
    hdr = _native_header(path, 2)
    if hdr is not None:
        w, dw = hdr
        vals = _native_values(path, 2, w * dw)
        if vals is not None:
            return vals.astype(np.int32).reshape(dw, w).T.copy()
    toks = _py_tokens(path)
    w, dw = int(toks[0]), int(toks[1])
    vals = np.asarray([int(t) for t in toks[2 : 2 + w * dw]], dtype=np.int32)
    return vals.reshape(dw, w).T.copy()
