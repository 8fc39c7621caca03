"""Debug printers and dump helpers (port of utils/debug.py).

Rebuild of the reference's TestPrintMatrix / TestPlotData / TestPlotCSRMatrix
helpers (ref: SRC/utils/utils.h:177-281): matrix pretty-printing and
gnuplot-style text dumps for quick inspection.  Each takes tensors (copied
to the host) or numpy arrays and writes the JAX package's text.
"""

import numpy as np
import torch


def _host(A):
    return A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else np.asarray(A)


def print_matrix(A, name: str = "", max_rows: int = 10, max_cols: int = 10):
    """Pretty-print (a corner of) a matrix -- ref TestPrintMatrix."""
    A = _host(A)
    if A.ndim == 1:
        A = A[None, :]
    r, c = A.shape
    if name:
        print(f"{name} ({r} x {c}):")
    for i in range(min(r, max_rows)):
        row = " ".join(f"{A[i, j]:12.5e}" for j in range(min(c, max_cols)))
        suffix = " ..." if c > max_cols else ""
        print(row + suffix)
    if r > max_rows:
        print("...")


def dump_points(path, X, y=None):
    """Write points (and optional values) as plottable text -- ref TestPlotData."""
    X = _host(X)
    cols = [X] if X.ndim == 2 else [X[:, None]]
    if y is not None:
        cols.append(_host(y)[:, None])
    np.savetxt(path, np.concatenate(cols, axis=1))


def dump_ell_pattern(path, idx, mask):
    """Write an ELL sparsity pattern as (row, col) pairs -- ref TestPlotCSRMatrix."""
    idx = _host(idx)
    mask = _host(mask)
    rows, cols = np.nonzero(mask)
    np.savetxt(path, np.stack([rows, idx[rows, cols]], axis=1), fmt="%d")
