"""Pairwise squared distances (port of ops/distances.py).

The XX + YY - 2XY GEMM trick of the reference (SRC/linearalg/kernels.c:17-120);
the clamp guards tiny negative values from rounding.
"""

import torch


def sq_distance(X, Y=None):
    """Pairwise squared Euclidean distances. X: (n, d); Y: (m, d) or None."""
    if Y is None:
        Y = X
    xx = torch.sum(X * X, dim=1)[:, None]
    yy = torch.sum(Y * Y, dim=1)[None, :]
    d2 = xx + yy - 2.0 * (X @ Y.T)
    return torch.clamp(d2, min=0.0)
