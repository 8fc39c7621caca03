"""Farthest point sampling (port of ops/fps.py).

The reference's parallel FPS (SRC/linearalg/ordering.c:422-712,
Nfft4GPSortFpsPar1): keep each point's squared distance to the nearest
landmark, pick its argmax, relax all distances; O(nk).  Start: the point
nearest the data mean (ordering.c:110-143).

`fps` runs on X's device and keeps the argmax there, so the k steps queue
without a host sync; `fps_host` is the numpy variant the AFN plan uses.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..utils.datasets import expand_perm


class FpsResult(NamedTuple):
    perm: torch.Tensor    # (k,) selected indices in selection order
    dists: torch.Tensor   # (k,) cover radius at each selection (dists[0] = inf)


def fps(X, k: int) -> FpsResult:
    """Select k farthest-point-sampled landmarks from X (n, d)."""
    mean = torch.mean(X, dim=0)
    start = torch.argmin(torch.sum((X - mean[None, :]) ** 2, dim=1))
    xx = torch.sum(X * X, dim=1)

    def dist2_to(i):
        # index_select with a device index: no host read of i
        i = i.reshape(1)
        return torch.clamp(xx + xx.index_select(0, i) - 2.0 * (X @ X.index_select(0, i)[0]), min=0.0)

    dist = dist2_to(start)
    perm = torch.zeros(k, dtype=torch.int64, device=X.device)
    perm[0] = start
    dists = torch.full((k,), float("inf"), dtype=X.dtype, device=X.device)
    for i in range(1, k):
        nxt = torch.argmax(dist)
        dists[i] = torch.sqrt(dist.index_select(0, nxt.reshape(1))[0])
        perm[i] = nxt
        dist = torch.minimum(dist, dist2_to(nxt))
    return FpsResult(perm=perm, dists=dists)


def fps_full_perm(X, k: int):
    """FPS prefix expanded to a full n-permutation (remaining ascending)."""
    res = fps(X, k)
    return expand_perm(res.perm, X.shape[0]), res


def fps_host(X, k: int):
    """Host numpy FPS with the same start rule as `fps`.  Returns (perm (k,),
    dists (k,)) as numpy int64 / float64.  Like the JAX function it repeats a
    landmark once k exceeds the number of distinct points (the argmax of an
    all-zero distance vector is index 0)."""
    X = np.asarray(X.cpu() if isinstance(X, torch.Tensor) else X)
    n = X.shape[0]
    k = min(k, n)
    mean = X.mean(axis=0)
    start = int(np.argmin(((X - mean) ** 2).sum(axis=1)))
    perm = np.empty(k, np.int64)
    dists = np.empty(k, np.float64)
    perm[0] = start
    dists[0] = np.inf
    cur = ((X - X[start]) ** 2).sum(axis=1)
    for j in range(1, k):
        nxt = int(np.argmax(cur))
        perm[j] = nxt
        dists[j] = float(np.sqrt(cur[nxt]))
        d2 = ((X - X[nxt]) ** 2).sum(axis=1)
        np.minimum(cur, d2, out=cur)
    return perm, dists
