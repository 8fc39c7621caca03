"""Compensated (float-float) reductions (port of solvers/reductions.py).

Chunk partial sums combined with an error-free TwoSum scan into a (hi, lo)
accumulator: accumulation error ~ few eps independent of n, the float64
accumulation semantics the reference assumes (SRC/utils/utils.h:28-32),
at float32.
"""

import torch

_CHUNK = 8192


def _two_sum(a, b):
    """Error-free a + b = s + e (Knuth TwoSum)."""
    s = a + b
    bp = s - a
    e = (a - (s - bp)) + (b - bp)
    return s, e


def _comp_scan(partials):
    """TwoSum-combine the rows of `partials` (leading axis) in order."""
    hi = torch.zeros_like(partials[0])
    lo = torch.zeros_like(partials[0])
    for p in partials:
        hi, e = _two_sum(hi, p)
        lo = lo + e
    return hi + lo


def comp_sum(x, chunk: int = _CHUNK):
    """Compensated sum of a 1-D tensor via chunked TwoSum accumulation."""
    n = x.shape[0]
    if n <= chunk:
        return torch.sum(x)
    nb = -(-n // chunk)
    xp = torch.zeros(nb * chunk, dtype=x.dtype, device=x.device)
    xp[:n] = x
    return _comp_scan(torch.sum(xp.reshape(nb, chunk), dim=1))


def comp_dot(a, b, chunk: int = _CHUNK):
    return comp_sum((a * b).reshape(-1), chunk)


def comp_norm(a, chunk: int = _CHUNK):
    """Compensated 2-norm, rescaled by the max to avoid overflow."""
    m = torch.max(torch.abs(a))
    safe_m = torch.where(m == 0, torch.ones_like(m), m)
    s = comp_sum(((a / safe_m) ** 2).reshape(-1), chunk)
    return safe_m * torch.sqrt(torch.clamp(s, min=0.0))


def comp_gemv(V, w, chunk: int = _CHUNK):
    """Compensated V @ w for (m, n) V: per-chunk GEMV partials, TwoSum-combined."""
    m, n = V.shape
    if n <= chunk:
        return V @ w
    nb = n // chunk
    n0 = nb * chunk
    partials = torch.einsum(
        "mbc,bc->bm", V[:, :n0].reshape(m, nb, chunk), w[:n0].reshape(nb, chunk)
    )
    if n0 < n:
        partials = torch.cat([partials, (V[:, n0:] @ w[n0:])[None, :]], dim=0)
    return _comp_scan(partials)


def make_reducers(compensated: bool):
    """(dot, norm) pair for a solver: plain torch or compensated."""
    if compensated:
        return comp_dot, comp_norm
    return (lambda a, b: torch.dot(a, b)), torch.linalg.norm
