"""Flexible GMRES (port of solvers/fgmres.py).

Restarted flexible GMRES (ref SRC/solvers/fgmres.c:3-252): CGS2
orthogonalization, Givens rotations, per-column storage of the
preconditioned basis Z = M^{-1} V, and restarts gated on the TRUE residual.
The JAX version runs fixed-shape masked while-loops; here the loops exit
early, and return the same x, niter, relres and residual history.
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from .reductions import _two_sum, comp_gemv, make_reducers


class FgmresResult(NamedTuple):
    x: torch.Tensor
    relres: torch.Tensor
    niter: int
    res_history: torch.Tensor
    converged: bool


def _cgs2(w, V, compensated: bool = False, norm_fn=torch.linalg.norm, group=None):
    """Two-pass classical Gram-Schmidt of w against the rows of V (rows past
    the current step are zero).  Returns (w_orth, h, ||w_orth||).  group:
    the projections' local partials are summed over its ranks."""
    local = comp_gemv if compensated else (lambda V_, w_: V_ @ w_)
    proj = local if group is None else (lambda V_, w_: group.psum(local(V_, w_)))
    h1 = proj(V, w)
    w = w - h1 @ V
    h2 = proj(V, w)
    w = w - h2 @ V
    return w, h1 + h2, norm_fn(w)


def fgmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Optional[Callable] = None,
    kdim: int = 50,
    maxits: Optional[int] = None,
    tol: float = 1e-8,
    atol: bool = False,
    compensated: bool = False,
    group=None,
) -> FgmresResult:
    """compensated=True: TwoSum float-float accumulation in norms, projections
    and the x update (reductions.py).

    group: the points axis's process group (parallel/mesh.py); b, x0 and the
    operators are then this rank's rows, and every norm and projection sums
    over the ranks, so the small least-squares problem and the stopping
    decisions agree on every rank."""
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    psolve = precond if precond is not None else (lambda r: r)
    maxits = kdim if maxits is None else maxits
    _, norm_fn = make_reducers(compensated, group)
    eps = torch.finfo(dtype).eps

    normb = float(norm_fn(b))
    safe_normb = 1.0 if normb == 0 else normb
    tolb = tol if atol else tol * normb
    hist = torch.full((maxits + 1,), float("nan"), dtype=dtype, device=dev)

    total_it = 0
    stop = False
    # each cycle starts from the true residual the previous one ended with
    r = b if x0 is None else b - matvec(x)
    while not stop:
        beta = float(norm_fn(r))
        hist[total_it] = beta / safe_normb
        V = torch.zeros((kdim + 1, n), dtype=dtype, device=dev)
        Z = torch.zeros((kdim, n), dtype=dtype, device=dev)
        V[0] = r / (1.0 if beta == 0 else beta)
        # the small least-squares problem lives on the host: kdim scalars
        H = [[0.0] * kdim for _ in range(kdim + 1)]
        g = [0.0] * (kdim + 1)
        g[0] = beta
        cs = [0.0] * kdim
        sn = [0.0] * kdim
        j = 0
        inner_stop = beta <= tolb
        while j < kdim and not inner_stop:
            zj = psolve(V[j])
            Z[j] = zj
            w, h_t, t_t = _cgs2(matvec(zj), V, compensated, norm_fn, group)
            h = h_t.tolist()
            t = float(t_t)
            h[j + 1] = t
            lucky = t <= eps * safe_normb
            V[j + 1] = w / (1.0 if t == 0 else t)
            for i in range(j):   # apply the previous rotations to column h
                hi, hi1 = h[i], h[i + 1]
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = math.sqrt(h[j] * h[j] + h[j + 1] * h[j + 1])
            c = 1.0 if denom == 0 else h[j] / denom
            s = 0.0 if denom == 0 else h[j + 1] / denom
            cs[j], sn[j] = c, s
            h[j], h[j + 1] = denom, 0.0
            for i in range(kdim + 1):
                H[i][j] = h[i]
            gj = g[j]
            g[j] = c * gj
            g[j + 1] = -s * gj
            res = abs(g[j + 1])
            hist[total_it + j + 1] = res / safe_normb
            inner_stop = res <= tolb or lucky or total_it + j + 1 >= maxits
            j += 1

        # upper-triangular solve R y = g on the j active columns
        y = torch.zeros(kdim, dtype=dtype, device=dev)
        if j > 0:
            R = torch.tensor([row[:j] for row in H[:j]], dtype=dtype)
            ge = torch.tensor(g[:j], dtype=dtype)
            y[:j] = torch.linalg.solve_triangular(R, ge[:, None], upper=True)[:, 0].to(dev)
        if compensated:
            # TwoSum scan over the kdim axis: the 1/eta-amplified basis terms
            # cancel catastrophically in a plain sum
            hi, lo = x, torch.zeros_like(x)
            for yz in y[:, None] * Z:
                hi, e = _two_sum(hi, yz)
                lo = lo + e
            x = hi + lo
        else:
            x = x + Z.T @ y
        total_it += j
        r = b - matvec(x)
        res_true = norm_fn(r)
        stop = float(res_true) <= tolb or total_it >= maxits

    relres = res_true / safe_normb
    return FgmresResult(
        x=x, relres=relres, niter=total_it, res_history=hist,
        converged=bool(relres * safe_normb <= tolb),
    )
