"""Preconditioned conjugate gradient (port of solvers/pcg.py).

Textbook PCG (ref SRC/solvers/pcg.c:3-206) with a relative or absolute
tolerance, breakdown guards on rho == 0 / pq <= 0, a true-residual recheck
on tentative convergence (pcg.c:181-193), optional periodic residual
replacement, and the residual history.  The JAX version is a fixed-shape
while-loop; this loop exits at the same step and returns the same x,
niter, relres and NaN-padded history.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .reductions import make_reducers


class PcgResult(NamedTuple):
    x: torch.Tensor
    relres: torch.Tensor         # final relative residual (true after a recheck)
    niter: int                   # iterations executed
    res_history: torch.Tensor    # relative residual per iteration, NaN-padded
    converged: bool


def pcg(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    precond: Optional[Callable] = None,
    tol: float = 1e-8,
    atol: bool = False,
    maxits: int = 100,
    compensated: bool = False,
    replace_every: int = 0,
    group=None,
) -> PcgResult:
    """compensated=True: TwoSum float-float dots and norms (reductions.py).

    replace_every=m > 0: every m iterations the recursion residual is
    replaced by the true residual b - A x, one extra matvec per m steps.
    group: the points axis's process group; b, x0 and the operators are
    then this rank's rows and the dots and norms sum over the ranks."""
    x = torch.zeros_like(b) if x0 is None else x0
    psolve = precond if precond is not None else (lambda r: r)
    dot_fn, norm_fn = make_reducers(compensated, group)

    normb = norm_fn(b)
    tolb = torch.full_like(normb, tol) if atol else tol * normb
    safe_normb = torch.where(normb == 0, torch.ones_like(normb), normb)

    r = b - matvec(x)
    normr = norm_fn(r)
    hist = torch.full((maxits + 1,), float("nan"), dtype=b.dtype, device=b.device)
    hist[0] = normr / safe_normb

    p = torch.zeros_like(b)
    rho_prev = torch.zeros_like(normb)
    it = 0
    stop = bool(normr < tolb)           # direct-solution early exit (ref pcg.c:70-84)
    while it < maxits and not stop:
        z = psolve(r)
        rho = dot_fn(z, r)
        if it == 0:
            p = z
        else:
            p = z + rho / torch.where(rho_prev == 0, torch.ones_like(rho_prev), rho_prev) * p
        q = matvec(p)
        pq = dot_fn(p, q)
        breakdown = bool(rho == 0.0) or bool(pq <= 0.0)
        alpha = torch.zeros_like(rho) if breakdown else rho / torch.where(
            pq == 0, torch.ones_like(pq), pq)
        x = x + alpha * p
        r = r - alpha * q
        normr = norm_fn(r)
        it += 1
        hist[it] = normr / safe_normb
        # true-residual recheck on tentative convergence (ref pcg.c:181-193)
        if bool(normr <= tolb) or (replace_every > 0 and it % replace_every == 0):
            r = b - matvec(x)
            normr = norm_fn(r)
            hist[it] = normr / safe_normb
        stop = breakdown or bool(normr <= tolb)
        rho_prev = rho
    return PcgResult(x=x, relres=normr / safe_normb, niter=it, res_history=hist,
                     converged=bool(normr <= tolb))
