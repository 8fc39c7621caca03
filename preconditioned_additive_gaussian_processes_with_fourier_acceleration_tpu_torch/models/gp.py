"""GP marginal-likelihood loss with analytic gradient (port of models/gp.py).

  loss   = 0.5 * ( y' K^{-1} y / n  +  logdet(K)/n  +  log 2 pi )
  grad_j = 0.5 * ( -(K^{-1}y)' dK_j (K^{-1}y)/n + tr(K^{-1} dK_j)/n ) * dt_j

K^{-1}y by FGMRES (kdim = 2 maxits, ref SRC/optimizer/gp_loss.c:199-213),
logdet and traces by preconditioned SLQ over the injected probes
(gp_loss.c:240-255): the reference's estimator, no autodiff.

Operators are (matvec, dmatvec) pairs that take one vector (n,) or a batch
of rows (nv, n): matvec returns the same shape, dmatvec (3, n) or (nv, 3, n).
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops.kernels import (
    KernelParams,
    additive_kernel_matrix_with_grad,
    kernel_matrix_with_grad,
)
from ..preconds.nystrom import nystrom_setup
from ..solvers.fgmres import fgmres
from ..solvers.lanczos import slq_logdet
from .transforms import transform_forward

LOG_2PI = math.log(2.0 * math.pi)


class GPConfig(NamedTuple):
    kind: str = "gaussian"
    transform: str = "softplus"
    maxits: int = 10            # SLQ Lanczos steps; FGMRES uses 2*maxits
    nvecs: int = 10             # SLQ probes
    tol: float = 1e-6           # FGMRES relative tolerance
    atol: bool = False
    mask: tuple = (1, 1, 1)     # which of (f, l, mu) receive gradients


class GPLossResult(NamedTuple):
    loss: torch.Tensor
    grad: torch.Tensor
    l1: torch.Tensor
    l2: torch.Tensor
    solve_relres: torch.Tensor
    solve_iters: int


def make_dense_ops(kind: str, X, windows=None):
    """build_ops(params) -> (matvec, dmatvec) on the exact dense matrices."""

    def build(params: KernelParams):
        if windows is None:
            K, dK = kernel_matrix_with_grad(kind, params, X)
        else:
            K, dK = additive_kernel_matrix_with_grad(kind, params, X, windows)
        # v @ K == K v for symmetric K, for one vector or a batch of rows
        return (lambda v: v @ K), (lambda v: torch.einsum("knm,...m->...kn", dK, v))

    return build


def gp_loss(raw_params, y, build_ops: Callable, probes, cfg: GPConfig,
            precond_setup: Optional[Callable] = None) -> GPLossResult:
    """Negative log marginal likelihood per point and its analytic gradient.

    raw_params: (3,) untransformed (f, l, mu); probes: (nvecs, n) Rademacher.
    """
    n = y.shape[0]
    tvals, dtvals = transform_forward(cfg.transform, raw_params)
    params = KernelParams(f=tvals[0], l=tvals[1], mu=tvals[2])
    matvec, dmatvec = build_ops(params)
    precond = precond_setup(params) if precond_setup is not None else None

    solve_its = min(n, cfg.maxits * 2)
    sol = fgmres(matvec, y, precond=precond.solve if precond is not None else None,
                 kdim=solve_its, maxits=solve_its, tol=cfg.tol, atol=cfg.atol)
    iKY = sol.x
    L1 = torch.dot(y, iKY) / n
    L1_grad = (dmatvec(iKY) @ iKY) / n * dtvals

    slq = slq_logdet(matvec, dmatvec, probes, maxits=min(n, cfg.maxits), precond=precond)
    loss = 0.5 * (L1 + slq.logdet + LOG_2PI)
    mask = torch.as_tensor(cfg.mask, dtype=loss.dtype, device=loss.device)
    grad = 0.5 * (-L1_grad + slq.dlogdet * dtvals) * mask
    return GPLossResult(loss=loss, grad=grad, l1=L1, l2=slq.logdet,
                        solve_relres=sol.relres, solve_iters=sol.niter)


def gp_loss_gaussian_ran_softplus(raw_params, X, y, probes, *, rank: int = 50, maxits: int = 10,
                                  tol: float = 1e-6, perm=None) -> GPLossResult:
    """Convenience loss: dense gaussian kernel + Nystrom ("RAN")
    preconditioner + softplus transform (ref Nfft4GPGpLossGaussianRANSoftPlus,
    gp_loss.c:28-94).  perm: the landmark indices (default the first rank
    points), injectable for reproducible runs."""
    k = min(rank, X.shape[0])
    if perm is None:
        perm = torch.arange(k, device=X.device)
    cfg = GPConfig(kind="gaussian", maxits=maxits, nvecs=probes.shape[0], tol=tol)
    return gp_loss(raw_params, y, make_dense_ops("gaussian", X), probes, cfg,
                   lambda params: nystrom_setup("gaussian", params, X, perm, k, require_grad=True))
