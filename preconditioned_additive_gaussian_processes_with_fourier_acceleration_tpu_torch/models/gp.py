"""GP marginal-likelihood loss with analytic gradient, and GP prediction
(port of models/gp.py).

  loss   = 0.5 * ( y' K^{-1} y / n  +  logdet(K)/n  +  log 2 pi )
  grad_j = 0.5 * ( -(K^{-1}y)' dK_j (K^{-1}y)/n + tr(K^{-1} dK_j)/n ) * dt_j

K^{-1}y by FGMRES (kdim = 2 maxits, ref SRC/optimizer/gp_loss.c:199-213),
logdet and traces by preconditioned SLQ over the injected probes
(gp_loss.c:240-255): the reference's estimator, no autodiff.

Operators are (matvec, dmatvec) pairs that take one vector (n,) or a batch
of rows (nv, n): matvec returns the same shape, dmatvec (3, n) or (nv, 3, n).

Prediction (gp_predict.c:61-280): mean = K12' K11^{-1} y; optional
std_i = sqrt|K22_ii - K12_i' K11^{-1} K12_i|, K22's diagonal with the
noise term (a same-set evaluation, gp_predict.c:181).  One FGMRES solve per
test point, as the reference loops (the JAX package batches them).
"""

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import fastsum as fs
from ..ops.kernels import (
    KernelParams,
    additive_kernel_matrix,
    additive_kernel_matrix_with_grad,
    kernel_matrix,
    kernel_matrix_with_grad,
)
from ..preconds.nystrom import nystrom_setup
from ..solvers.fgmres import fgmres
from ..solvers.lanczos import slq_logdet
from ..solvers.reductions import psum
from ..utils.timers import host_read, span
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
            precond_setup: Optional[Callable] = None, group=None) -> GPLossResult:
    """Negative log marginal likelihood per point and its analytic gradient.

    raw_params: (3,) untransformed (f, l, mu); probes: (nvecs, n) Rademacher.
    group: the points axis's process group (parallel/mesh.py): y and the
    probes' columns are then this rank's rows, the operators and the
    preconditioner map rows to rows, n is the global count and every sum
    over points adds the ranks' partials; the loss and gradient come out the
    same on every rank.

    Traced (utils/timers.py) as a `loss` span holding `op_build`,
    `precond_setup`, `fgmres` and `slq`.
    """
    with span("loss"):
        n = y.shape[0] if group is None else group.n_global(y.shape[0])
        tvals, dtvals = transform_forward(cfg.transform, raw_params)
        params = KernelParams(f=tvals[0], l=tvals[1], mu=tvals[2])
        with span("op_build"):
            matvec, dmatvec = build_ops(params)
        precond = _precond(precond_setup, params)

        solve_its = min(n, cfg.maxits * 2)
        sol = fgmres(matvec, y, precond=precond.solve if precond is not None else None,
                     kdim=solve_its, maxits=solve_its, tol=cfg.tol, atol=cfg.atol, group=group)
        iKY = sol.x
        L1 = psum(torch.dot(y, iKY), group) / n
        L1_grad = psum(dmatvec(iKY) @ iKY, group) / n * dtvals

        slq = slq_logdet(matvec, dmatvec, probes, maxits=min(n, cfg.maxits), precond=precond, group=group)
        loss = 0.5 * (L1 + slq.logdet + LOG_2PI)
        mask = host_read(cfg.mask, lambda m: torch.as_tensor(m, dtype=loss.dtype, device=loss.device))
        grad = 0.5 * (-L1_grad + slq.dlogdet * dtvals) * mask
        return GPLossResult(loss=loss, grad=grad, l1=L1, l2=slq.logdet,
                            solve_relres=sol.relres, solve_iters=sol.niter)


def _precond(precond_setup: Optional[Callable], params):
    """precond_setup(params) in a `precond_setup` span, or None."""
    if precond_setup is None:
        return None
    with span("precond_setup"):
        return precond_setup(params)


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


class GPPredictResult(NamedTuple):
    mean: torch.Tensor
    std: Optional[torch.Tensor]
    solve_relres: torch.Tensor
    solve_iters: int


def _params(cfg: GPConfig, raw_params) -> KernelParams:
    tvals, _ = transform_forward(cfg.transform, raw_params)
    return KernelParams(f=tvals[0], l=tvals[1], mu=tvals[2])


def _solver(matvec, psolve, its: int, cfg: GPConfig):
    return lambda rhs: fgmres(matvec, rhs, precond=psolve, kdim=its, maxits=its, tol=cfg.tol,
                              atol=cfg.atol)


def _std(params, quad):
    """sqrt|K22_ii - quad_i|; K22's diagonal f^2 (1 + mu) holds the noise."""
    return torch.sqrt(torch.abs(params.f * params.f * (1.0 + params.mu) - quad))


def gp_predict(raw_params, X, y, X_test, cfg: GPConfig, *, windows=None,
               precond_setup: Optional[Callable] = None, with_std: bool = False,
               maxits: Optional[int] = None) -> GPPredictResult:
    """GP posterior mean (and std) on the dense kernel (gp_predict.c:61-280).
    maxits: FGMRES steps per solve, default min(n, 200) (kdim = n would
    hold an (n+1, n) basis).  Traced as gp_predict_fastsum is."""
    with span("predict"):
        n = X.shape[0]
        params = _params(cfg, raw_params)
        with span("op_build"):
            if windows is None:
                K11 = kernel_matrix(cfg.kind, params, X)
                K12 = kernel_matrix(cfg.kind, params, X, X_test)          # no noise (cross)
            else:
                K11 = additive_kernel_matrix(cfg.kind, params, X, windows)
                K12 = additive_kernel_matrix(cfg.kind, params, X, windows, X_test)
        precond = _precond(precond_setup, params)
        its = min(n, maxits if maxits is not None else 200)
        solve = _solver(lambda v: K11 @ v, precond.solve if precond is not None else None, its, cfg)
        sol = solve(y)
        with span("mean"):
            mean = K12.T @ sol.x
        std = None
        if with_std:
            quad = torch.stack([torch.dot(K12[:, j], solve(K12[:, j]).x) for j in range(X_test.shape[0])])
            std = _std(params, quad)
        return GPPredictResult(mean=mean, std=std, solve_relres=sol.relres, solve_iters=sol.niter)


def gp_predict_fastsum(raw_params, X, y, X_test, cfg: GPConfig, *, windows=None,
                       fastsum_N: int = 32, precond_setup: Optional[Callable] = None,
                       with_std: bool = False, maxits: Optional[int] = None, oversample: int = 2,
                       nearfield_lfil: int = 0, std_chunk: int = 16) -> GPPredictResult:
    """Fourier-accelerated GP prediction on a joint [train; test] plan (ref
    Nfft4GPAdditiveNFFTGpPredict, nfft_interface.c:873-1061), on the table
    engine with tables in the data dtype, as in the JAX package.

    The mean is the tail of K_joint [K11^{-1} y; 0] (the joint mu x term
    adds nothing there).  The std solves one system per test point on the
    train plan; the right-hand sides, columns of the joint kernel, are
    extracted `std_chunk` test points at a time as one batched matvec.

    Traced (utils/timers.py) as a `predict` span holding `op_build` (the
    two plans), `precond_setup`, the solves' `fgmres` and `mean` (the
    joint matvec)."""
    with span("predict"):
        n, n_test = X.shape[0], X_test.shape[0]
        params = _params(cfg, raw_params)
        X_all = torch.cat([X, X_test])
        opts = dict(oversample=oversample, nearfield_lfil=nearfield_lfil)
        with span("op_build"):
            if windows is not None:
                plans = [fs.additive_fastsum_coeffs(cfg.kind, params,
                                                    fs.additive_fastsum_geometry(Z, windows, N=fastsum_N), **opts)
                         for Z in (X, X_all)]
                mv_tr, mv_all = (lambda v, p=p: fs.additive_fastsum_matvec(p, v) for p in plans)
            else:
                plans = [fs.fastsum_coeffs(cfg.kind, params, fs.fastsum_geometry(Z, N=fastsum_N), **opts)
                         for Z in (X, X_all)]
                mv_tr, mv_all = (lambda v, p=p: fs.fastsum_matvec(p, v) for p in plans)
        precond = _precond(precond_setup, params)
        solve = _solver(mv_tr, precond.solve if precond is not None else None,
                        maxits if maxits is not None else min(n, 200), cfg)
        sol = solve(y)
        with span("mean"):
            mean = mv_all(torch.cat([sol.x, y.new_zeros(n_test)]))[n:]
        std = None
        if with_std:
            chunk = max(1, min(std_chunk, n_test))
            quads = []
            for s in range(0, n_test, chunk):
                m = min(chunk, n_test - s)
                E = y.new_zeros((m, n + n_test))
                rows = torch.arange(m, device=y.device)
                E[rows, n + s + rows] = 1.0
                k12 = mv_all(E)[:, :n]
                quads += [torch.dot(k, solve(k).x) for k in k12]
            std = _std(params, torch.stack(quads))
        return GPPredictResult(mean=mean, std=std, solve_relres=sol.relres, solve_iters=sol.niter)
