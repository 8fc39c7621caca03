"""AFN preconditioner: Nystrom on FPS landmarks + FSAI on the implicit
Schur-complement kernel (port of preconds/afn.py).

Rebuild of the MATLAB reference (afn_setup.m:30-109, afn_solve.m,
afn_logdet.m, afn_trace.m, afn_dvp.m; control flow as SRC/preconds/afn.c:
161-485).  With k landmarks and n2 = n - k Schur points in permuted order:
      | K11   K12 |                  U = | L11'   L11^{-1} K12 |
  K = | K12'  K22 |,   M = U' U,         | 0      G^{-T}       |
L11 = chol(K11) (noise included), G the FSAI factor of the Schur kernel
  S(i,j) = K22(i,j) - (L11^{-1} K12)_i' (L11^{-1} K12)_j
evaluated on the FSAI pattern blocks only.

- solve:  zl = xl - K12'(K11^{-1} xu); yl = G'G zl; yu = K11^{-1}(xu - K12 yl)
- logdet: 2 (sum log diag L11 - sum log diag G)
- trace:  2 sum diag(dU) / diag(U), exact since U is triangular
- dvp:    M^{-1}(dU'U + U'dU) z, with dL11 = L phi(L^{-1} dK11 L^{-T})

Set-up (afn_setup.m:58-98): the rank estimate; FPS landmarks; below maxrank
the preconditioner is plain Nystrom on those points (the "RAN" branch).
The plan (`afn_plan`) is made on the host in numpy, as in the JAX package,
so the order and the pattern come out equal; the Schur tail is cell-sorted
by quantile bins (a 2-PC projection when d > 3).  The JAX package then
stores G in a dense cell stencil for the TPU; the port keeps padded ELL
with a gather-only transpose.  Every method takes (n,) or rows (nv, n).
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cellgrid as cg
from ..ops.fps import fps_host
from ..ops.kernels import (
    KernelParams,
    additive_kernel_matrix,
    additive_kernel_matrix_with_grad,
    kernel_matrix,
    kernel_matrix_with_grad,
)
from ..ops.knn import knn_pattern_host
from ..ops.matops import chol_solve, ell_apply, stable_chol, tril_solve, triu_solve
from ..ops.rankest import RankestConfig, draw_subsamples, estimate_rank, rankest_default
from ..utils.datasets import expand_perm
from .fsai import FsaiPrecond, fsai_rows, transpose_pattern
from .nystrom import nystrom_setup

# columns of the (k, n2) cross block built at once: the additive kernel's
# per-window distance intermediates are each (k, columns)
COL_CHUNK = 131072


def _phi(A):
    """Cholesky-differential half operator: tril(A, -1) + diag(A)/2, batched."""
    return torch.tril(A, -1) + 0.5 * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))


def _cols(x):
    return x[:, None] if x.ndim == 1 else x.T


@dataclass
class AfnPrecond:
    perm: torch.Tensor              # (n,) FPS-expanded permutation
    inv_perm: torch.Tensor          # (n,) its inverse: the un-permute is a gather
    L11: torch.Tensor               # (k, k)
    K12: torch.Tensor               # (k, n2)
    gs: FsaiPrecond                 # FSAI of the Schur kernel (size n2)
    dL11: Optional[torch.Tensor]    # (3, k, k)
    dK12: Optional[torch.Tensor]    # (3, k, n2)

    @property
    def k(self):
        return self.L11.shape[0]

    @property
    def n(self):
        return self.perm.shape[0]

    @property
    def breakdown(self):
        """Rows of the Schur FSAI repaired (0-d int tensor)."""
        return self.gs.breakdown

    def _solve_permuted(self, X):
        """M^{-1} on columns X (n, m) in permuted order."""
        k = self.k
        xu, xl = X[:k], X[k:]
        zl = xl - self.K12.T @ chol_solve(self.L11, xu)
        yl = self.gs.solve(zl.T).T
        yu = chol_solve(self.L11, xu - self.K12 @ yl)
        return torch.cat([yu, yl])

    def solve(self, r):
        """M^{-1} r for r (n,) or rows (nv, n)."""
        y = self._solve_permuted(_cols(r)[self.perm])[self.inv_perm]
        return y[:, 0] if r.ndim == 1 else y.T

    def logdet(self):
        return 2.0 * (torch.sum(torch.log(torch.diagonal(self.L11)))
                      - torch.sum(torch.log(self.gs.val[:, -1])))

    def trace(self):
        dldiag = torch.diagonal(self.dL11, dim1=1, dim2=2)            # (3, k)
        gs = self.gs
        return 2.0 * (torch.sum(dldiag / torch.diagonal(self.L11)[None, :], dim=1)
                      - torch.sum(gs.dval[:, :, -1] / gs.val[None, :, -1], dim=1))

    def _dM_apply(self, Z):
        """(3, n, m) stacked dM_j Z for columns Z (n, m) in permuted order
        (afn_dvp.m); the three j and the m columns share every solve."""
        k, m = self.k, Z.shape[1]
        L, K12, gs = self.L11, self.K12, self.gs
        dL, dK12 = self.dL11, self.dK12
        xu, xl = Z[:k], Z[k:]
        n2 = xl.shape[0]

        def cols3(R):                       # rows (3 m, n2) -> (3, n2, m)
            return R.reshape(3, m, n2).transpose(1, 2)

        # U z
        K12xl = tril_solve(L, K12 @ xl)                               # L^{-1} K12 xl
        z1u = L.T @ xu + K12xl
        z1l = gs.solve_Gt(xl.T)                                       # rows (m, n2): G^{-T} xl
        t = triu_solve(L, z1u)                                        # L^{-T} z1u
        Giz1l = gs.solve_G(z1l)                                       # G^{-1} z1l
        dG_Giz1l = torch.stack([ell_apply(gs.idx, dv, Giz1l) for dv in gs.dval])  # (3, m, n2)
        dGt_z1l = torch.stack([gs._rmat(dv, z1l) for dv in gs.dval])             # (3, m, n2)
        # y1 = dU'(U z), y2 = U'(dU z); the G^{-1} terms of both share a solve
        z2l = -gs.solve_Gt(dGt_z1l.reshape(3 * m, n2))                           # (3 m, n2)
        Gi = cols3(gs.solve_G(z2l - dG_Giz1l.reshape(3 * m, n2)))                # (3, n2, m)
        y1u = dL @ z1u
        dLt_t = triu_solve(L, (dL.mT @ t).transpose(0, 1).reshape(k, 3 * m))
        y1l = dK12.mT @ t - (K12.T @ dLt_t).reshape(n2, 3, m).transpose(0, 1)
        y2u_i = dK12 @ xl - dL @ K12xl
        z2u = dL.mT @ xu + tril_solve(L, y2u_i.transpose(0, 1).reshape(k, 3 * m)).reshape(
            k, 3, m).transpose(0, 1)
        y2u = L @ z2u
        y2l = (K12.T @ triu_solve(L, z2u.transpose(0, 1).reshape(k, 3 * m))).reshape(
            n2, 3, m).transpose(0, 1)
        return torch.cat([y1u + y2u, y1l + y2l + Gi], dim=1)

    def dvp(self, z):
        """px_j = M^{-1} dM_j z with E[z' px_j] = trace()[j]: (3, n) for z
        (n,), (nv, 3, n) for rows (nv, n)."""
        Zp = _cols(z)[self.perm]                                      # (n, m)
        n, m = Zp.shape
        dMz = self._dM_apply(Zp)                                      # (3, n, m)
        px = self._solve_permuted(dMz.transpose(0, 1).reshape(n, 3 * m))[self.inv_perm]
        px = px.reshape(n, 3, m)
        return px[:, :, 0].T if z.ndim == 1 else px.permute(2, 1, 0)


class AfnPlan(NamedTuple):
    """Structure decided once per dataset (host numbers, device tensors)."""

    perm: torch.Tensor      # (n,) FPS-expanded, Schur tail cell-sorted
    k: int                  # landmark count
    use_ran: bool           # True: plain Nystrom on the landmarks
    pattern: tuple          # (idx, mask) (n2, lfil) KNN pattern of the Schur points
    pattern_t: tuple        # its transpose pattern (ops/matops.ell_transpose_pattern)


def plan_from_arrays(perm, k, use_ran, pattern, device=None) -> AfnPlan:
    """An AfnPlan on `device` from numpy arrays (a plan made by afn_plan, or
    the perm / k / use_ran / pattern of a JAX AfnPlan)."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    idx, mask = t(pattern[0], torch.int64), t(pattern[1], torch.bool)
    return AfnPlan(perm=t(perm, torch.int64), k=int(k),
                   use_ran=bool(use_ran), pattern=(idx, mask), pattern_t=transpose_pattern(idx, mask))


def afn_plan(kind: str, params: KernelParams, X, *, maxrank: int = 200, lfil: int = 20,
             generator: Optional[torch.Generator] = None, rank: Optional[int] = None,
             rankest_cfg: RankestConfig = RankestConfig(), force_afn: bool = False,
             subsamples=None) -> AfnPlan:
    """Rank estimation + FPS + pattern (afn_setup.m:58-78), on X's device.

    rank=None runs the two-stage estimate (afn.c:182-243): the scaled
    Nystrom-error estimate; if it reaches maxrank, AFN with maxrank
    landmarks, else the eigen-curve + fill-distance estimate, whose full-set
    FPS gives the landmarks.  Both stages use the same subsamples, drawn
    from `generator` or passed as `subsamples` (as the JAX package hands
    both its one key)."""
    n = X.shape[0]
    dev = X.device
    fps_prefix = None
    if rank is None:
        subs = subsamples if subsamples is not None else draw_subsamples(n, rankest_cfg, generator)
        k1 = estimate_rank(kind, params, X, cfg=rankest_cfg, subsamples=subs)
        if k1 >= maxrank:
            rank = maxrank
        else:
            rank, fps_prefix = rankest_default(kind, params, X, cfg=rankest_cfg, maxrank=maxrank,
                                               subsamples=subs)
            rank = min(max(k1, rank), maxrank)
    k = min(rank, maxrank, n)
    use_ran = (k < maxrank) and not force_afn
    k = max(k, 1)
    Xh = X.detach().cpu().numpy()
    if fps_prefix is not None:
        perm = expand_perm(torch.as_tensor(fps_prefix[:k]), n).numpy()
    else:
        pk, _ = fps_host(Xh, k)
        perm = np.concatenate([pk, np.setdiff1d(np.arange(n, dtype=np.int64), pk, assume_unique=False)])
    if use_ran:
        empty = (np.zeros((0, lfil), np.int64), np.zeros((0, lfil), bool))
        return plan_from_arrays(perm, k, True, empty, dev)

    # cell-sort the Schur tail (quantile bins; the 2-PC projection when
    # d > 3), which sets the order the preceding-KNN pattern follows
    X2 = Xh[perm[k:]]
    d_amb = X2.shape[1]
    if d_amb <= 3:
        Xproj = X2
    else:
        Xc = X2 - X2.mean(0)
        _, _, Vt = np.linalg.svd(Xc[:: max(1, len(Xc) // 20000)], full_matrices=False)
        Xproj = Xc @ Vt[:2].T
    # occupancy >= 1.5 lfil, so a row's lfil nearest preceding points lie
    # within one cell hop (the JAX package's sizing)
    grid = cg.build_cell_grid(Xproj, target_occupancy=max(8.0, 1.5 * lfil), binning="quantile")
    if grid is not None:
        order = grid.perm.astype(np.int64)
        perm = np.concatenate([perm[:k], perm[k:][order]])
        Xproj = Xproj[order]
    Xpat = Xh[perm[k:]] if d_amb <= 3 else Xproj
    return plan_from_arrays(perm, k, False, knn_pattern_host(Xpat, lfil), dev)


def _kernel_fns(kind, windows):
    if windows is None:
        return (lambda p, A, B=None: kernel_matrix(kind, p, A, B),
                lambda p, A, B=None: kernel_matrix_with_grad(kind, p, A, B))
    return (lambda p, A, B=None: additive_kernel_matrix(kind, p, A, windows, B),
            lambda p, A, B=None: additive_kernel_matrix_with_grad(kind, p, A, windows, B))


def afn_setup_from_plan(kind: str, params: KernelParams, X, plan: AfnPlan, *,
                        require_grad: bool = False, windows=None):
    """Numeric factorization for a fixed plan, re-run per hyperparameters."""
    if plan.use_ran:
        return nystrom_setup(kind, params, X, plan.perm, plan.k, require_grad=require_grad,
                             windows=windows)
    k = plan.k
    Xp = X[plan.perm]
    X1, X2 = Xp[:k], Xp[k:]
    mat, mat_g = _kernel_fns(kind, windows)
    n2 = X2.shape[0]
    chunks = [X2[c0:c0 + COL_CHUNK] for c0 in range(0, n2, COL_CHUNK)]
    if require_grad:
        K11, dK11 = mat_g(params, X1)
        parts = [mat_g(params, X1, Xc) for Xc in chunks]
        K12 = torch.cat([p[0] for p in parts], dim=1)
        dK12 = torch.cat([p[1] for p in parts], dim=2)
        del parts
    else:
        K11 = mat(params, X1)
        K12 = torch.cat([mat(params, X1, Xc) for Xc in chunks], dim=1)
        dK11 = dK12 = None

    L11, _ = stable_chol(K11)
    GK12 = tril_solve(L11, K12)
    if require_grad:
        # dL11 = L phi(L^{-1} dK11 L^{-T})
        GdKG = torch.stack([tril_solve(L11, tril_solve(L11, dk).T).T for dk in dK11])
        dL11 = L11 @ _phi(GdKG)
        GdK12 = torch.stack([tril_solve(L11, dk) for dk in dK12])          # (3, k, n2)
        GdK11GK12 = GdKG @ GK12                                             # (3, k, n2)
    else:
        dL11 = None

    idx, mask = plan.pattern

    def block_fn(J):
        XJ = X2[J]                                     # (rows, lfil, d)
        gk = GK12[:, J].permute(1, 0, 2)               # (rows, k, lfil)
        if not require_grad:
            return mat(params, XJ) - gk.mT @ gk, None
        B22, dB22 = mat_g(params, XJ)                  # dB22 (3, rows, l, l)
        dB = []
        for j in range(3):
            cross = gk.mT @ GdK12[j][:, J].permute(1, 0, 2)
            dB.append(dB22[j] - cross - cross.mT + gk.mT @ GdK11GK12[j][:, J].permute(1, 0, 2))
        return B22 - gk.mT @ gk, torch.stack(dB, dim=1)

    val, dval, breakdown = fsai_rows(block_fn, idx, mask)
    gs = FsaiPrecond(idx=idx, mask=mask, val=val, dval=dval, breakdown=breakdown,
                     pattern_t=plan.pattern_t)
    return AfnPrecond(perm=plan.perm, inv_perm=torch.argsort(plan.perm), L11=L11, K12=K12, gs=gs,
                      dL11=dL11, dK12=dK12)


def afn_setup(kind: str, params: KernelParams, X, *, maxrank: int = 200, lfil: int = 20,
              generator: Optional[torch.Generator] = None, rank: Optional[int] = None,
              require_grad: bool = False, windows=None, force_afn: bool = False, subsamples=None):
    """Plan + factorization.  If the Schur FSAI breaks down (non-SPD blocks)
    the preconditioner falls back wholesale to Nystrom on the same FPS
    landmarks (afn_setup.m:93-98).  Returns (precond, plan)."""
    plan = afn_plan(kind, params, X, maxrank=maxrank, lfil=lfil, generator=generator, rank=rank,
                    force_afn=force_afn, subsamples=subsamples)
    precond = afn_setup_from_plan(kind, params, X, plan, require_grad=require_grad, windows=windows)
    if not plan.use_ran and int(precond.breakdown) > 0:
        plan = plan._replace(use_ran=True)
        precond = afn_setup_from_plan(kind, params, X, plan, require_grad=require_grad,
                                      windows=windows)
    return precond, plan
