"""Dense Cholesky preconditioner / exact solver (port of preconds/chol.py).

Ref SRC/preconds/chol.c:
- setup: K (+ stacked dK), stabilization shift nu = sqrt(n) ulp(||K||_F)
  (chol.c:448-464), Cholesky
- solve: two triangular solves (chol.c:111-137)
- logdet = 2 sum log diag L (chol.c:293-323)
- trace_j = tr(K^{-1} dK_j), one batched Cholesky solve over j
- dvp: z -> M^{-1} dK_j z (chol.c:138-292)
"""

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.kernels import KernelParams, kernel_matrix, kernel_matrix_with_grad
from ..ops.matops import chol_solve, stable_chol


@dataclass
class CholPrecond:
    L: torch.Tensor                  # (n, n) lower Cholesky factor of K + nu I
    dK: Optional[torch.Tensor]       # (3, n, n) or None
    nu: torch.Tensor

    def solve(self, r):
        """M^{-1} r for r of shape (n,) or rows (nv, n)."""
        return chol_solve(self.L, r) if r.ndim == 1 else chol_solve(self.L, r.T).T

    def logdet(self):
        return 2.0 * torch.sum(torch.log(torch.diagonal(self.L)))

    def trace(self):
        """(3,) tr(K^{-1} dK_j)."""
        return torch.diagonal(chol_solve(self.L, self.dK), dim1=1, dim2=2).sum(dim=1)

    def dvp(self, z):
        """Stacked M^{-1} dK_j z: (3, n) for z (n,), (nv, 3, n) for rows (nv, n)."""
        if z.ndim == 1:
            return chol_solve(self.L, torch.einsum("knm,m->kn", self.dK, z).T).T
        nv, n = z.shape
        dKz = torch.einsum("knm,vm->vkn", self.dK, z).reshape(nv * 3, n)
        return chol_solve(self.L, dKz.T).T.reshape(nv, 3, n)


def chol_setup(K=None, *, kind=None, params: KernelParams = None, X=None,
               require_grad: bool = False, dK=None) -> CholPrecond:
    """Build from an explicit K (+ dK) or from (kind, params, X)."""
    if K is None:
        if require_grad:
            K, dK = kernel_matrix_with_grad(kind, params, X)
        else:
            K = kernel_matrix(kind, params, X)
    L, nu = stable_chol(K)
    return CholPrecond(L=L, dK=dK if require_grad or dK is not None else None, nu=nu)
