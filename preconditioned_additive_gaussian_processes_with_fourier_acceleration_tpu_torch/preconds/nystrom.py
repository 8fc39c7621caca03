"""Stabilized Nystrom low-rank preconditioner (port of preconds/nystrom.py).

- setup (ref SRC/preconds/nys.c:518-660): noise-free column block
  K1 = K(X, X[perm[:k]]) and K11; stable Cholesky L of K11; Uf = K1 L^{-T};
  thin SVD Uf = U diag(sigma) V'; s = 1/(sigma^2 + eta), eta = mu f^2
- solve (nys.c:115-173): M^{-1} r = r/eta + U ((s - 1/eta) U' r)
- logdet (nys.c:489-516): (n-k) log eta + sum log(sigma^2 + eta)
- dvp (nys.c:175-331): M^{-1} dM_j x with
    dM_j = dK1_j K11^{-1} K1' + K1 K11^{-1} dK1_j' - K1 K11^{-1} dK11_j K11^{-1} K1'
  for j in {f, l}, and dM_mu = f^2 I (the reference omits d(eta)/df)
- trace (nys.c:332-488): Woodbury form of tr(M^{-1} dM_j)

Factors stay in the original row order, so every apply is a pair of GEMMs.
`solve` and `dvp` take one vector (n,) or a batch of rows (nv, n).
"""

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.kernels import (
    KernelParams,
    additive_kernel_matrix,
    additive_kernel_matrix_with_grad,
    kernel_matrix,
    kernel_matrix_with_grad,
)
from ..ops.matops import chol_solve, stable_chol, tril_solve


@dataclass
class NystromPrecond:
    perm: torch.Tensor          # (k,) landmark indices
    U: torch.Tensor             # (n, k) left singular vectors of Uf
    s: torch.Tensor             # (k,) 1 / (sigma^2 + eta)
    sigma2: torch.Tensor        # (k,)
    eta: torch.Tensor           # mu * f^2
    f2: torch.Tensor            # f^2
    Uf: Optional[torch.Tensor] = None     # (n, k) pre-SVD factor K1 L^{-T}
    L11: Optional[torch.Tensor] = None    # (k, k) Cholesky factor of K11
    K1: Optional[torch.Tensor] = None     # (n, k) noise-free column block
    dK1: Optional[torch.Tensor] = None    # (2, n, k) df, dl blocks
    dK11: Optional[torch.Tensor] = None   # (2, k, k)

    @property
    def k(self):
        return self.U.shape[1]

    @property
    def n(self):
        return self.U.shape[0]

    def solve(self, r):
        """M^{-1} r for r of shape (n,) or rows (nv, n)."""
        z = r @ self.U
        return r / self.eta + ((self.s - 1.0 / self.eta) * z) @ self.U.T

    def logdet(self):
        return (self.n - self.k) * torch.log(self.eta) + torch.sum(
            torch.log(self.sigma2 + self.eta)
        )

    def _dM_apply(self, j, x):
        """dM_j @ x for columns x, (n,) or (n, m); j in {0, 1}."""
        w = chol_solve(self.L11, self.K1.T @ x)            # K11^{-1} K1' x
        wd = chol_solve(self.L11, self.dK1[j].T @ x)       # K11^{-1} dK1' x
        inner = chol_solve(self.L11, self.dK11[j] @ w)
        return self.dK1[j] @ w + self.K1 @ wd - self.K1 @ inner

    def dvp(self, z):
        """Stacked M^{-1} dM_j z: (3, n) for z (n,), (nv, 3, n) for rows (nv, n)."""
        flip = (lambda a: a) if z.ndim == 1 else (lambda a: a.T)  # noqa: E731
        outs = [self.solve(flip(self._dM_apply(j, flip(z)))) for j in range(2)]
        outs.append(self.f2 * self.solve(z))
        return torch.stack(outs, dim=-2)

    def trace(self):
        """(3,) tr(M^{-1} dM_j) via Woodbury."""
        k = self.k
        UfU = self.Uf.T @ self.Uf + self.eta * torch.eye(k, dtype=self.Uf.dtype, device=self.Uf.device)
        Lw = torch.linalg.cholesky(UfU)
        W = chol_solve(Lw, self.Uf.T).T                    # Uf (eta I + Uf'Uf)^{-1}
        traces = []
        for j in range(2):
            A1 = tril_solve(self.L11, self.dK1[j].T).T     # dK1 L^{-T}
            GdKG = tril_solve(self.L11, tril_solve(self.L11, self.dK11[j]).T).T
            t_raw = 2.0 * torch.sum(A1 * self.Uf) - torch.sum((self.Uf @ GdKG) * self.Uf)
            corr = torch.sum(self._dM_apply(j, self.Uf) * W)
            traces.append((t_raw - corr) / self.eta)
        traces.append((self.n * self.f2 - self.f2 * torch.sum(self.Uf * W)) / self.eta)
        return torch.stack(traces)


def nystrom_setup(kind: str, params: KernelParams, X, perm, k: int, *,
                  require_grad: bool = False, windows=None) -> NystromPrecond:
    """Build the Nystrom preconditioner from the kernel and landmark indices
    (the first k entries of perm)."""
    perm = torch.as_tensor(perm, device=X.device)[:k]
    Xk = X[perm]
    noise_free = KernelParams(f=params.f, l=params.l, mu=torch.zeros_like(params.mu))
    if windows is None:
        build = lambda A, B: kernel_matrix(kind, noise_free, A, B)  # noqa: E731
        build_g = lambda A, B: kernel_matrix_with_grad(kind, noise_free, A, B)  # noqa: E731
    else:
        build = lambda A, B: additive_kernel_matrix(kind, noise_free, A, windows, B)  # noqa: E731
        build_g = lambda A, B: additive_kernel_matrix_with_grad(  # noqa: E731
            kind, noise_free, A, windows, B)

    dK1 = dK11 = None
    if require_grad:
        K1, dK1_full = build_g(X, Xk)
        K11, dK11_full = build_g(Xk, Xk)
        dK1, dK11 = dK1_full[:2], dK11_full[:2]
    else:
        K1 = build(X, Xk)
        K11 = build(Xk, Xk)

    L11, _ = stable_chol(K11)
    Uf = tril_solve(L11, K1.T).T
    U, sigma, _ = torch.linalg.svd(Uf, full_matrices=False)
    sigma2 = sigma * sigma
    f2 = params.f * params.f
    eta = params.mu * f2
    return NystromPrecond(
        perm=perm, U=U, s=1.0 / (sigma2 + eta), sigma2=sigma2, eta=eta, f2=f2,
        Uf=Uf if require_grad else None,
        L11=L11 if require_grad else None,
        K1=K1 if require_grad else None,
        dK1=dK1, dK11=dK11,
    )
