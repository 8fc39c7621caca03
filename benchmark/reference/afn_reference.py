"""Plain reference of the AFN preconditioner and its derivatives.

What the training check's loss holds the port's AFN against.  Plain torch,
on any device, in the dtype of the points it is given (float64 for the
reference); it imports nothing of the port and takes nothing the port
made but the plan's structure: which points are landmarks (`perm`, `k`)
and which earlier points each Schur point's row holds (the pattern).  It
checks that structure (`plan_faults`) and works out every number again.

The mathematics (the NFFT4GP reference code, Hitenze/Preconditioned_Additive_
Gaussian_Processes_with_Fourier_Acceleration, MATLAB/+nfftgp afn_setup.m:
30-109, afn_logdet.m, afn_trace.m, afn_dvp.m; SRC/preconds/fsai.c for the
rows of G).  In the plan's order, k landmarks first and n2 = n - k Schur
points after them:

      | K11   K12 |                 U = | L11'   W      |     W = L11^-1 K12
  K = | K12'  K22 |,   M = U'U,         | 0      G^-T   |

- L11 = chol(K11 + nu I) (K11 with its noise; nu = sqrt(k) ulp(||K11||_F) in
  the configuration's working precision, float32, as the Nystrom reference);
- G lower triangular, the FSAI factor of the Schur kernel S = K22 - W'W on
  the pattern: for row i with pattern J (its earlier neighbours, then i)
  u = S(J, J)^-1 e_last, g = u / sqrt(u_last); a row whose block has no
  Cholesky factor, or whose u_last is not positive or g not finite, is
  repaired to g = e_last / sqrt(max(|S_ii|, tiny)) (the port's rule);
- with dK_j (j = f, l, mu) the kernel's derivatives: dL11 = L phi(L^-1
  dK11 L^-T), phi(A) = tril(A, -1) + diag(A) / 2; dW = L^-1 dK12 - L^-1
  dL11 W; dS = dK22 - dW'W - W'dW; dg = a - (a_last / (2 g_last)) g with
  a = -S(J, J)^-1 dS(J, J) g (a repaired row: -dS_ii / (2 S_ii^1.5) e);
- solve: M^-1 x: z = x_l - K12' K11^-1 x_u; y_l = G'G z; y_u = K11^-1
  (x_u - K12 y_l) (K11 here the shifted L11 L11');
- logdet M = 2 (sum log diag L11 - sum log diag G);
- trace_j = tr(M^-1 dM_j) = 2 sum diag(dU_j) / diag(U), exact: U is
  triangular (diag(G^-T) = 1 / diag G);
- dvp: M^-1 dM_j z, dM_j = dU_j'U + U'dU_j, dU_j = [[dL11', dW], [0,
  -G^-T dG' G^-T]], the solves with G and G' as blocked substitution.
"""

import math
from typing import Callable, List, NamedTuple

import torch

ROW_BLOCK = 8192      # Schur rows whose blocks and landmark columns are formed at once
SWEEP_BLOCK = 1024    # points a dense diagonal block of the substitutions holds


class Plan(NamedTuple):
    """The plan's structure: the order, the landmark count and the pattern."""

    perm: torch.Tensor       # (n,) landmarks first, then the Schur points
    k: int
    use_ran: bool            # the port's plain-Nystrom branch: not AFN
    idx: torch.Tensor        # (n2, lfil) Schur-local columns of each row, the row itself last
    mask: torch.Tensor       # (n2, lfil) which slots hold a column


def plan_faults(plan: Plan, n: int, k: int) -> List[str]:
    """What keeps `plan` from being an AFN plan of n points with k landmarks
    (empty when it is one)."""
    bad = []
    if plan.use_ran:
        bad.append("use_ran: the plain-Nystrom branch")
    if plan.k != k:
        bad.append(f"k = {plan.k}, not {k}")
    perm = plan.perm.cpu()
    if perm.shape != (n,) or not torch.equal(torch.sort(perm).values, torch.arange(n)):
        bad.append(f"perm is not a permutation of {n} points")
    n2 = n - plan.k
    idx, mask = plan.idx.cpu(), plan.mask.cpu()
    if idx.ndim != 2 or idx.shape[0] != n2 or mask.shape != idx.shape:
        bad.append(f"the pattern has {tuple(idx.shape)} slots, not ({n2}, lfil)")
        return bad
    rows = torch.arange(n2)[:, None]
    if not (bool(mask[:, -1].all()) and torch.equal(idx[:, -1], rows[:, 0])):
        bad.append("a pattern row does not end in its own point")
    if bool((mask[:, :-1] & ((idx[:, :-1] >= rows) | (idx[:, :-1] < 0))).any()):
        bad.append("a pattern row holds a point that is not before it")
    return bad


def phi(A):
    """tril(A, -1) + diag(A) / 2 of each matrix of A."""
    return torch.tril(A, -1) + 0.5 * torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))


def ulp(v: float, dtype) -> float:
    a = torch.tensor(v, dtype=dtype)
    return float(torch.nextafter(a, torch.tensor(math.inf, dtype=dtype)) - a)


def fsai_rows(S, dS, mask):
    """(g (rows, l), dg (3, rows, l), repaired rows) of FSAI rows from their
    Schur blocks S (rows, l, l) and derivatives dS (rows, 3, l, l); slots
    outside `mask` are left out of each block."""
    rows, lfil, _ = S.shape
    eye = torch.eye(lfil, dtype=S.dtype, device=S.device)
    both = mask[:, :, None] & mask[:, None, :]
    B = torch.where(both, S, eye)
    dB = torch.where(both[:, None], dS, 0.0)
    L, info = torch.linalg.cholesky_ex(B)
    factored = info == 0
    L = torch.where(factored[:, None, None], L, eye)
    e = torch.zeros(lfil, dtype=S.dtype, device=S.device)
    e[-1] = 1.0
    u = torch.cholesky_solve(e.expand(rows, lfil)[:, :, None], L)[:, :, 0]
    g = torch.where(mask, u / torch.sqrt(u[:, -1:]), 0.0)
    ok = factored & (u[:, -1] > 0) & torch.isfinite(g).all(dim=1)
    a = torch.cholesky_solve(-(dB @ g[:, None, :, None]), L[:, None])[..., 0]          # (rows, 3, l)
    dg = torch.where(mask[:, None], a - (0.5 * a[:, :, -1:] / g[:, None, -1:]) * g[:, None], 0.0)
    s_ii = torch.clamp(torch.abs(B[:, -1, -1]), min=torch.finfo(S.dtype).tiny)
    g_rep = e * torch.rsqrt(s_ii)[:, None]
    dg_rep = (-0.5 * dB[:, :, -1, -1] / s_ii[:, None] ** 1.5)[:, :, None] * e
    g = torch.where(ok[:, None], g, g_rep)
    dg = torch.where(ok[:, None, None], dg, dg_rep)
    return g, dg.movedim(1, 0), int((~ok).sum())


class Sparse:
    """A lower-triangular matrix of n2 rows held by its pattern: row i has
    values[i, s] at column idx[i, s] where mask[i, s].  Products and
    substitutions act on rows of X (m, n2), each a vector over the points."""

    def __init__(self, idx, mask):
        self.idx, self.mask = idx, mask
        self.n = idx.shape[0]

    def mul(self, vals, X):
        """(A X')' for A with `vals` on the pattern."""
        return torch.sum(X[:, self.idx] * torch.where(self.mask, vals, 0.0), dim=2)

    def mul_t(self, vals, X):
        """(A' X')'."""
        out = torch.zeros_like(X)
        w = X[:, :, None] * torch.where(self.mask, vals, 0.0)
        out.index_add_(1, self.idx.reshape(-1), w.reshape(X.shape[0], -1))
        return out

    def _diag_block(self, vals, s0, s1):
        """The dense (s1 - s0) block of A on its diagonal, and the mask of the
        slots of rows s0:s1 that fall before it."""
        idx, mask, v = self.idx[s0:s1], self.mask[s0:s1], vals[s0:s1]
        inside = mask & (idx >= s0)
        T = torch.zeros((s1 - s0, s1 - s0), dtype=vals.dtype, device=vals.device)
        r = torch.arange(s1 - s0, device=vals.device)[:, None].expand_as(idx)
        T.index_put_((r[inside], idx[inside] - s0), v[inside], accumulate=True)
        return T, mask & (idx < s0)

    def solve(self, vals, B, block: int = SWEEP_BLOCK):
        """(A^-1 B')': forward substitution, a dense block at a time."""
        Y = torch.zeros_like(B)
        for s0 in range(0, self.n, block):
            s1 = min(s0 + block, self.n)
            T, before = self._diag_block(vals, s0, s1)
            known = torch.sum(Y[:, self.idx[s0:s1]] * torch.where(before, vals[s0:s1], 0.0), dim=2)
            Y[:, s0:s1] = torch.linalg.solve_triangular(T, (B[:, s0:s1] - known).T, upper=False).T
        return Y

    def solve_t(self, vals, B, block: int = SWEEP_BLOCK):
        """(A^-T B')': back substitution, a dense block at a time."""
        Y = torch.zeros_like(B)
        acc = torch.zeros_like(B)
        starts = list(range(0, self.n, block))
        for s0 in reversed(starts):
            s1 = min(s0 + block, self.n)
            T, before = self._diag_block(vals, s0, s1)
            Y[:, s0:s1] = torch.linalg.solve_triangular(T.T, (B[:, s0:s1] - acc[:, s0:s1]).T, upper=True).T
            w = torch.where(before, vals[s0:s1], 0.0)
            acc.index_add_(1, self.idx[s0:s1].reshape(-1),
                           (Y[:, s0:s1, None] * w).reshape(B.shape[0], -1))
        return Y


class Afn:
    """AFN on a plan, at one set of hyperparameters, with its derivatives.

    kernel(A, B=None) -> (K, dK): the kernel between point sets (..., a, d)
    and (..., b, d), batched over leading dimensions, with the noise on the
    diagonal when B is None; dK (3, ..., a, b) its derivatives in (f, l, mu).
    shift_dtype: the working precision whose ulp sets the Cholesky shift."""

    def __init__(self, kernel: Callable, X, plan: Plan, shift_dtype=torch.float32, rows: int = ROW_BLOCK):
        k = plan.k
        perm = plan.perm.to(X.device)
        self.perm, self.k, self.n = perm, k, X.shape[0]
        Xp = X[perm]
        X1, X2 = Xp[:k], Xp[k:]
        K11, dK11 = kernel(X1)
        K12, dK12 = kernel(X1, X2)
        nu = math.sqrt(k) * ulp(float(torch.linalg.norm(K11)), shift_dtype)
        eye = torch.eye(k, dtype=X.dtype, device=X.device)
        self.L = torch.linalg.cholesky(K11 + nu * eye)
        L = self.L
        LidK = torch.linalg.solve_triangular(L, dK11, upper=False)
        self.dL = L @ phi(torch.linalg.solve_triangular(L, LidK.mT, upper=False).mT)
        self.K12 = K12
        self.W = torch.linalg.solve_triangular(L, K12, upper=False)
        self.dW = (torch.linalg.solve_triangular(L, dK12, upper=False)
                   - torch.linalg.solve_triangular(L, self.dL @ self.W, upper=False))
        del LidK, dK12
        idx, mask = plan.idx.to(X.device), plan.mask.to(X.device)
        self.G = Sparse(idx, mask)
        vals, dvals, self.repaired = [], [], 0
        for r0 in range(0, idx.shape[0], rows):
            J = idx[r0:r0 + rows]
            S, dS = kernel(X2[J])
            WJ = self.W[:, J].permute(1, 0, 2)                                  # (rows, k, l)
            S = S - WJ.mT @ WJ
            cross = torch.stack([WJ.mT @ self.dW[j][:, J].permute(1, 0, 2) for j in range(3)], dim=1)
            dS = dS.movedim(0, 1) - cross - cross.mT
            g, dg, bad = fsai_rows(S, dS, mask[r0:r0 + rows])
            vals.append(g)
            dvals.append(dg)
            self.repaired += bad
        self.g = torch.cat(vals)
        self.dg = torch.cat(dvals, dim=1)

    # --- in the plan's order, on rows (m, n) ---------------------------------------------

    def _k11_solve(self, B):
        """(K11^-1 B')' on rows B (m, k)."""
        return torch.cholesky_solve(B.T, self.L).T

    def _solve_p(self, Xp):
        k = self.k
        xu, xl = Xp[:, :k], Xp[:, k:]
        z = xl - self._k11_solve(xu) @ self.K12
        yl = self.G.mul_t(self.g, self.G.mul(self.g, z))
        yu = self._k11_solve(xu - yl @ self.K12.T)
        return torch.cat([yu, yl], dim=1)

    def _u(self, Zp):
        """U z of rows."""
        zu, zl = Zp[:, :self.k], Zp[:, self.k:]
        return torch.cat([zu @ self.L + zl @ self.W.T, self.G.solve_t(self.g, zl)], dim=1)

    def _ut(self, Wp):
        """U' w of rows."""
        wu, wl = Wp[:, :self.k], Wp[:, self.k:]
        return torch.cat([wu @ self.L.T, wu @ self.W + self.G.solve(self.g, wl)], dim=1)

    def _du(self, j, Zp):
        """dU_j z of rows."""
        zu, zl = Zp[:, :self.k], Zp[:, self.k:]
        G, g = self.G, self.g
        low = -G.solve_t(g, G.mul_t(self.dg[j], G.solve_t(g, zl)))
        return torch.cat([zu @ self.dL[j] + zl @ self.dW[j].T, low], dim=1)

    def _dut(self, j, Wp):
        """dU_j' w of rows."""
        wu, wl = Wp[:, :self.k], Wp[:, self.k:]
        G, g = self.G, self.g
        low = wu @ self.dW[j] - G.solve(g, G.mul(self.dg[j], G.solve(g, wl)))
        return torch.cat([wu @ self.dL[j].T, low], dim=1)

    # --- the interface of gp_reference's preconditioners ------------------------------------

    def _to_plan(self, R):
        return R[:, self.perm]

    def _from_plan(self, Rp):
        out = torch.empty_like(Rp)
        out[:, self.perm] = Rp
        return out

    def solve(self, R):
        """M^-1 on the rows of R (nv, n)."""
        return self._from_plan(self._solve_p(self._to_plan(R)))

    def logdet(self):
        return 2.0 * (torch.sum(torch.log(torch.diagonal(self.L))) - torch.sum(torch.log(self.g[:, -1])))

    def trace(self):
        """tr(M^-1 dM_j) for (f, l, mu)."""
        dl = torch.diagonal(self.dL, dim1=1, dim2=2) / torch.diagonal(self.L)[None]
        return 2.0 * (torch.sum(dl, dim=1) - torch.sum(self.dg[:, :, -1] / self.g[None, :, -1], dim=1))

    def dvp(self, Z):
        """(nv, 3, n) rows M^-1 dM_j z."""
        Zp = self._to_plan(Z)
        Uz = self._u(Zp)
        outs = [self._from_plan(self._solve_p(self._dut(j, Uz) + self._ut(self._du(j, Zp)))) for j in range(3)]
        return torch.stack(outs, dim=1)
