"""FSAI: factored sparse approximate inverse preconditioner (port of
preconds/fsai.py).

Rebuild of SRC/preconds/fsai.c: G ~= L^{-1} lower-triangular on a KNN
pattern, M^{-1} = G'G ~= K^{-1}.  Per row i with pattern J (the lfil-1
nearest preceding points, then i):
  u = K(J,J)^{-1} e_last, g = u / sqrt(u_last)            (fsai.c:374-397)
  dg_j = -K^{-1}(dK_j g) - 0.5 dg_j[last] dd g            (fsai.c:470-663)
one batched Cholesky over all rows of size lfil, padded slots spliced with
identity.

Apply, trace, dvp (fsai.c:106-300):
  solve:   x = G'(G r)
  logdet:  -2 sum log diag(G)
  trace_j: 2 sum_i dG_ii / G_ii
  dvp:     px = G' G^{-T} dG' G^{-T} z + G' dG (G^{-1} G^{-T} z), whose
           expectation over probes z is the trace (fsai.c:158-216)
  dvp_gram / trace_gram: the triangular-solve-free pair
           px_j = G'(dG_j z) + dG_j'(G z), trace_j = 2 <G, dG_j>_F.

Every method takes one vector (n,) or a batch of rows (nv, n) (the JAX
package dispatches the batch through custom_vmap); dvp returns (3, n) or
(nv, 3, n).  G' products run through the transpose pattern (gathers only),
and the triangular solves on the dense diagonal blocks made once per
factorization (ops/matops.py).
"""

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.kernels import (
    KernelParams,
    additive_kernel_matrix,
    additive_kernel_matrix_with_grad,
    kernel_matrix,
    kernel_matrix_with_grad,
)
from ..ops.knn import knn_pattern
from ..ops.matops import (
    EllTri,
    ell_apply,
    ell_rmatvec_t,
    ell_transpose_pattern,
    ell_tri_blocks,
    ell_tril_solve,
    ell_triu_solve,
)

# rows a chunk of the batched row factorization handles at once: bounds the
# (rows, lfil, lfil) blocks and, in AFN, the (rows, k, lfil) gathers of the
# landmark columns (preconds/afn.py)
ROW_CHUNK = 32768


def transpose_pattern(idx, mask):
    """The transpose pattern of (idx, mask) as int64/bool tensors on idx's
    device."""
    return tuple(torch.from_numpy(a).to(device=idx.device, dtype=torch.bool if a.dtype == bool
                                        else torch.int64)
                 for a in ell_transpose_pattern(idx, mask))


@dataclass
class FsaiPrecond:
    idx: torch.Tensor                 # (n, lfil) pattern, diagonal at slot lfil-1
    mask: torch.Tensor                # (n, lfil) validity
    val: torch.Tensor                 # (n, lfil) rows of G
    dval: Optional[torch.Tensor]      # (3, n, lfil) rows of dG, or None
    # rows whose small Cholesky broke down (non-SPD block) and were repaired
    # to a diagonal row (0-d int tensor; the traceable analog of the
    # reference's breakdown check, afn_setup.m:93-98)
    breakdown: torch.Tensor
    pattern_t: tuple                  # (t_rows, t_slot, t_mask) transpose pattern
    # dense diagonal blocks of the triangular solves: made here with dG, once
    # per factorization, since dvp needs them; without dG at the first solve
    _tri: Optional[EllTri] = None

    def __post_init__(self):
        if self.dval is not None and self._tri is None:
            self._tri = ell_tri_blocks(self.idx, self.val, self.pattern_t)

    @property
    def tri(self) -> EllTri:
        if self._tri is None:
            self._tri = ell_tri_blocks(self.idx, self.val, self.pattern_t)
        return self._tri

    def apply_G(self, r):
        return ell_apply(self.idx, self.val, r)

    def _rmat(self, vals, x):
        """G(vals)' x for any values on G's pattern."""
        return ell_rmatvec_t(*self.pattern_t, vals, x)

    def apply_Gt(self, r):
        return self._rmat(self.val, r)

    def solve(self, r):
        """M^{-1} r = G'(G r)."""
        return self.apply_Gt(self.apply_G(r))

    def logdet(self):
        return -2.0 * torch.sum(torch.log(self.val[:, -1]))

    def trace(self):
        """(3,) 2 sum_i dG_ii / G_ii (fsai.c:222-276); consistent with dvp."""
        return 2.0 * torch.sum(self.dval[:, :, -1] / self.val[None, :, -1], dim=1)

    def solve_G(self, b):
        """G^{-1} b (ref Nfft4GPPrecondFsaiInvL, fsai.c:675-702)."""
        return ell_tril_solve(self.tri, b)

    def solve_Gt(self, b):
        """G^{-T} b (ref Nfft4GPPrecondFsaiInvLT, fsai.c:703-729)."""
        return ell_triu_solve(self.tri, b)

    def _stack3(self, fn, x):
        """fn(dval_j, x) for j = 0, 1, 2 on rows x (nv, n) -> (nv, 3, n)."""
        return torch.stack([fn(dv, x) for dv in self.dval], dim=1)

    def dvp(self, z):
        """px_j with E[z' px_j] = trace_j (ref fsai.c:125-216): (3, n) for z
        (n,), (nv, 3, n) for rows (nv, n).  The three j share each solve."""
        Z = z[None] if z.ndim == 1 else z
        nv, n = Z.shape
        u = self.solve_Gt(Z)                                   # G^{-T} z
        m = self.solve_G(u)                                    # G^{-1} G^{-T} z
        s = self.solve_Gt(self._stack3(self._rmat, u).reshape(nv * 3, n)).reshape(nv, 3, n)
        t = s + self._stack3(lambda dv, x: ell_apply(self.idx, dv, x), m)
        out = self.apply_Gt(t.reshape(nv * 3, n)).reshape(nv, 3, n)
        return out[0] if z.ndim == 1 else out

    def trace_gram(self):
        """2 <G, dG_j>_F, consistent with dvp_gram."""
        return 2.0 * torch.einsum("nl,knl->k", self.val, self.dval)

    def dvp_gram(self, z):
        """G'(dG_j z) + dG_j'(G z), shaped as dvp."""
        Z = z[None] if z.ndim == 1 else z
        gz = self.apply_G(Z)
        out = torch.stack([self.apply_Gt(ell_apply(self.idx, dv, Z)) + self._rmat(dv, gz)
                           for dv in self.dval], dim=1)
        return out[0] if z.ndim == 1 else out


def fsai_rows_from_blocks(blocks, dblocks, mask):
    """Batched FSAI row solves with breakdown repair.

    blocks (n, lfil, lfil) kernel sub-blocks (entries outside the mask
    arbitrary); dblocks (n, 3, lfil, lfil) or None; mask (n, lfil).  Returns
    (val (n, lfil), dval (3, n, lfil) or None, breakdown): the count of rows
    whose Cholesky failed, or whose solve is not finite with u_last > 0,
    repaired to g = e / sqrt(max(|B_ll|, tiny)) with that row's own dg (the
    JAX package's rule).  A failed row is factored as the identity, so no
    NaN is formed."""
    n, lfil, _ = blocks.shape
    dt, dev = blocks.dtype, blocks.device
    eye = torch.eye(lfil, dtype=dt, device=dev)
    m2 = mask[:, :, None] & mask[:, None, :]
    B = torch.where(m2, blocks, eye)
    Lb, info = torch.linalg.cholesky_ex(B)
    chol_ok = info == 0
    Lb = torch.where(chol_ok[:, None, None], Lb, eye)
    e = torch.zeros(lfil, dtype=dt, device=dev)
    e[-1] = 1.0
    u = torch.cholesky_solve(e.expand(n, lfil)[:, :, None], Lb)[:, :, 0]
    ulast = u[:, -1]
    dd = 1.0 / torch.sqrt(ulast)
    g = torch.where(mask, u * dd[:, None], 0.0)
    ok = chol_ok & torch.all(torch.isfinite(g), dim=1) & (ulast > 0)
    dd_r = 1.0 / torch.sqrt(torch.clamp(torch.abs(B[:, -1, -1]), min=torch.finfo(dt).tiny))
    g = torch.where(ok[:, None], g, e * dd_r[:, None])
    dd = torch.where(ok, dd, dd_r)
    breakdown = torch.sum(~ok)
    if dblocks is None:
        return g, None, breakdown
    dB = torch.where(m2[:, None], dblocks, 0.0)                       # (n, 3, l, l)
    rhs = -(dB @ g[:, None, :, None])                                  # (n, 3, l, 1)
    da = torch.cholesky_solve(rhs, Lb[:, None])[..., 0]                # (n, 3, l)
    da = da - 0.5 * da[:, :, -1:] * dd[:, None, None] * g[:, None, :]
    da = torch.where(mask[:, None, :], da, 0.0)
    # repaired row: g = B_ll^{-1/2} e -> dg = -1/2 B_ll^{-3/2} dB_ll e
    da_r = (-0.5 * dB[:, :, -1, -1] * (dd_r ** 3)[:, None])[:, :, None] * e
    da = torch.where(ok[:, None, None], da, da_r)
    return g, da.movedim(1, 0), breakdown


def kernel_blocks(kind, params, windows, require_grad):
    """(B, dB) evaluator of the kernel on batched point sets (rows, l, d):
    B (rows, l, l), dB (rows, 3, l, l) or None."""
    def block_fn(XJ):
        if windows is None:
            if require_grad:
                B, dB = kernel_matrix_with_grad(kind, params, XJ)
                return B, dB.movedim(0, 1)
            return kernel_matrix(kind, params, XJ), None
        if require_grad:
            B, dB = additive_kernel_matrix_with_grad(kind, params, XJ, windows)
            return B, dB.movedim(0, 1)
        return additive_kernel_matrix(kind, params, XJ, windows), None

    return block_fn


def fsai_rows(block_fn, idx, mask, chunk: int = ROW_CHUNK):
    """Factor the rows of (idx, mask) in chunks of `chunk` rows:
    block_fn(J) -> (B, dB) for a chunk's patterns J (rows, lfil)."""
    vals, dvals, bad = [], [], 0
    for r0 in range(0, idx.shape[0], chunk):
        rows = slice(r0, r0 + chunk)
        B, dB = block_fn(idx[rows])
        v, dv, b = fsai_rows_from_blocks(B, dB, mask[rows])
        vals.append(v)
        dvals.append(dv)
        bad = bad + b
    dval = torch.cat(dvals, dim=1) if dvals[0] is not None else None
    return torch.cat(vals), dval, torch.as_tensor(bad, device=idx.device)


def fsai_setup(kind: str, params: KernelParams, X, lfil: int, *, require_grad: bool = False,
               windows=None, pattern=None, pattern_t=None,
               block_fn: Optional[Callable] = None) -> FsaiPrecond:
    """FSAI on the lfil-nearest-preceding-neighbour pattern (knn_pattern of
    X unless `pattern` = (idx, mask) is given; `pattern_t` its transpose
    pattern, built on the host when None).  block_fn(J) -> (B, dB): a
    custom block evaluator on the patterns J (rows, lfil) of a chunk of
    rows; default the (additive) kernel on the points X[J]."""
    idx, mask = pattern if pattern is not None else knn_pattern(X, lfil)
    if pattern_t is None:
        pattern_t = transpose_pattern(idx, mask)
    if block_fn is None:
        blocks = kernel_blocks(kind, params, windows, require_grad)
        block_fn = lambda J: blocks(X[J])  # noqa: E731
    val, dval, breakdown = fsai_rows(block_fn, idx, mask)
    return FsaiPrecond(idx=idx, mask=mask, val=val, dval=dval, breakdown=breakdown, pattern_t=pattern_t)

