"""Dense and padded-ELL matrix helpers (port of ops/matops.py): the dense
solves, the ELL products of the near-field and FSAI, the gather-only
transpose product and the blocked ELL triangular solves."""

from typing import NamedTuple

import numpy as np
import torch


def stable_chol(K, extra_shift: float = 0.0):
    """Cholesky with the reference's stabilization shift and escalation.

    nu = sqrt(n) * ulp(||K||_F) is added to the diagonal (ref chol.c:448-464);
    while the factorization fails the shift escalates x1e2, x1e4, x1e6 and the
    first good factor wins.  Returns (L, nu).
    """
    n = K.shape[0]
    fro = torch.linalg.norm(K)
    ulp = torch.nextafter(fro, torch.full_like(fro, float("inf"))) - fro
    base = float(n) ** 0.5 * ulp + extra_shift
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(K + base * eye)
    nu, tries = base, 1.0
    while int(info) != 0 and tries < 4:
        nu = base * 10.0 ** (2.0 * tries)
        L, info = torch.linalg.cholesky_ex(K + nu * eye)
        tries += 1.0
    if int(info) != 0:
        L = torch.full_like(K, float("nan"))
    return L, nu


def _solve_tri(A, b, upper: bool):
    vec = b.ndim == 1
    x = torch.linalg.solve_triangular(A, b[:, None] if vec else b, upper=upper)
    return x[:, 0] if vec else x


def tril_solve(L, b):
    """Solve L x = b for lower-triangular L; b is (n,) or (n, m)."""
    return _solve_tri(L, b, upper=False)


def triu_solve(L, b):
    """Solve L^T x = b for lower-triangular L."""
    return _solve_tri(L.T, b, upper=True)


def chol_solve(L, b):
    """Solve (L L^T) x = b by two triangular solves (ref chol.c:111-137)."""
    return triu_solve(L, tril_solve(L, b))


# --- padded-ELL sparse matrices ------------------------------------------------
# Row i of G is stored as idx[i] (n, lfil) column indices and val[i] values;
# padded slots carry value 0 (a lower-triangular factor pads with its own
# diagonal index, the diagonal in the last slot, fsai.c:385-397).  Plain
# torch gathers and index_add: the JAX package computes these outside any
# Pallas kernel too (its TPU-tuned row gather, _gather_vec, is a plain
# x[idx] here).

def ell_matvec(idx, val, x):
    """y = G x: gather + row-wise dot."""
    return torch.sum(val * x[idx], dim=1)


def ell_matvec_batch(idx, val, Xb):
    """y[r] = G x_r for a batch Xb (nv, n): one row gather of the (n, nv)
    transposed batch serves every right-hand side."""
    G = Xb.T[idx.reshape(-1)].reshape(*idx.shape, Xb.shape[0])
    return torch.einsum("is,isv->vi", val, G)


def ell_rmatvec(idx, val, x, n=None):
    """y = G' x: scatter-add."""
    n = n if n is not None else x.shape[0]
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx.reshape(-1), (val * x[:, None]).reshape(-1))


def ell_rmatvec_batch(idx, val, Xb, n=None):
    """y[r] = G' x_r for a batch Xb (nv, n): one row-wise scatter-add of the
    (n * lfil, nv) contributions."""
    nv = Xb.shape[0]
    n = n if n is not None else Xb.shape[1]
    contrib = val[:, :, None] * Xb.T[:, None, :]              # (rows, lfil, nv)
    out = torch.zeros((n, nv), dtype=Xb.dtype, device=Xb.device)
    return out.index_add_(0, idx.reshape(-1), contrib.reshape(-1, nv)).T


def ell_apply(idx, val, x):
    """G x for one vector (n,) or a batch of rows (nv, n)."""
    return ell_matvec(idx, val, x) if x.ndim == 1 else ell_matvec_batch(idx, val, x)


def ell_transpose_pattern(idx, mask, lfil_t=None):
    """Host-side transpose pattern of a padded-ELL matrix.

    Returns numpy (t_rows, t_slot, t_mask), each (n, lfil_t): row c of G'
    collects val[t_rows[c, s], t_slot[c, s]] where t_mask, so G' x is a
    gather-only contraction (`ell_rmatvec_t`); index_add_ on CUDA sums in no
    fixed order, the gather does.  lfil_t defaults to the largest column
    in-degree.  The pattern does not depend on the values: build it once
    per pattern."""
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    n = idx.shape[0]
    rows, slots = np.nonzero(mask)
    cols = idx[rows, slots]
    order = np.argsort(cols, kind="stable")
    cols_s, rows_s, slots_s = cols[order], rows[order], slots[order]
    starts = np.searchsorted(cols_s, np.arange(n))
    counts = np.searchsorted(cols_s, np.arange(n) + 1) - starts
    need = int(counts.max()) if counts.size else 1
    lfil_t = need if lfil_t is None else max(int(lfil_t), need)
    t_rows = np.zeros((n, lfil_t), np.int32)
    t_slot = np.zeros((n, lfil_t), np.int32)
    t_mask = np.zeros((n, lfil_t), bool)
    rank = np.arange(cols_s.size) - starts[cols_s]
    t_rows[cols_s, rank] = rows_s
    t_slot[cols_s, rank] = slots_s
    t_mask[cols_s, rank] = True
    return t_rows, t_slot, t_mask


def _transposed_values(t_rows, t_slot, t_mask, val):
    """(n, lfil_t) values of G' on the transpose pattern (0 on its pads)."""
    flat = (t_rows * val.shape[1] + t_slot).reshape(-1)
    v = val.reshape(-1)[flat].reshape(t_rows.shape)
    return torch.where(t_mask, v, torch.zeros((), dtype=val.dtype, device=val.device))


def ell_rmatvec_t(t_rows, t_slot, t_mask, val, x):
    """G' x through the transpose pattern (`ell_transpose_pattern`), gathers
    only; val is any value array on G's pattern (G's rows, or dG's); x is
    (n,) or rows (nv, n)."""
    return ell_apply(t_rows, _transposed_values(t_rows, t_slot, t_mask, val), x)


class EllTri(NamedTuple):
    """A lower-triangular padded-ELL G prepared for blocked solves: the
    inverses of its dense diagonal blocks and the off-block entries, in
    both orientations."""

    n: int
    block: int
    Dinv: torch.Tensor     # (nb, block, block) inverse diagonal blocks (identity on pad rows)
    idx: torch.Tensor      # (npad, lfil) columns, pad rows point at themselves
    prev: torch.Tensor     # (npad, lfil) values of columns left of the row's block, else 0
    t_rows: torch.Tensor   # (npad, lfil_t) rows of G' (transpose pattern)
    nxt: torch.Tensor      # (npad, lfil_t) values of G' rows below the column's block, else 0


def ell_tri_blocks(idx, val, pattern_t, *, block: int = 256) -> EllTri:
    """Densify G's (block, block) diagonal blocks and invert them, once per
    factorization (ref fsai.c:675-729 substitutes row by row; JAX
    _ell_block_dense builds each block and solves with it inside every
    solve): a step of a sweep is then one gather-dot and one product.
    pattern_t: the transpose pattern of (idx, mask) as tensors
    (`ell_transpose_pattern`)."""
    n, lfil = idx.shape
    dev = idx.device
    t_rows, t_slot, t_mask = (p.to(torch.int64) if p.dtype != torch.bool else p for p in pattern_t)
    idx = idx.to(torch.int64)
    nb = -(-n // block)
    npad = nb * block
    rows = torch.arange(npad, device=dev)
    lo = (rows // block) * block

    def pad(a, fill):
        return torch.cat([a, fill.expand(npad - n, a.shape[1])]) if npad > n else a

    idx_p = pad(idx, rows[n:, None])
    val_p = pad(val, val.new_zeros(()))
    local = idx_p - lo[:, None]
    inblk = (local >= 0) & (local < block)
    r = (rows - lo)[:, None].expand_as(idx_p)
    D = torch.zeros((nb, block, block), dtype=val.dtype, device=dev)
    D.index_put_((rows[:, None].expand_as(idx_p)[inblk] // block, r[inblk], local[inblk]),
                 val_p[inblk], accumulate=True)
    pad_rows = rows[n:]
    D[pad_rows // block, pad_rows % block, pad_rows % block] = 1.0
    eye = torch.eye(block, dtype=val.dtype, device=dev).expand(nb, block, block)
    Dinv = torch.linalg.solve_triangular(D, eye, upper=False)
    zero = val.new_zeros(())
    prev = torch.where(idx_p < lo[:, None], val_p, zero)
    tv = _transposed_values(t_rows, t_slot, t_mask, val)
    t_rows_p = pad(t_rows, rows[n:, None])
    nxt = torch.where(t_rows_p >= (lo + block)[:, None], pad(tv, zero), zero)
    return EllTri(n=n, block=block, Dinv=Dinv, idx=idx_p, prev=prev, t_rows=t_rows_p, nxt=nxt)


def _tri_sweep(tri: EllTri, b, lower: bool):
    Bc = b[:, None] if b.ndim == 1 else b.T
    npad, blk = tri.idx.shape[0], tri.block
    rhs_all = Bc.new_zeros((npad, Bc.shape[1]))
    rhs_all[:tri.n] = Bc
    y = torch.zeros_like(rhs_all)
    cols, vals = (tri.idx, tri.prev) if lower else (tri.t_rows, tri.nxt)
    nb = tri.Dinv.shape[0]
    for k in (range(nb) if lower else reversed(range(nb))):
        r = slice(k * blk, (k + 1) * blk)
        rhs = torch.baddbmm(rhs_all[r, None, :], vals[r, None, :], y[cols[r]], alpha=-1.0)[:, 0]
        torch.mm(tri.Dinv[k] if lower else tri.Dinv[k].T, rhs, out=y[r])
    y = y[:tri.n]
    return y[:, 0] if b.ndim == 1 else y.T


def ell_tril_solve(tri: EllTri, b):
    """Solve G y = b, b (n,) or rows (nv, n): blocked forward substitution,
    n/block sequential steps, each a gather-dot over the solved prefix and
    a product with the inverse diagonal block, for all right-hand sides."""
    return _tri_sweep(tri, b, lower=True)


def ell_triu_solve(tri: EllTri, b):
    """Solve G' y = b (backward; the solved tail enters through the
    transpose pattern, gathers only)."""
    return _tri_sweep(tri, b, lower=False)
