"""Fourier-accelerated kernel matvecs, "fastsum" (port of ops/fastsum.py).

K x ~= f^2 (Re[NDFT2(b * NDFT1(x))] + nearfield(x) + mu x) with exact
separable nonequispaced DFTs over a folded mode space (ref
SRC/external/nfft_interface.c and the NFFT3 fastsum engine):

1. Geometry, once per dataset (nfft_interface.c:150-213): center by the mean,
   scale so the radius lies in [1/8, 1/4], and tabulate cos/sin(2 pi p x)
   for the folded modes p = 0..N/2.
2. Coefficients, per hyperparameters: the kernel sampled on an oversampled
   torus grid, FFT, central N modes, folded over the sign patterns.  For
   matern12 a sparse near-field correction phi_exact - phi_fourier (the
   role of fastsum's eps_I near-field sum), on by default: on a KNN
   pattern, or on the stream engine on every pair within a radius rho
   (the pitch of a cell grid, ops/cellgrid.py).
3. Apply: adjoint NDFT (points -> mode tensor), combine with the folded
   weights, forward NDFT (mode tensor -> points), plus the near-field.

The full (non-additive) operator of one to three features is
`fastsum_matvec`.  The additive one, over windows of one to three features,
has three engines; each takes one vector (n,) or a batch of rows (nv, n):

- the TABLE engine (`additive_fastsum_matvec`): torch products on the
  per-window tables, every window dimension;
- the STREAM engine (`packed_ndft_*`): one trimmed phase table for all
  windows of one or two features, streamed through the table kernels of
  ops/packed_ndft.py;
- the FUSED engine (`additive_fastsum_*_fused`): the windows of one or two
  features through the phase-regenerating kernels of ops/packed_ndft.py
  (no table; the Nyquist mode kept).

In the last two, 3-feature windows run on the table path, and the
near-field corrections are added as ELL products.  The kernels take their
plain torch versions on CPU tensors.
"""

import itertools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..solvers.reductions import _comp_scan
from ..utils.timers import host_read
from . import cellgrid as cg
from .kernels import BASE_KERNELS, KernelParams
from .knn import knn_pattern
from .matops import ell_matvec, ell_matvec_batch, ell_rmatvec, ell_rmatvec_batch
from .packed_ndft import (
    pack_phase_table,
    packed_adjoint,
    packed_adjoint_regen,
    packed_forward,
    packed_forward_regen,
)


@dataclass
class FastsumGeometry:
    """Scaled points and folded phase tables Tcs (d, n, 2P):
    Tcs[..., :P] = cos(2 pi p x), Tcs[..., P:] = sin, P = N/2 + 1."""

    N: int
    d: int
    x: torch.Tensor          # (n, d) centered and scaled, radius <= 1/4
    scale: torch.Tensor      # scalar coordinate scale
    Tcs: torch.Tensor        # (d, n, 2P)


def _nmodes(N: int) -> int:
    """Folded mode count per dim: p = 0..N/2 inclusive."""
    return N // 2 + 1


def fastsum_geometry(X, N: int = 32, *, table_dtype=None) -> FastsumGeometry:
    """Center/scale points and tabulate the folded phases.

    table_dtype: store the tables narrower (torch.bfloat16); products then
    accumulate in the data dtype.
    """
    n, d = X.shape
    if d > 3:
        raise ValueError(
            f"fastsum supports point dims 1..3 (got d={d}); for higher-"
            "dimensional data use additive windows of <=3 features "
            "(ref nfft_interface.c:622-674) or the dense operator"
        )
    xc = X - torch.mean(X, dim=0)[None, :]
    radius = torch.max(torch.sqrt(torch.sum(xc * xc, dim=1)))
    need = (radius > 0.25) | (radius < 0.125)
    scale = torch.where(need, 0.25 / radius, torch.ones_like(radius))
    x = xc * scale
    p = torch.arange(_nmodes(N), dtype=X.dtype, device=X.device)
    phase = 2.0 * math.pi * x[:, :, None] * p[None, None, :]   # (n, d, P)
    Tcs = torch.cat([torch.cos(phase), torch.sin(phase)], dim=2).permute(1, 0, 2)
    Tcs = Tcs.contiguous() if table_dtype is None else Tcs.to(table_dtype).contiguous()
    return FastsumGeometry(N=N, d=d, x=x, scale=scale, Tcs=Tcs)


@dataclass
class FastsumPlan:
    """Geometry + real Fourier coefficients (shifted mode order) and their
    parity-folded weights w / dw_l, (nS,) + (P,)*d.

    nf_idx / nf_val / nf_dval: the optional near-field correction, a padded
    ELL matrix (n, lfil) of phi_exact - phi_fourier (and of its d/dl) at the
    pattern's pair offsets.  nf_sym: the pattern is symmetrized (each edge
    and self once per row) and applies as one ELL product; otherwise it is
    lower-triangular with self in the last slot and applies as
    S + S' - diag(S).
    """

    N: int
    d: int
    kind: str
    geom: FastsumGeometry
    b: torch.Tensor
    db_l: torch.Tensor
    w: torch.Tensor
    dw_l: torch.Tensor
    params: KernelParams
    nf_idx: Optional[torch.Tensor] = None
    nf_val: Optional[torch.Tensor] = None
    nf_dval: Optional[torch.Tensor] = None
    nf_sym: bool = False


# Parity folding: K_ij = sum_k b_k cos(2 pi k.D) folds k -> |k| onto one
# weight tensor per even-parity set S of dims (see the JAX module).
_EVEN_SETS = {1: [()], 2: [(), (0, 1)], 3: [(), (0, 1), (0, 2), (1, 2)]}


def fold_coeffs(b, N: int, d: int):
    """Fold a full shifted-order coefficient tensor to (nS,) + (P,)*d with d
    separable (P, N) maps per sign set (each map row has <= 2 unit entries,
    so the contraction is exact)."""
    k = np.arange(N) - N // 2
    p = np.abs(k)
    sgn = np.where(k >= 0, 1.0, -1.0)
    A0 = (np.arange(_nmodes(N))[:, None] == p[None, :]).astype(np.float64)
    A1 = A0 * sgn[None, :]
    outs = []
    for S in _EVEN_SETS[d]:
        t = b.reshape((N,) * d)
        for j in range(d):
            A = host_read(A1 if j in S else A0, lambda a: torch.as_tensor(a, dtype=b.dtype, device=b.device))
            t = torch.movedim(torch.tensordot(A, torch.movedim(t, j, 0), dims=([1], [0])), 0, j)
        outs.append(t)
    return torch.stack(outs)


def _torus_grid_r2(N: int, d: int, dtype, device=None):
    """Squared radii of the N^d torus grid [-1/2, 1/2)^d in fft order."""
    g = torch.fft.fftfreq(N, d=1.0 / N, dtype=dtype, device=device) / N
    grids = torch.meshgrid(*([g] * d), indexing="ij")
    return sum(gi * gi for gi in grids)


def _central_modes(bs, N: int, d: int):
    """Central N modes per dim of an fftshifted oversampled tensor."""
    lo = bs.shape[0] // 2 - N // 2
    return bs[(slice(lo, lo + N),) * d]


# --- trigonometric polynomial at arbitrary offsets ------------------------------

def _trigpoly_eval_multi(bs, D):
    """Re sum_k b_k e^{2 pi i k.D} for several coefficient sets at once.

    bs: list of (N,)*d real coefficient tensors (shifted mode order); D:
    (m, d) offsets.  The phase tables are built once and shared by the sets
    (the near-field evaluates the kernel and its dk/dl at the same offsets).
    """
    m, d = D.shape
    N = bs[0].shape[0]
    k = torch.arange(-(N // 2), N - N // 2, dtype=D.dtype, device=D.device)
    ph = 2.0 * math.pi * D[:, :, None] * k[None, None, :]   # (m, d, N)
    C = torch.cos(ph)
    S = torch.sin(ph)

    def pair(A1, b, A2):                                     # sum_kl A1_mk b_kl A2_ml
        return torch.sum((A1 @ b) * A2, dim=1)

    def tri(A1, b, A2, A3):                                  # sum_klr A1_mk b_klr A2_ml A3_mr
        T = (A1 @ b.reshape(N, N * N)).reshape(m, N, N)
        return torch.sum(torch.sum(T * A2[:, :, None], dim=1) * A3, dim=1)

    outs = []
    for b in bs:
        if d == 1:
            outs.append(C[:, 0, :] @ b)
        elif d == 2:
            outs.append(pair(C[:, 0], b, C[:, 1]) - pair(S[:, 0], b, S[:, 1]))
        elif d == 3:
            outs.append(tri(C[:, 0], b, C[:, 1], C[:, 2]) - tri(C[:, 0], b, S[:, 1], S[:, 2])
                        - tri(S[:, 0], b, C[:, 1], S[:, 2]) - tri(S[:, 0], b, S[:, 1], C[:, 2]))
        else:
            raise NotImplementedError(f"trigpoly_eval supports d=1..3, got {d}")
    return outs


def trigpoly_eval(b, D):
    """Re sum_k b_k e^{2 pi i k.D} at arbitrary offsets D (m, d)."""
    return _trigpoly_eval_multi([b], D)[0]


def trigpoly_eval_multi_chunked(bs, D, *, chunk: int = 131072):
    """_trigpoly_eval_multi over chunks of offsets: a flat evaluation would
    hold (m, d, N) phases, gigabytes at near-field scale (m = n * lfil).
    For d = 3 the chunk also bounds the (chunk, N, N) partial contraction
    to 2^25 elements."""
    m, d = D.shape
    N = bs[0].shape[0]
    if d == 3:
        chunk = min(chunk, max(1, (1 << 25) // (N * N)))
    if m <= chunk:
        return _trigpoly_eval_multi(bs, D)
    parts = [_trigpoly_eval_multi(bs, D[s: s + chunk]) for s in range(0, m, chunk)]
    return [torch.cat([p[j] for p in parts]) for j in range(len(bs))]


# --- near-field correction -----------------------------------------------------

def nearfield_correction(kind: str, params: KernelParams, geom: FastsumGeometry,
                         b, db_l, lfil: int, pattern=None, taper: bool = True):
    """Sparse correction phi_exact - phi_fourier on a KNN pattern.

    Returns (idx, val, dval), (n, lfil) each: idx int64, row i holding the
    pattern's neighbours (padded slots masked to 0).  taper (the JAX
    default): weight by (1 - r/r_max)^2 with r_max the largest valid pair
    distance, one global scalar so the matrix stays symmetric; it keeps the
    corrected operator positive definite.  pattern: a precomputed
    (idx, mask) (the pattern does not depend on the hyperparameters), else
    `knn_pattern(x, lfil)`.
    """
    x = geom.x
    idx, mask = pattern if pattern is not None else knn_pattern(x, lfil)
    idx = torch.as_tensor(idx, device=x.device).to(torch.int64)
    mask = torch.as_tensor(mask, device=x.device).to(torch.bool)
    D = x[:, None, :] - x[idx]                               # (n, lfil, d)
    r2s = torch.sum(D * D, dim=2)
    r2_true = r2s / (geom.scale * geom.scale)
    phi, dphi_l = BASE_KERNELS[kind](r2_true, params.l)
    tp_f, dtp_f = trigpoly_eval_multi_chunked([b, db_l], D.reshape(-1, D.shape[2]))
    val = torch.where(mask, phi - tp_f.reshape(r2s.shape), 0.0)
    dval = torch.where(mask, dphi_l - dtp_f.reshape(r2s.shape), 0.0)
    if taper:
        r = torch.sqrt(r2s)
        r_max = torch.max(torch.where(mask, r, 0.0))
        w = torch.square(torch.clamp(1.0 - r / torch.clamp(r_max, min=1e-30), min=0.0))
        val = val * w
        dval = dval * w
    return idx, val, dval


def nearfield_matvec(idx, val, x):
    """y = (S + S' - diag(S)) x for lower-tri padded-ELL S (self at slot -1)."""
    return ell_matvec(idx, val, x) + ell_rmatvec(idx, val, x) - val[:, -1] * x


def nearfield_apply(sym: bool, idx, val, x):
    """Near-field product: one ELL product for a symmetrized pattern, the
    S + S' - diag(S) form for a lower-triangular one."""
    if sym:
        return ell_matvec(idx, val, x)
    return nearfield_matvec(idx, val, x)


def nearfield_apply_batch(sym: bool, idx, val, Xb):
    """(nv, n) batched near-field products: one row gather serves every
    right-hand side."""
    if sym:
        return ell_matvec_batch(idx, val, Xb)
    return ell_matvec_batch(idx, val, Xb) + ell_rmatvec_batch(idx, val, Xb) - val[:, -1] * Xb


def _nearfield_any(sym: bool, idx, val, X):
    """nearfield_apply for (n,), nearfield_apply_batch for (nv, n)."""
    return nearfield_apply(sym, idx, val, X) if X.ndim == 1 else nearfield_apply_batch(sym, idx, val, X)


def symmetrize_pattern(idx, mask):
    """Host symmetrization of a lower-tri KNN pattern (self at slot -1).

    Returns numpy (sym_idx, sym_mask) of shape (n, lfil_s): row i lists each
    undirected neighbour edge once plus self once.  A symmetric pair
    function evaluated on it gives a symmetric ELL matrix, applied as one
    gather product.
    """
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    mask = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    n, _lfil = idx.shape
    rows, slots = np.nonzero(mask)
    cols = idx[rows, slots]
    keep = rows != cols                      # drop self edges; re-add once
    e_r = np.concatenate([rows[keep], cols[keep], np.arange(n)])
    e_c = np.concatenate([cols[keep], rows[keep], np.arange(n)])
    order = np.argsort(e_r, kind="stable")
    e_r, e_c = e_r[order], e_c[order]
    starts = np.searchsorted(e_r, np.arange(n))
    counts = np.searchsorted(e_r, np.arange(n) + 1) - starts
    lfil_s = int(counts.max()) if counts.size else 1
    sym_idx = np.zeros((n, lfil_s), np.int32)
    sym_mask = np.zeros((n, lfil_s), bool)
    rank = np.arange(e_r.size) - starts[e_r]
    sym_idx[e_r, rank] = e_c
    sym_mask[e_r, rank] = True
    return sym_idx, sym_mask


def _resolve_nf_lfil(kind: str, nearfield_lfil, n: int, d: int) -> int:
    """None = auto: the near-field size for matern12 (64 in 1-D, where the
    kink radius holds ~4x more neighbours, 16 otherwise), 0 for the smooth
    kernels."""
    if nearfield_lfil is None:
        nearfield_lfil = (64 if d == 1 else 16) if kind == "matern12" else 0
    return min(int(nearfield_lfil), n)


def _skewed(lfil_s: int, lfil: int) -> bool:
    """The skewed in-degree guard: a point that is the nearest preceding
    neighbour of many later points blows the padded symmetric width; beyond
    ~4x lfil the lower-triangular form is kept."""
    return lfil_s > max(4 * lfil, 64)


def nearfield_patterns(kind: str, geom: FastsumGeometry, nearfield_lfil=None, *, sym: bool = False):
    """The hyperparameter-independent KNN pattern of one plan, or None.

    sym=True: symmetrized (idx, mask, True), unless the skewed in-degree
    guard keeps the lower-triangular (idx, mask, False)."""
    lfil = _resolve_nf_lfil(kind, nearfield_lfil, geom.x.shape[0], geom.d)
    if lfil == 0:
        return None
    pat = knn_pattern(geom.x, lfil)
    if not sym:
        return pat
    sidx, smask = symmetrize_pattern(pat[0], pat[1])
    if _skewed(sidx.shape[1], lfil):
        return (pat[0], pat[1], False)
    dev = geom.x.device
    return (torch.from_numpy(sidx).to(dev), torch.from_numpy(smask).to(dev), True)


def additive_nearfield_patterns(kind: str, geom, nearfield_lfil=None):
    """Per-group KNN patterns of an AdditiveFastsumGeometry: None or
    (idx, mask) stacked over the group's windows, (Wg, n, lfil) each.  Pass
    to additive_fastsum_coeffs(nf_patterns=...) so the KNN runs once per
    dataset, not per loss evaluation."""
    pats = []
    for _dw, _order, geos in geom.groups:
        n, d = geos[0].x.shape
        lfil = _resolve_nf_lfil(kind, nearfield_lfil, n, d)
        if lfil == 0:
            pats.append(None)
            continue
        per = [knn_pattern(g.x, lfil) for g in geos]
        pats.append((torch.stack([p[0] for p in per]), torch.stack([p[1] for p in per])))
    return tuple(pats)


def symmetrize_nearfield_patterns(pats):
    """Host post-pass over additive_nearfield_patterns: per window,
    symmetrize_pattern, padded to a common width per group.  Returns
    per-group (idx, mask, True) triples -- or, when any window trips the
    skewed in-degree guard, every group's lower-triangular
    (idx, mask, False): the decision is global, the packed apply carries
    one nf_sym flag."""
    infos = []
    for pat in pats:
        if pat is None:
            infos.append(None)
            continue
        syms = [symmetrize_pattern(pat[0][w], pat[1][w]) for w in range(pat[0].shape[0])]
        lf = max(si.shape[1] for si, _ in syms)
        if _skewed(lf, pat[0].shape[2]):
            return tuple(None if p is None else (p[0], p[1], False) for p in pats)
        infos.append((lf, syms))

    out = []
    for pat, info in zip(pats, infos):
        if pat is None:
            out.append(None)
            continue
        lf, syms = info
        Wg, n = pat[0].shape[:2]
        sidx = np.zeros((Wg, n, lf), np.int32)
        smask = np.zeros((Wg, n, lf), bool)
        for w, (si, sm) in enumerate(syms):
            sidx[w, :, : si.shape[1]] = si
            smask[w, :, : si.shape[1]] = sm
        dev = pat[0].device
        out.append((torch.from_numpy(sidx).to(dev), torch.from_numpy(smask).to(dev), True))
    return tuple(out)


# --- the stream engine's radius near-field ---------------------------------------
# The JAX package evaluates this correction straight into the dense cell
# stencil of ops/cellgrid.py, (ncells, c, 3^d c) per window, a layout that
# avoids gathers on its backend.  About 11% of a stencil's entries lie
# within the radius, so the port keeps only those: the pairs are found once
# per dataset from the same cell grid (candidates in the 3^d neighbouring
# cells), stored as a symmetric padded-ELL matrix in user order, and the
# values are evaluated on the in-radius pairs alone.  The matrix is the
# JAX one, entry for entry.

class NfStencilDirect(NamedTuple):
    """The in-radius pairs of one window, from its cell grid (pitch = rho).

    idx (n, width): row i lists every point within rho of point i, itself
    included, in the order of the stencil's neighbour slots; empty slots
    point at i and carry the value 0.  pos (nnz,): the flat (n * width)
    positions of the filled slots."""

    grid: cg.CellGrid
    x: torch.Tensor          # (n, d) scaled window coordinates
    idx: torch.Tensor
    pos: torch.Tensor
    rho: float               # correction radius (= grid pitch)


_PAIR_CHUNK = 1 << 22   # candidate pairs per step of _radius_pattern


def _radius_pattern(x, grid: cg.CellGrid):
    """(idx, pos) of NfStencilDirect: every (point, neighbour-slot) pair of
    the stencil with both slots filled and r^2 <= rho^2, in chunks of about
    _PAIR_CHUNK candidate pairs."""
    dev = cg.to_device(grid, x.device)
    n, c, w9 = grid.n, grid.c, grid.noffs * grid.c
    nb_ids = cg.stencil_neighbors(dev, torch.where(dev.padmask, dev.pad_src_u + 1, 0))  # 0: empty
    rho2 = grid.h * grid.h
    rows, cols = [], []
    step = max(1, _PAIR_CHUNK // (c * w9))
    for s in range(0, dev.ncells, step):
        src, nb = dev.pad_src_u[s: s + step], nb_ids[s: s + step]
        D = x[src][:, :, None, :] - x[torch.clamp(nb - 1, min=0)][:, None, :, :]
        m = dev.padmask[s: s + step, :, None] & (nb > 0)[:, None, :] & (torch.sum(D * D, dim=3) <= rho2)
        cell, i, t = torch.nonzero(m, as_tuple=True)
        rows.append(src[cell, i])
        cols.append(nb[cell, t] - 1)
    rows, cols = torch.cat(rows), torch.cat(cols)
    order = torch.argsort(rows, stable=True)
    rows, cols = rows[order], cols[order]
    counts = torch.bincount(rows, minlength=n)
    rank = torch.arange(rows.shape[0], device=x.device) - (torch.cumsum(counts, 0) - counts)[rows]
    width = int(counts.max())
    idx = torch.arange(n, device=x.device)[:, None].repeat(1, width)
    idx[rows, rank] = cols
    return idx, rows * width + rank


def additive_nearfield_stencil_direct(geom, kind: str, nearfield_lfil=None, *,
                                      max_width_factor: int = 48):
    """Per-group tuples of NfStencilDirect for the d <= 2 windows, once per
    dataset (ref fastsum.py additive_nearfield_stencil_direct).

    nearfield_lfil sizes the radius through the cell occupancy (max(4,
    lfil/3) points a cell, so about lfil neighbours within it).  3-feature
    groups get None (their KNN near-field rides the table path).  Returns
    None for every window when any window's grid degenerates or its
    stencil is wider than max_width_factor * max(lfil, 8)."""
    out = []
    for dw, _order, geos in geom.groups:
        lfil = _resolve_nf_lfil(kind, nearfield_lfil, geos[0].x.shape[0], dw)
        if lfil == 0 or dw == 3:
            out.append(None)
            continue
        entries = []
        for g in geos:
            grid = cg.build_cell_grid(g.x.detach().cpu().numpy(), target_occupancy=max(4.0, lfil / 3.0))
            if grid is None or grid.noffs * grid.c > max_width_factor * max(lfil, 8):
                return None
            idx, pos = _radius_pattern(g.x, grid)
            entries.append(NfStencilDirect(grid=grid, x=g.x, idx=idx, pos=pos, rho=float(grid.h)))
        out.append(tuple(entries))
    return tuple(out)


class NfStencilEntry(NamedTuple):
    """One window's radius near-field values, symmetric padded ELL (n, width)
    on NfStencilDirect.idx: A_k for K, A_l for dK/dl.  The JAX entry also carries an exception list of
    out-of-stencil edges; a direct stencil's is always empty (one zero
    value), so the port has none (tests/test_torch_nf_stencil.py pins it)."""

    idx: torch.Tensor
    A_k: torch.Tensor
    A_l: Optional[torch.Tensor]      # None in a solve-only plan


def _nf_direct_values(sten: NfStencilDirect, kind: str, params: KernelParams, scale, b,
                      db_l, require_grad: bool = True) -> NfStencilEntry:
    """The exact kernel minus the trigonometric polynomial of the untrimmed
    coefficients b (and db_l), tapered by (1 - r/rho)^2, on the in-radius
    pairs (ref fastsum.py _nf_direct_values); the phase tables are built in
    chunks of pairs, which bounds the transient memory.  require_grad=False
    (a solve-only plan) skips the dk/dl values: A_l is None."""
    n, width = sten.idx.shape
    rows, cols = sten.pos // width, sten.idx.reshape(-1)[sten.pos]
    D = sten.x[rows] - sten.x[cols]
    r2s = torch.sum(D * D, dim=1)
    phi, dphi_l = BASE_KERNELS[kind](r2s / (scale * scale), params.l)
    sets = [b, db_l] if require_grad else [b]
    tps = trigpoly_eval_multi_chunked(sets, D)
    w = torch.square(torch.clamp(1.0 - torch.sqrt(r2s) / sten.rho, min=0.0))
    vals = []
    for src, tp in zip((phi, dphi_l), tps):
        v = torch.zeros(n * width, dtype=D.dtype, device=D.device)
        v[sten.pos] = (src - tp) * w
        vals.append(v.reshape(n, width))
    return NfStencilEntry(idx=sten.idx, A_k=vals[0], A_l=vals[1] if require_grad else None)


def _nf_trip_apply_batch(nf_sym: bool, trip, Xb, which: str):
    """One window's near-field product ('k': K, 'l': dK/dl) on a batch of
    rows (nv, n), one row gather for all: a radius stencil entry (symmetric
    ELL) or a KNN (idx, val, dval)."""
    if isinstance(trip, NfStencilEntry):
        if which != "k" and trip.A_l is None:
            raise ValueError("a solve-only plan (nf_require_grad=False) holds no dK/dl near-field")
        return ell_matvec_batch(trip.idx, trip.A_k if which == "k" else trip.A_l, Xb)
    idx, val, dval = trip
    return nearfield_apply_batch(nf_sym, idx, val if which == "k" else dval, Xb)


# --- coefficients ----------------------------------------------------------------

def fastsum_coeffs(kind: str, params: KernelParams, geom: FastsumGeometry, *, psd_clip: bool = False,
                   oversample: int = 2, nearfield_lfil: Optional[int] = None, nf_pattern=None) -> FastsumPlan:
    """Sample the scaled kernel on the (oversample*N)^d torus grid, FFT, and
    keep the central N modes per dim (fastsum's anti-aliasing grid,
    nfft_interface.c:18-27).

    nearfield_lfil: None = auto (_resolve_nf_lfil);
    nf_pattern: a precomputed (idx, mask) or (idx, mask, sym) pattern for
    the near-field.
    psd_clip: clip the kernel's coefficients to >= 0 after the FFT (the
    true spectra are positive; negative ones are truncation and aliasing
    artifacts), which projects the Fourier operator onto the PSD cone for
    PCG; derivative coefficients are never clipped (ref fastsum.py
    fastsum_coeffs).
    """
    N, d = geom.N, geom.d
    Nos = int(oversample) * N
    dtype = geom.x.dtype
    r2_true = _torus_grid_r2(Nos, d, dtype, geom.x.device) / (geom.scale * geom.scale)
    k_samp, dk_dl_samp = BASE_KERNELS[kind](r2_true, params.l)

    def coeffs(samp):
        bs = torch.fft.fftshift(torch.fft.fftn(samp)).real.to(dtype) / (Nos**d)
        return _central_modes(bs, N, d)

    b = coeffs(k_samp)
    if psd_clip:
        b = torch.clamp(b, min=0.0)
    db_l = coeffs(dk_dl_samp)
    nf_idx = nf_val = nf_dval = None
    nf_sym = False
    nearfield_lfil = _resolve_nf_lfil(kind, nearfield_lfil, geom.x.shape[0], d)
    if nf_pattern is not None and len(nf_pattern) == 3:
        nf_pattern, nf_sym = nf_pattern[:2], bool(nf_pattern[2])
    if nearfield_lfil > 0 or nf_pattern is not None:
        nf_idx, nf_val, nf_dval = nearfield_correction(kind, params, geom, b, db_l,
                                                       nearfield_lfil, pattern=nf_pattern)
    return FastsumPlan(N=N, d=d, kind=kind, geom=geom, b=b, db_l=db_l,
                       w=fold_coeffs(b, N, d), dw_l=fold_coeffs(db_l, N, d), params=params,
                       nf_idx=nf_idx, nf_val=nf_val, nf_dval=nf_dval, nf_sym=nf_sym)


def fastsum_build(kind: str, params: KernelParams, X, N: int = 32, *, psd_clip: bool = False,
                  table_dtype=None, oversample: int = 2,
                  nearfield_lfil: Optional[int] = None) -> FastsumPlan:
    return fastsum_coeffs(kind, params, fastsum_geometry(X, N, table_dtype=table_dtype),
                          psd_clip=psd_clip, oversample=oversample, nearfield_lfil=nearfield_lfil)


# --- folded apply ------------------------------------------------------------
# alpha and B may carry leading batch axes (one per right-hand side).

def _tmat(A, B, out_dtype):
    """Phase-table product: exact in out_dtype, or with narrow (bf16) tables
    the operands rounded to the table dtype and accumulated in out_dtype."""
    if A.dtype == out_dtype and B.dtype == out_dtype:
        return A @ B
    return A.to(out_dtype) @ B.to(A.dtype).to(out_dtype)


def _folded_adjoint(Tcs, alpha):
    """Block tensor A_t[p] = sum_i alpha_i prod_d t_d(2 pi p_d x_id), (..., 2P, ...)."""
    d = Tcs.shape[0]
    P = Tcs.shape[2] // 2
    a = alpha.to(Tcs.dtype)
    if d == 1:
        return _tmat(a[..., None, :], Tcs[0], alpha.dtype)[..., 0, :]
    if d == 2:
        return _tmat((Tcs[0] * a[..., None]).transpose(-1, -2), Tcs[1], alpha.dtype)
    if d == 3:
        # one (R * 4P, 2P) product per mode p3 of the third dim, all R rows of
        # alpha stacked into the GEMM's M: as R skinny (4P, n) x (n, 2P)
        # products batched, it took 6.1 ms per mode against 0.44 ms stacked
        # (n = 2e5, R = 10, P = 17, float32, NVIDIA H100); rows t3 = cos, sin
        n = a.shape[-1]
        ar = a.reshape(-1, n).T                              # (n, R)
        R = ar.shape[1]
        mats = []
        for p3 in range(P):
            Acat = torch.cat([Tcs[0][:, None, :] * (ar * Tcs[2][:, p3, None])[:, :, None],
                              Tcs[0][:, None, :] * (ar * Tcs[2][:, P + p3, None])[:, :, None]],
                             dim=-1)                         # (n, R, 4P)
            mats.append(_tmat(Acat.reshape(n, R * 4 * P).T, Tcs[1], alpha.dtype).reshape(R, 4 * P, 2 * P))
        M3 = torch.stack(mats, dim=-1).reshape(*a.shape[:-1], 4 * P, 2 * P, P)
        return torch.cat([M3[..., : 2 * P, :, :], M3[..., 2 * P:, :, :]], dim=-1)
    raise NotImplementedError(f"fastsum supports window dims 1..3, got {d}")


def _folded_combine(W, A, d: int):
    """B_t = sum_S (-1)^{|S|/2} sign_t(S) W_S A_{t xor S} over even sets S,
    sign_t(S) = prod_{j in S} (+1 if t_j = sin else -1).

    A may carry leading batch axes: (..., 2P) for d=1, (..., 2P, 2P) for d=2.
    """
    P = W.shape[-1]
    sets = _EVEN_SETS[d]

    def blk(T, t):
        return T[(Ellipsis,) + tuple(slice(P * tj, P * (tj + 1)) for tj in t)]

    blocks = {}
    for t in itertools.product((0, 1), repeat=d):
        B = W[0] * blk(A, t)
        for si, S in enumerate(sets[1:], start=1):   # |S| = 2 -> factor -1
            sign = 1
            for j in S:
                sign *= 1 if t[j] == 1 else -1
            t_flip = tuple(tj ^ (1 if j in S else 0) for j, tj in enumerate(t))
            B = B - sign * W[si] * blk(A, t_flip)
        blocks[t] = B

    def assemble(prefix):
        if len(prefix) == d:
            return blocks[prefix]
        return torch.cat([assemble(prefix + (0,)), assemble(prefix + (1,))],
                         dim=len(prefix) - d)

    return assemble(())


def _folded_forward(Tcs, B):
    """y_i = sum_t prod_d t_d(2 pi p_d x_id) B_t[p]."""
    d = Tcs.shape[0]
    P = Tcs.shape[2] // 2
    if d == 1:
        return _tmat(Tcs[0], B[..., None], B.dtype)[..., 0]
    if d == 2:
        return torch.sum(_tmat(Tcs[0], B, B.dtype) * Tcs[1].to(B.dtype), dim=-1)
    if d == 3:
        T1 = Tcs[1].to(B.dtype)
        y = 0.0
        for p3 in range(P):
            Tt = _tmat(Tcs[0], torch.cat([B[..., p3], B[..., P + p3]], dim=-1), B.dtype)
            yc = torch.sum(Tt[..., : 2 * P] * T1, dim=-1)
            ys = torch.sum(Tt[..., 2 * P:] * T1, dim=-1)
            y = y + (yc * Tcs[2][:, p3].to(B.dtype) + ys * Tcs[2][:, P + p3].to(B.dtype))
        return y
    raise NotImplementedError(f"fastsum supports window dims 1..3, got {d}")


def _folded_adjoint_comp(Tcs, alpha, chunk: int = 8192):
    """The folded adjoint summed over chunks of `chunk` points, the per-chunk
    mode tensors combined by an error-free TwoSum scan: the accumulation
    error of the adjoint's n-long reduction stays about sqrt(chunk) eps,
    independent of n (the float64 sums the reference assumes)."""
    n = Tcs.shape[1]
    if n <= chunk:
        return _folded_adjoint(Tcs, alpha)
    return _comp_scan([_folded_adjoint(Tcs[:, s: s + chunk], alpha[..., s: s + chunk])
                       for s in range(0, n, chunk)])


def _folded_apply_multi(Tcs, W_list, x, *, compensated: bool = False):
    """One adjoint, one forward per folded weight stack (shared NDFT1).
    compensated=True: the chunked float-float adjoint."""
    d = Tcs.shape[0]
    A = _folded_adjoint_comp(Tcs, x) if compensated else _folded_adjoint(Tcs, x)
    return [_folded_forward(Tcs, _folded_combine(W, A, d)) for W in W_list]


# --- non-additive fastsum ----------------------------------------------------------
# x: one vector (n,) or a batch of rows (nv, n).

def fastsum_base_apply(plan: FastsumPlan, coeffs, x):
    """The pure kernel sum of a full shifted-order coefficient tensor (for
    example plan.b or plan.db_l), folded on the fly; no f^2, mu or
    near-field."""
    (y,) = _folded_apply_multi(plan.geom.Tcs, [fold_coeffs(coeffs, plan.N, plan.d)], x)
    return y


def _plan_sums(plan: FastsumPlan, x, families, compensated):
    ys = _folded_apply_multi(plan.geom.Tcs, [getattr(plan, f) for f in families], x,
                             compensated=compensated)
    if plan.nf_val is None:
        return ys
    return [y + _nearfield_any(plan.nf_sym, plan.nf_idx, getattr(plan, _NF_VALUES[f]), x)
            for y, f in zip(ys, families)]


def fastsum_matvec(plan: FastsumPlan, x, *, compensated: bool = False):
    """y = f^2 (ksum(x) + mu x) -- ref Nfft4GPNFFTMatSymv nfft_interface.c:400-497."""
    p = plan.params
    (y,) = _plan_sums(plan, x, ["w"], compensated)
    return p.f * p.f * (y + p.mu * x)


def fastsum_grad_matvec(plan: FastsumPlan, x, *, compensated: bool = False):
    """(3, n) stacked dK_j x -- ref nfft_interface.c:499-620; (nv, 3, n) for
    a batch of rows."""
    k_part, l_part = _plan_sums(plan, x, ["w", "dw_l"], compensated)
    return _grad_rows(plan.params, k_part, l_part, x, 1)


# --- additive (windowed) fastsum ---------------------------------------------

class AdditiveFastsumGeometry(NamedTuple):
    """groups: tuple of (dw, window_ids, [FastsumGeometry per window])."""

    n_windows: int
    groups: tuple


def additive_fastsum_geometry(X, windows, N: int = 32, *, table_dtype=None):
    """One NDFT geometry per feature window, grouped by window dimension
    (ref nfft_interface.c:622-674).  windows: (W, dw_max), -1 = padding."""
    windows = np.asarray(windows)
    by_dim = {}
    for w in range(windows.shape[0]):
        feats = [int(f) for f in windows[w] if f >= 0]
        by_dim.setdefault(len(feats), []).append((w, feats))
    groups = []
    for dw, members in sorted(by_dim.items()):
        geos = [fastsum_geometry(host_read(feats, lambda f: X[:, f]), N, table_dtype=table_dtype)
                for _, feats in members]
        groups.append((dw, tuple(w for w, _ in members), geos))
    return AdditiveFastsumGeometry(n_windows=windows.shape[0], groups=tuple(groups))


class AdditiveFastsumPlan(NamedTuple):
    n_windows: int
    groups: tuple           # (dw, window_ids, [FastsumPlan per window])
    params: KernelParams


def additive_fastsum_coeffs(kind: str, params: KernelParams,
                            geom: AdditiveFastsumGeometry, *, psd_clip: bool = False, oversample: int = 2,
                            nearfield_lfil: Optional[int] = None, nf_patterns=None) -> AdditiveFastsumPlan:
    """nf_patterns: optional per-group patterns (additive_nearfield_patterns,
    optionally symmetrized), reused across loss evaluations; psd_clip as in
    fastsum_coeffs, per window."""
    groups = []
    for gi, (dw, order, geos) in enumerate(geom.groups):
        pat = nf_patterns[gi] if nf_patterns is not None else None
        if pat is None:
            plans = [fastsum_coeffs(kind, params, g, psd_clip=psd_clip, oversample=oversample,
                                    nearfield_lfil=nearfield_lfil) for g in geos]
        else:
            sym = bool(pat[2]) if len(pat) == 3 else False
            plans = [fastsum_coeffs(kind, params, g, psd_clip=psd_clip, oversample=oversample,
                                    nearfield_lfil=nearfield_lfil,
                                    nf_pattern=(pat[0][k], pat[1][k], sym))
                     for k, g in enumerate(geos)]
        groups.append((dw, order, plans))
    return AdditiveFastsumPlan(n_windows=geom.n_windows, groups=tuple(groups), params=params)


def additive_fastsum_build(kind, params, X, windows, N: int = 32, *, psd_clip: bool = False,
                           table_dtype=None, oversample: int = 2,
                           nearfield_lfil: Optional[int] = None):
    return additive_fastsum_coeffs(
        kind, params, additive_fastsum_geometry(X, windows, N, table_dtype=table_dtype),
        psd_clip=psd_clip, oversample=oversample, nearfield_lfil=nearfield_lfil,
    )


_NF_VALUES = {"w": "nf_val", "dw_l": "nf_dval"}


def _window_sums(groups, X, families, compensated=False):
    """Per weight family ('w' for K, 'dw_l' for dK/dl), the window-summed
    ksum(X) of the groups on the table path, near-field included (no
    f^2/mu).  X: (n,) or (nv, n)."""
    accs = [torch.zeros_like(X) for _ in families]
    for _dw, _order, plans in groups:
        parts = []
        for pl in plans:
            ys = _folded_apply_multi(pl.geom.Tcs, [getattr(pl, f) for f in families], X,
                                     compensated=compensated)
            if pl.nf_val is not None:
                ys = [y + _nearfield_any(pl.nf_sym, pl.nf_idx, getattr(pl, _NF_VALUES[f]), X)
                      for y, f in zip(ys, families)]
            parts.append(ys)
        for s in range(len(families)):
            accs[s] = accs[s] + torch.sum(torch.stack([p[s] for p in parts]), dim=0)
    return accs


def additive_fastsum_matvec(plan: AdditiveFastsumPlan, x, *, compensated: bool = False):
    """y = f^2 (mean_w ksum_w(x) + mu x) -- ref nfft_interface.c:796-817.
    x: (n,) or a batch of rows (nv, n)."""
    p = plan.params
    (acc,) = _window_sums(plan.groups, x, ["w"], compensated)
    return p.f * p.f * (acc / plan.n_windows + p.mu * x)


def _grad_rows(params, k_acc, l_acc, x, n_windows):
    """(3, n) -- or (nv, 3, n) for a batch x -- rows dK_f x, dK_l x, dK_mu x."""
    f2 = params.f * params.f
    y_f = 2.0 * params.f * (k_acc / n_windows + params.mu * x)
    return torch.stack([y_f, f2 * (l_acc / n_windows), f2 * x], dim=x.ndim - 1)


def additive_fastsum_grad_matvec(plan: AdditiveFastsumPlan, x, *, compensated: bool = False):
    """(3, n) stacked dK_j x -- ref nfft_interface.c:819-840; (nv, 3, n)
    for a batch of rows."""
    k_acc, l_acc = _window_sums(plan.groups, x, ["w", "dw_l"], compensated)
    return _grad_rows(plan.params, k_acc, l_acc, x, plan.n_windows)


# --- packed layout: the kernels' engines -----------------------------------------

class PackedLayout(NamedTuple):
    """The windows of a plan in the packed kernels' layout."""

    xT: Optional[torch.Tensor]   # (Dtot, n) coordinate rows of the d <= 2 windows
    pairs: tuple                 # per 2-D window (ja, jb) rows of xT
    singles: tuple               # per 1-D window its row of xT
    w2: tuple                    # folded weights per 2-D window, pairs order
    dw2: tuple
    w1: tuple                    # per 1-D window, singles order
    dw1: tuple
    nf: tuple                    # per d <= 2 window with a near-field: a KNN
    nf_sym: bool                 # (idx, val, dval) or a NfStencilEntry
    rest: tuple                  # d = 3 groups, applied on the table path


def _packed_layout(plan: AdditiveFastsumPlan, nf_stencils=None, nf_require_grad: bool = True) -> PackedLayout:
    """Flatten the d <= 2 windows into the packed layout (ref fastsum.py
    _packed_layout); the near-field entries list the 2-D windows, then the
    1-D ones.  nf_stencils (additive_nearfield_stencil_direct): a window
    with a stencil takes its radius near-field in place of a KNN triple
    (ref packed_ndft_plan), with its dK/dl values only if
    nf_require_grad."""
    syms = {pl.nf_sym for _, _, plans in plan.groups for pl in plans if pl.nf_val is not None}
    if len(syms) > 1:
        raise ValueError("mixed near-field pattern forms across window groups "
                         "(nf_sym must be global -- rebuild the plan with one policy)")
    rows, pairs, singles = [], [], []
    w2, dw2, w1, dw1, nf2, nf1, rest = [], [], [], [], [], [], []
    for gi, (dw, order, plans) in enumerate(plan.groups):
        if dw == 3:
            rest.append((dw, order, plans))
            continue
        stens = nf_stencils[gi] if nf_stencils is not None else None
        for k, pl in enumerate(plans):
            if stens is not None:
                trip = _nf_direct_values(stens[k], pl.kind, plan.params, pl.geom.scale, pl.b, pl.db_l,
                                         nf_require_grad)
            else:
                trip = None if pl.nf_val is None else (pl.nf_idx, pl.nf_val, pl.nf_dval)
            if dw == 2:
                pairs.append((len(rows), len(rows) + 1))
                rows += [pl.geom.x[:, 0], pl.geom.x[:, 1]]
                w2.append(pl.w)
                dw2.append(pl.dw_l)
                nf2.append(trip)
            else:
                singles.append(len(rows))
                rows.append(pl.geom.x[:, 0])
                w1.append(pl.w)
                dw1.append(pl.dw_l)
                nf1.append(trip)
    return PackedLayout(
        xT=torch.stack(rows) if rows else None, pairs=tuple(pairs), singles=tuple(singles),
        w2=tuple(w2), dw2=tuple(dw2), w1=tuple(w1), dw1=tuple(dw1),
        nf=tuple(t for t in nf2 + nf1 if t is not None), nf_sym=bool(syms and syms.pop()),
        rest=tuple(rest))


def _two_pass(lay, P, Xb, families, adjoint, forward):
    """One adjoint pass for the rows of Xb (nv, n), then ONE forward pass over
    nv * len(families) weight sets in (row, family) order.  Returns
    (nv, len(families), n) sums over the layout's d <= 2 windows."""
    nv, nf = Xb.shape[0], len(families)
    A2, A1 = adjoint(Xb.contiguous())
    fam2 = [lay.w2 if f == "w" else lay.dw2 for f in families]
    fam1 = [lay.w1 if f == "w" else lay.dw1 for f in families]
    G2 = [torch.stack([_folded_combine(W[i], A2[i], 2) for W in fam2], dim=1)
          .reshape(nv * nf, 2 * P, 2 * P) for i in range(len(lay.pairs))]
    G1 = [torch.stack([_folded_combine(W[i], A1[i], 1) for W in fam1], dim=1)
          .reshape(nv * nf, 2 * P) for i in range(len(lay.singles))]
    ys = forward(G2, G1)
    return torch.stack(ys).reshape(nv, nf, Xb.shape[1])


def _layout_sums(lay, Xb, families, kernel_sums):
    """Per family, the (nv, n) window sums of a packed layout: the kernels'
    sums over the d <= 2 windows, their near-field corrections, then the
    d = 3 windows on the table path (ref fastsum.py _packed_apply)."""
    if lay.pairs or lay.singles:
        accs = list(torch.unbind(kernel_sums(Xb), dim=1))
    else:
        accs = [torch.zeros_like(Xb) for _ in families]
    for s, fam in enumerate(families):
        for trip in lay.nf:
            accs[s] = accs[s] + _nf_trip_apply_batch(lay.nf_sym, trip, Xb, "k" if fam == "w" else "l")
    if lay.rest:
        accs = [a + r for a, r in zip(accs, _window_sums(lay.rest, Xb, families))]
    return accs


@dataclass
class PackedNDFT:
    """Streamed-table plan for the packed table kernels, built per
    (dataset, params).

    Tp is ONE phase table (Dtot, 2P, n) for all coordinate rows of the d <= 2
    windows (ops/packed_ndft.pack_phase_table).  The unpaired Nyquist mode is
    trimmed (P = N/2 instead of N/2 + 1, the JAX default edge_trim=True), so
    2P = N.  nf / rest: the near-field triples and the d = 3 groups, as in
    PackedLayout.
    """

    P: int
    n: int
    n_windows: int
    pairs: tuple
    singles: tuple
    Tp: Optional[torch.Tensor]
    w2: tuple
    dw2: tuple
    w1: tuple
    dw1: tuple
    nf: tuple
    nf_sym: bool
    rest: tuple
    params: KernelParams


def packed_ndft_plan(plan: AdditiveFastsumPlan, *, table_dtype=None, nf_stencils=None,
                     nf_require_grad: bool = True) -> PackedNDFT:
    """nf_stencils: the radius near-field of additive_nearfield_stencil_direct,
    its values (K and dK/dl) evaluated here for the plan's hyperparameters;
    nf_require_grad=False skips the dK/dl values for a solve-only plan (its
    K matvec is unchanged, its gradient matvec raises)."""
    lay = _packed_layout(plan, nf_stencils, nf_require_grad)
    first = plan.groups[0][2][0]
    P = first.N // 2
    return PackedNDFT(
        P=P, n=first.geom.x.shape[0], n_windows=plan.n_windows, pairs=lay.pairs,
        singles=lay.singles,
        Tp=pack_phase_table(lay.xT, P, table_dtype=table_dtype) if lay.xT is not None else None,
        w2=tuple(W[:, :P, :P] for W in lay.w2), dw2=tuple(W[:, :P, :P] for W in lay.dw2),
        w1=tuple(W[:, :P] for W in lay.w1), dw1=tuple(W[:, :P] for W in lay.dw1),
        nf=lay.nf, nf_sym=lay.nf_sym, rest=lay.rest, params=plan.params,
    )


def _packed_sets(pn: PackedNDFT, Xb, families):
    """Per family the (nv, n) window sums on the table kernels."""
    return _layout_sums(pn, Xb, families, lambda V: _two_pass(
        pn, pn.P, V, families,
        lambda A: packed_adjoint(pn.Tp, A, pairs=pn.pairs, singles=pn.singles),
        lambda G2, G1: packed_forward(pn.Tp, G2, G1, pairs=pn.pairs, singles=pn.singles)))


def packed_ndft_matvec_batch(pn: PackedNDFT, Xb):
    """Batched y_r = K x_r for the rows of Xb (nv, n): all rows share ONE
    table stream per kernel pass (the SLQ probe batches)."""
    p = pn.params
    (acc,) = _packed_sets(pn, Xb, ["w"])
    return p.f * p.f * (acc / pn.n_windows + p.mu * Xb)


def packed_ndft_matvec(pn: PackedNDFT, x):
    """y = f^2 (mean_w ksum_w(x) + mu x) on the streamed packed kernels."""
    return packed_ndft_matvec_batch(pn, x[None])[0]


def packed_ndft_grad_matvec_batch(pn: PackedNDFT, Xb):
    """Batched (nv, 3, n) gradient matvecs; K and dK/dl share one pass."""
    k_acc, l_acc = _packed_sets(pn, Xb, ["w", "dw_l"])
    return _grad_rows(pn.params, k_acc, l_acc, Xb, pn.n_windows)


def packed_ndft_grad_matvec(pn: PackedNDFT, x):
    """(3, n) gradient matvec; K and dK/dl share one table stream."""
    return packed_ndft_grad_matvec_batch(pn, x[None])[0]


# --- fused (phase-regenerating) engine ---------------------------------------------

def _fused_sums(plan: AdditiveFastsumPlan, Xb, families, phase_gen):
    """Per family the (nv, n) window sums on the regenerating kernels: one
    adjoint and one forward launch for all rows and families."""
    lay = _packed_layout(plan)
    P = _nmodes(plan.groups[0][2][0].N)
    kw = dict(P=P, pairs=lay.pairs, singles=lay.singles, phase_gen=phase_gen)
    return _layout_sums(lay, Xb, families, lambda V: _two_pass(
        lay, P, V, families,
        lambda A: packed_adjoint_regen(lay.xT, A, **kw),
        lambda G2, G1: packed_forward_regen(lay.xT, G2, G1, **kw)))


def additive_fastsum_matvec_fused_batch(plan: AdditiveFastsumPlan, Xb, *,
                                        phase_gen: str = "doubling"):
    """Batched y_r = K x_r for the rows of Xb (nv, n) on the fused path:
    the phases are regenerated in the kernels from the coordinates (no
    table), and all rows share one kernel pass."""
    p = plan.params
    (acc,) = _fused_sums(plan, Xb, ["w"], phase_gen)
    return p.f * p.f * (acc / plan.n_windows + p.mu * Xb)


def additive_fastsum_matvec_fused(plan: AdditiveFastsumPlan, x, *, phase_gen: str = "doubling"):
    """Additive matvec on the phase-regenerating kernels (ref
    additive_fastsum_matvec_fused); 3-D windows on the table path.  Matches
    additive_fastsum_matvec to float32 roundoff."""
    return additive_fastsum_matvec_fused_batch(plan, x[None], phase_gen=phase_gen)[0]


def additive_fastsum_grad_matvec_fused_batch(plan: AdditiveFastsumPlan, Xb, *,
                                             phase_gen: str = "doubling"):
    """Batched (nv, 3, n) gradient matvecs on the fused path; K and dK/dl
    of all rows share one kernel pass."""
    k_acc, l_acc = _fused_sums(plan, Xb, ["w", "dw_l"], phase_gen)
    return _grad_rows(plan.params, k_acc, l_acc, Xb, plan.n_windows)


def additive_fastsum_grad_matvec_fused(plan: AdditiveFastsumPlan, x, *,
                                       phase_gen: str = "doubling"):
    """(3, n) gradient matvec on the fused path (ref
    additive_fastsum_grad_matvec_fused)."""
    return additive_fastsum_grad_matvec_fused_batch(plan, x[None], phase_gen=phase_gen)[0]
