"""Fourier-accelerated kernel matvecs, "fastsum" (port of ops/fastsum.py).

K x ~= f^2 (Re[NDFT2(b * NDFT1(x))] + mu x) with exact separable
nonequispaced DFTs over a folded mode space (ref SRC/external/nfft_interface.c
and the NFFT3 fastsum engine):

1. Geometry, once per dataset (nfft_interface.c:150-213): center by the mean,
   scale so the radius lies in [1/8, 1/4], and tabulate cos/sin(2 pi p x)
   for the folded modes p = 0..N/2.
2. Coefficients, per hyperparameters: the kernel sampled on an oversampled
   torus grid, FFT, central N modes, folded over the sign patterns.
3. Apply: adjoint NDFT (points -> mode tensor), combine with the folded
   weights, forward NDFT (mode tensor -> points).

This port covers windows of one or two features, without the near-field
correction.  Two engines apply the additive operator:

- the TABLE engine (`additive_fastsum_matvec`): torch products on the
  per-window tables;
- the STREAM engine (`packed_ndft_*`): one phase table for all windows,
  streamed through the two CUDA kernels of ops/packed_ndft.py (their plain
  torch versions on CPU tensors).
"""

import itertools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .kernels import BASE_KERNELS, KernelParams
from .packed_ndft import pack_phase_table, packed_adjoint, packed_forward


def _unsupported_d(d):
    raise NotImplementedError(
        f"the torch fastsum supports windows of 1 or 2 features (got {d}); "
        "3-feature windows are not ported yet"
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
    if d > 2:
        _unsupported_d(d)
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
    parity-folded weights w / dw_l, (nS,) + (P,)*d."""

    N: int
    d: int
    kind: str
    geom: FastsumGeometry
    b: torch.Tensor
    db_l: torch.Tensor
    w: torch.Tensor
    dw_l: torch.Tensor
    params: KernelParams


# Parity folding: K_ij = sum_k b_k cos(2 pi k.D) folds k -> |k| onto one
# weight tensor per even-parity set S of dims (see the JAX module).
_EVEN_SETS = {1: [()], 2: [(), (0, 1)]}


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
            A = torch.as_tensor(A1 if j in S else A0, dtype=b.dtype, device=b.device)
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


def fastsum_coeffs(kind: str, params: KernelParams, geom: FastsumGeometry, *,
                   oversample: int = 2) -> FastsumPlan:
    """Sample the scaled kernel on the (oversample*N)^d torus grid, FFT, and
    keep the central N modes per dim (fastsum's anti-aliasing grid,
    nfft_interface.c:18-27)."""
    N, d = geom.N, geom.d
    Nos = int(oversample) * N
    dtype = geom.x.dtype
    r2_true = _torus_grid_r2(Nos, d, dtype, geom.x.device) / (geom.scale * geom.scale)
    k_samp, dk_dl_samp = BASE_KERNELS[kind](r2_true, params.l)

    def coeffs(samp):
        bs = torch.fft.fftshift(torch.fft.fftn(samp)).real.to(dtype) / (Nos**d)
        return _central_modes(bs, N, d)

    b = coeffs(k_samp)
    db_l = coeffs(dk_dl_samp)
    return FastsumPlan(N=N, d=d, kind=kind, geom=geom, b=b, db_l=db_l,
                       w=fold_coeffs(b, N, d), dw_l=fold_coeffs(db_l, N, d),
                       params=params)


# --- folded apply ------------------------------------------------------------

def _tmat(A, B, out_dtype):
    """Phase-table product: exact in out_dtype, or with narrow (bf16) tables
    the operands rounded to the table dtype and accumulated in out_dtype."""
    if A.dtype == out_dtype and B.dtype == out_dtype:
        return A @ B
    return A.to(out_dtype) @ B.to(A.dtype).to(out_dtype)


def _folded_adjoint(Tcs, alpha):
    """Block tensor A_t[p] = sum_i alpha_i prod_d t_d(2 pi p_d x_id), (2P,)*d."""
    d = Tcs.shape[0]
    a = alpha.to(Tcs.dtype)
    if d == 1:
        return _tmat(Tcs[0].T, a, alpha.dtype)
    if d == 2:
        return _tmat((Tcs[0] * a[:, None]).T, Tcs[1], alpha.dtype)
    _unsupported_d(d)


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
    if d == 1:
        return _tmat(Tcs[0], B, B.dtype)
    if d == 2:
        return torch.sum(_tmat(Tcs[0], B, B.dtype) * Tcs[1].to(B.dtype), dim=1)
    _unsupported_d(d)


def _folded_apply_multi(Tcs, W_list, x, *, compensated: bool = False):
    """One adjoint, one forward per folded weight stack (shared NDFT1)."""
    if compensated:
        raise NotImplementedError("the compensated adjoint is not ported yet")
    d = Tcs.shape[0]
    A = _folded_adjoint(Tcs, x)
    return [_folded_forward(Tcs, _folded_combine(W, A, d)) for W in W_list]


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
        if dw > 2:
            _unsupported_d(dw)
        geos = [fastsum_geometry(X[:, feats], N, table_dtype=table_dtype)
                for _, feats in members]
        groups.append((dw, tuple(w for w, _ in members), geos))
    return AdditiveFastsumGeometry(n_windows=windows.shape[0], groups=tuple(groups))


class AdditiveFastsumPlan(NamedTuple):
    n_windows: int
    groups: tuple           # (dw, window_ids, [FastsumPlan per window])
    params: KernelParams


def additive_fastsum_coeffs(kind: str, params: KernelParams,
                            geom: AdditiveFastsumGeometry, *, oversample: int = 2,
                            nearfield_lfil: int = 0) -> AdditiveFastsumPlan:
    if nearfield_lfil:
        raise NotImplementedError("the fastsum near-field correction is not ported yet")
    groups = tuple(
        (dw, order, [fastsum_coeffs(kind, params, g, oversample=oversample) for g in geos])
        for dw, order, geos in geom.groups
    )
    return AdditiveFastsumPlan(n_windows=geom.n_windows, groups=groups, params=params)


def additive_fastsum_build(kind, params, X, windows, N: int = 32, *,
                           table_dtype=None, oversample: int = 2, nearfield_lfil: int = 0):
    return additive_fastsum_coeffs(
        kind, params, additive_fastsum_geometry(X, windows, N, table_dtype=table_dtype),
        oversample=oversample, nearfield_lfil=nearfield_lfil,
    )


def _window_sums(plan: AdditiveFastsumPlan, x, weights, compensated):
    """Per weight family, the window-summed ksum(x) (no f^2/mu)."""
    accs = [torch.zeros_like(x) for _ in weights]
    for _dw, _order, plans in plan.groups:
        parts = [
            _folded_apply_multi(pl.geom.Tcs, [getattr(pl, w) for w in weights], x,
                                compensated=compensated)
            for pl in plans
        ]
        for s in range(len(weights)):
            accs[s] = accs[s] + torch.sum(torch.stack([p[s] for p in parts]), dim=0)
    return accs


def additive_fastsum_matvec(plan: AdditiveFastsumPlan, x, *, compensated: bool = False):
    """y = f^2 (mean_w ksum_w(x) + mu x) -- ref nfft_interface.c:796-817."""
    p = plan.params
    (acc,) = _window_sums(plan, x, ["w"], compensated)
    return p.f * p.f * (acc / plan.n_windows + p.mu * x)


def _grad_rows(params, k_acc, l_acc, x, n_windows, dim):
    f2 = params.f * params.f
    y_f = 2.0 * params.f * (k_acc / n_windows + params.mu * x)
    return torch.stack([y_f, f2 * (l_acc / n_windows), f2 * x], dim=dim)


def additive_fastsum_grad_matvec(plan: AdditiveFastsumPlan, x, *, compensated: bool = False):
    """(3, n) stacked dK_j x -- ref nfft_interface.c:819-840."""
    k_acc, l_acc = _window_sums(plan, x, ["w", "dw_l"], compensated)
    return _grad_rows(plan.params, k_acc, l_acc, x, plan.n_windows, 0)


# --- streamed packed-NDFT plan -------------------------------------------------

def _packed_layout(plan: AdditiveFastsumPlan):
    """Flatten the windows into the packed layout: xT (Dtot, n) coordinate
    rows, pairs / singles row indices, and the per-window folded weights in
    pairs / singles order."""
    rows, pairs, singles = [], [], []
    w2, dw2, w1, dw1 = [], [], [], []
    for dw, _order, plans in plan.groups:
        for pl in plans:
            if dw == 2:
                pairs.append((len(rows), len(rows) + 1))
                rows += [pl.geom.x[:, 0], pl.geom.x[:, 1]]
                w2.append(pl.w)
                dw2.append(pl.dw_l)
            else:
                singles.append(len(rows))
                rows.append(pl.geom.x[:, 0])
                w1.append(pl.w)
                dw1.append(pl.dw_l)
    return torch.stack(rows), tuple(pairs), tuple(singles), w2, dw2, w1, dw1


@dataclass
class PackedNDFT:
    """Streamed-table plan for the packed kernels, built per (dataset, params).

    Tp is ONE phase table (Dtot, 2P, n) for all windows' coordinate rows
    (ops/packed_ndft.pack_phase_table).  The unpaired Nyquist mode is trimmed
    (P = N/2 instead of N/2 + 1, the JAX default edge_trim=True), so 2P = N.
    """

    P: int
    n: int
    n_windows: int
    pairs: tuple
    singles: tuple
    Tp: torch.Tensor
    w2: tuple
    dw2: tuple
    w1: tuple
    dw1: tuple
    params: KernelParams


def packed_ndft_plan(plan: AdditiveFastsumPlan, *, table_dtype=None) -> PackedNDFT:
    xT, pairs, singles, w2, dw2, w1, dw1 = _packed_layout(plan)
    P = plan.groups[0][2][0].N // 2
    return PackedNDFT(
        P=P, n=xT.shape[1], n_windows=plan.n_windows, pairs=pairs, singles=singles,
        Tp=pack_phase_table(xT, P, table_dtype=table_dtype),
        w2=tuple(W[:, :P, :P] for W in w2), dw2=tuple(W[:, :P, :P] for W in dw2),
        w1=tuple(W[:, :P] for W in w1), dw1=tuple(W[:, :P] for W in dw1),
        params=plan.params,
    )


def _packed_sets(pn: PackedNDFT, Xb, families):
    """One adjoint pass for the rows of Xb (nv, n), then ONE forward pass over
    nv * len(families) weight sets in (row, family) order.  Returns
    (nv, len(families), n) window sums."""
    nv = Xb.shape[0]
    A2, A1 = packed_adjoint(pn.Tp, Xb.contiguous(), pairs=pn.pairs, singles=pn.singles)
    fam2 = [pn.w2 if f == "w" else pn.dw2 for f in families]
    fam1 = [pn.w1 if f == "w" else pn.dw1 for f in families]
    G2 = [torch.stack([_folded_combine(W[i], A2[i], 2) for W in fam2], dim=1)
          .reshape(nv * len(families), 2 * pn.P, 2 * pn.P) for i in range(len(pn.pairs))]
    G1 = [torch.stack([_folded_combine(W[i], A1[i], 1) for W in fam1], dim=1)
          .reshape(nv * len(families), 2 * pn.P) for i in range(len(pn.singles))]
    ys = packed_forward(pn.Tp, G2, G1, pairs=pn.pairs, singles=pn.singles)
    return torch.stack(ys).reshape(nv, len(families), pn.n)


def packed_ndft_matvec_batch(pn: PackedNDFT, Xb):
    """Batched y_r = K x_r for the rows of Xb (nv, n): all rows share ONE
    table stream per kernel pass (the SLQ probe batches)."""
    p = pn.params
    acc = _packed_sets(pn, Xb, ["w"])[:, 0]
    return p.f * p.f * (acc / pn.n_windows + p.mu * Xb)


def packed_ndft_matvec(pn: PackedNDFT, x):
    """y = f^2 (mean_w ksum_w(x) + mu x) on the streamed packed kernels."""
    return packed_ndft_matvec_batch(pn, x[None])[0]


def packed_ndft_grad_matvec_batch(pn: PackedNDFT, Xb):
    """Batched (nv, 3, n) gradient matvecs; K and dK/dl share one pass."""
    sums = _packed_sets(pn, Xb, ["w", "dw_l"])
    return _grad_rows(pn.params, sums[:, 0], sums[:, 1], Xb, pn.n_windows, 1)


def packed_ndft_grad_matvec(pn: PackedNDFT, x):
    """(3, n) gradient matvec; K and dK/dl share one table stream."""
    return packed_ndft_grad_matvec_batch(pn, x[None])[0]
