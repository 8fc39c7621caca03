"""Cell-sorted grid of a point set (port of ops/cellgrid.py).

Points are binned to a uniform cell grid (pitch h) over their bounding box
and sorted cell-major on the host; every pair of points at most h apart
then lies in one cell or in two neighbouring ones, among the 3^d neighbour
offsets.  The pitch is the radius of the stream engine's near-field
(ops/fastsum.additive_nearfield_stencil_direct), so `build_cell_grid` is a
line-for-line copy of the JAX host code: both packages bin the same points
into the same grid.

Ported is what that near-field uses (the uniform grid, the pad map from
user order to cell slots and the neighbour slices) and the quantile
binning with which the AFN plan cell-sorts its Schur points
(preconds/afn.py).  The JAX package's dense stencil layout
(`StencilMatrix`, `stencil_matvec`, `stencil_transpose`, `stencil_embed`)
is not ported: it exists to avoid gathers on the TPU, and the port applies
the same sparse matrices as padded ELL.  Dimensions d = 1, 2, 3.
"""

import itertools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch


class CellGrid(NamedTuple):
    """Host-side cell decomposition of a point set (d <= 3).

    Sorted order: points sorted by row-major cell id; `perm[j]` = original
    index of the j-th sorted point.
    """

    shape: tuple            # cells per dim, e.g. (ncy, ncx)
    c: int                  # cell capacity (max occupancy)
    n: int
    d: int
    perm: np.ndarray        # (n,) sorted position -> original index
    inv_perm: np.ndarray    # (n,) original index -> sorted position
    cell_of: np.ndarray     # (n,) SORTED point -> flat cell id
    rank_of: np.ndarray     # (n,) SORTED point -> slot within cell
    starts: np.ndarray      # (ncells + 1,) cell start offsets in sorted order
    lo: np.ndarray          # (d,) box lower corner
    h: float                # cell pitch (uniform binning; nan for quantile)
    edges: Optional[tuple] = None   # per-axis bin edges (quantile binning)

    @property
    def ncells(self):
        return int(np.prod(self.shape))

    @property
    def noffs(self):
        return 3 ** self.d


def build_cell_grid(x, h: Optional[float] = None, *,
                    target_occupancy: float = 12.0,
                    max_capacity_factor: float = 4.0,
                    min_h: Optional[float] = None,
                    binning: str = "uniform") -> Optional[CellGrid]:
    """Bin points (host numpy, (n, d), d <= 3) into a cell grid.

    binning='uniform': pitch h (default sized for ~target_occupancy points
    a cell; min_h raises it).  binning='quantile': per-axis equal-mass bin
    edges, for densities far from uniform (a PCA projection of high-d data).
    Returns None when the layout degenerates (the fullest cell far above the
    expected occupancy: clustered or duplicate-heavy data); callers then
    keep ELL or the unsorted order."""
    x = np.asarray(x)
    n, d = x.shape
    if d > 3 or n == 0:
        return None
    lo = x.min(axis=0)
    hi = x.max(axis=0)
    ext = np.maximum(hi - lo, 1e-12)
    edges = None
    if binning == "quantile":
        nb = max(1, int(round((n / target_occupancy) ** (1.0 / d))))
        shape = (nb,) * d
        idx = np.empty((n, d), np.int64)
        edges = []
        for j in range(d):
            e = np.maximum.accumulate(np.quantile(x[:, j], np.linspace(0.0, 1.0, nb + 1)))
            edges.append(e)
            idx[:, j] = np.clip(np.searchsorted(e[1:-1], x[:, j], "right"), 0, nb - 1)
        edges = tuple(edges)
        h = float("nan")
    elif binning == "uniform":
        if h is None:
            vol = float(np.prod(ext))
            h = (vol * target_occupancy / n) ** (1.0 / d)
        if min_h is not None:
            h = max(h, float(min_h))
        h = float(max(h, 1e-12))
        shape = tuple(min(int(np.ceil(e / h)) + 1, 2 ** 15) for e in ext)
        idx = np.minimum((x - lo[None, :]) / h,
                         np.asarray(shape)[None, :] - 1).astype(np.int64)
    else:
        raise ValueError(f"unknown binning {binning!r}")
    flat = idx[:, 0]
    for j in range(1, d):
        flat = flat * shape[j] + idx[:, j]
    order = np.argsort(flat, kind="stable")
    cell_sorted = flat[order]
    ncells = int(np.prod(shape))
    counts = np.bincount(cell_sorted, minlength=ncells)
    c = int(counts.max()) if counts.size else 1
    # capacity guard: clustered or duplicate data concentrates far above the
    # target occupancy and the padded layout degenerates
    expected_occ = target_occupancy if binning == "quantile" else n * h ** d / float(np.prod(ext))
    if c > max_capacity_factor * max(expected_occ, 1.0):
        return None
    starts = np.zeros(ncells + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    rank = np.arange(n) - starts[cell_sorted]
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    return CellGrid(
        shape=shape, c=c, n=n, d=d,
        perm=order.astype(np.int32), inv_perm=inv.astype(np.int32),
        cell_of=cell_sorted.astype(np.int32), rank_of=rank.astype(np.int32),
        starts=starts.astype(np.int32), lo=lo, h=h, edges=edges,
    )


@dataclass
class CellGridDev:
    """Index tensors of a grid on one device."""

    shape: tuple
    c: int
    n: int
    d: int
    starts: torch.Tensor       # (ncells,) cell start offsets in sorted order
    padmask: torch.Tensor      # (ncells, c) valid-slot mask
    pad_src_u: torch.Tensor    # (ncells, c) user id feeding each slot (clamped on pads)

    @property
    def ncells(self):
        return self.starts.shape[0]

    @property
    def noffs(self):
        return 3 ** self.d


def to_device(grid: CellGrid, device=None) -> CellGridDev:
    n, c = grid.n, grid.c
    counts = grid.starts[1:] - grid.starts[:-1]
    padmask = np.arange(c)[None, :] < counts[:, None]
    slot_src = np.minimum(grid.starts[:-1][:, None] + np.arange(c)[None, :], n - 1)

    def t(a, dtype=torch.int64):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    return CellGridDev(
        shape=tuple(grid.shape), c=c, n=n, d=grid.d,
        starts=t(grid.starts[:-1]), padmask=t(padmask, torch.bool),
        pad_src_u=t(grid.perm[slot_src]),
    )


def _offsets(d: int):
    """The 3^d stencil offsets in row-major order, each in {-1, 0, 1}^d."""
    return list(itertools.product((-1, 0, 1), repeat=d))


def stencil_neighbors(dev: CellGridDev, padded):
    """Padded cells (ncells, c) -> (ncells, 3^d * c) neighbours: shifted
    slices of the spatially reshaped tensor; out-of-grid neighbours read
    zero."""
    c = dev.c
    xp = padded.new_zeros(tuple(s + 2 for s in dev.shape) + (c,))
    xp[tuple(slice(1, 1 + s) for s in dev.shape)] = padded.reshape(*dev.shape, c)
    views = [xp[tuple(slice(1 + o, 1 + o + s) for o, s in zip(off, dev.shape))]
             for off in _offsets(dev.d)]
    return torch.cat(views, dim=dev.d).reshape(dev.ncells, dev.noffs * c)
