"""Row-sharded building blocks (port of parallel/sharded.py).

Each function maps this rank's shard to this rank's shard, as the bodies of
the JAX package's shard_map calls do: the inputs are the rank's contiguous
block of rows (`PointsMesh.rows`) and every collective is written out.

- dense kernel matvec: K's row block (n/P, n), x gathered -> local GEMV,
  output row-sharded;
- dot products: local partial + all_reduce over the points axis (the
  PCG/Lanczos critical path);
- NDFT adjoint: per-shard phase products, then an all_reduce of the small
  mode tensor (O(N^d) values, independent of n); the forward pass is local;
- near-field (ELL) correction across shards: a gather from the all-gathered
  x, and for a lower-triangular pattern the transpose's scatter into a
  global accumulator, reduce-scattered back to the rows;
- FSAI rows and the Nystrom factor on the rank's rows (a TSQR thin SVD);
- the stream engine: each rank streams its own packed phase table through
  the table kernels of ops/packed_ndft.py, with one all_reduce of the mode
  tensors per pass for all right-hand sides.

Plans are built on all points and cut to the rank's rows with
`shard_plan`: the near-field's column indices stay global.
"""

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..ops import fastsum as fs
from ..ops.kernels import KernelParams, additive_kernel_matrix, kernel_matrix
from ..ops.matops import ell_matvec_batch, ell_rmatvec_batch, stable_chol, tril_solve
from ..ops.packed_ndft import packed_adjoint, packed_forward
from ..models.problem import _ops
from ..preconds.fsai import FsaiPrecond, fsai_rows, kernel_blocks, transpose_pattern
from ..preconds.nystrom import NystromPrecond
from .mesh import PointsMesh


def shard_points(mesh: PointsMesh, *arrays, axis: int = 0):
    """This rank's block of each array's points dimension `axis`, as a tensor
    on the mesh's device (numpy arrays keep their dtype)."""
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        ax = axis % t.ndim
        block = t[(slice(None),) * ax + (mesh.rows(t.shape[ax]),)]
        out.append(block.to(mesh.device).contiguous())
    return out if len(out) > 1 else out[0]


def sharded_dot(mesh: PointsMesh):
    """dot(a, b) of two row-sharded vectors: local partial, then all_reduce."""

    def dot(a, b):
        return mesh.psum(torch.dot(a, b))

    return dot


def sharded_matvec_dense(mesh: PointsMesh, K_sharded):
    """matvec closure for this rank's rows of a dense kernel matrix (n/P, n).

    x arrives row-sharded; an all-gather makes the full vector (n values,
    small beside the n^2/P block), the local GEMV runs, and the output stays
    row-sharded."""

    def mv(x):
        return K_sharded @ mesh.all_gather(x, dim=-1)

    return mv


def sharded_ndft_adjoint(mesh: PointsMesh):
    """Folded NDFT adjoint of row-sharded phase tables Tcs (d, n/P, 2P) and
    weights alpha (n/P,) (or rows (nv, n/P)): the local phase products
    (ops/fastsum._folded_adjoint), then an all_reduce of the (2P,)^d mode
    tensor -- communication O(N^d), independent of n."""

    def adjoint(Tcs, alpha):
        return mesh.psum(fs._folded_adjoint(Tcs, alpha))

    return adjoint


def _nearfield_local(idx_b, val_b, xb, xf, mesh: PointsMesh, sym: bool = False):
    """Cross-shard near-field ELL apply in the rank's frame.

    idx_b, val_b: the rank's rows (n/P, lfil) of the pattern (global column
    indices) and its values; xb: the rank's rows of x, (n/P,) or (nv, n/P);
    xf: x all-gathered, (n,) or (nv, n).

    sym=True (a symmetrized pattern): the rows are the full symmetric
    stencil, one gather from xf.  sym=False (lower-triangular, self in the
    last slot): y = (S + S' - diag S) x, the transpose's contributions
    scatter-added into a global (nv, n) accumulator that is reduce-scattered
    back to the rows -- one (n,)-vector reduce-scatter a right-hand side."""
    batched = xb.ndim == 2
    Xb, Xf = (xb, xf) if batched else (xb[None], xf[None])
    y = ell_matvec_batch(idx_b, val_b, Xf)
    if not sym:
        contrib = ell_rmatvec_batch(idx_b, val_b, Xb, n=Xf.shape[1])
        y = y + mesh.reduce_scatter(contrib, dim=-1) - val_b[:, -1] * Xb
    return y if batched else y[0]


def sharded_nearfield_matvec(mesh: PointsMesh, idx, val):
    """Standalone closure for the cross-shard near-field correction of a
    lower-triangular pattern: idx/val the rank's rows (n/P, lfil), x
    row-sharded.  See _nearfield_local."""

    def mv(x):
        return _nearfield_local(idx, val, x, mesh.all_gather(x, dim=-1), mesh)

    return mv


def sharded_fastsum_matvec(mesh: PointsMesh, plan: fs.FastsumPlan):
    """Folded fastsum matvec of one plan cut to the rank's rows (`shard_plan`).

    adjoint: local phase products + all_reduce of the mode tensor; combine:
    replicated (small); forward: local rows, no communication.  The
    near-field correction (matern12) adds one all-gather of x and, for a
    lower-triangular pattern, one reduce-scatter.  x: the rank's rows (n/P,)
    or (nv, n/P); the output has the same rows."""
    d, params = plan.d, plan.params

    def mv(x):
        A = mesh.psum(fs._folded_adjoint(plan.geom.Tcs, x))
        y = fs._folded_forward(plan.geom.Tcs, fs._folded_combine(plan.w, A, d))
        if plan.nf_val is not None:
            y = y + _nearfield_local(plan.nf_idx, plan.nf_val, x, mesh.all_gather(x, dim=-1), mesh,
                                     sym=plan.nf_sym)
        return params.f * params.f * (y + params.mu * x)

    return mv


def _modes_psum(mesh: PointsMesh, A2, A1):
    """One all_reduce of every window's mode tensors (lists of tensors)."""
    parts = list(A2) + list(A1)
    if not parts:
        return A2, A1
    flat = mesh.psum(torch.cat([a.reshape(-1) for a in parts]))
    out = [v.reshape(a.shape) for v, a in zip(torch.split(flat, [a.numel() for a in parts]), parts)]
    return out[:len(A2)], out[len(A2):]


def _sharded_window_sums(mesh: PointsMesh, groups, X, families):
    """Per weight family the (nv, n/P) window sums of additive groups cut to
    the rank's rows (no f^2/mu): per window group one all_reduce of its
    windows' mode tensors, local forwards, the cross-shard near-field."""
    accs = [torch.zeros_like(X) for _ in families]
    Xf = None
    for dw, _order, plans in groups:
        A = mesh.psum(torch.stack([fs._folded_adjoint(pl.geom.Tcs, X) for pl in plans]))
        for k, pl in enumerate(plans):
            for s, fam in enumerate(families):
                y = fs._folded_forward(pl.geom.Tcs, fs._folded_combine(getattr(pl, fam), A[k], dw))
                if pl.nf_val is not None:
                    if Xf is None:
                        Xf = mesh.all_gather(X, dim=-1)
                    nf_vals = pl.nf_val if fam == "w" else pl.nf_dval
                    y = y + _nearfield_local(pl.nf_idx, nf_vals, X, Xf, mesh, sym=pl.nf_sym)
                accs[s] = accs[s] + y
    return accs


def _batched_ops(params, n_windows, sums):
    """(matvec, dmatvec) on one vector or rows, from sums(Xb, families), the
    window sums of a batch (nv, n/P) per weight family."""
    def mv(V):
        (acc,) = sums(V, ["w"])
        return params.f * params.f * (acc / n_windows + params.mu * V)

    return _ops(mv, lambda V: fs._grad_rows(params, *sums(V, ["w", "dw_l"]), V, n_windows))


def sharded_table_ops(mesh: PointsMesh, plan: fs.AdditiveFastsumPlan):
    """(matvec, dmatvec) of an additive plan cut to the rank's rows on the
    table engine: every window group in the form of sharded_fastsum_matvec,
    one all_reduce of its windows' mode tensors a call (the weight families
    share it), every window dimension.  matvec maps (n/P,) or (nv, n/P) to the same shape, dmatvec
    to (3, n/P) or (nv, 3, n/P).  (The JAX package gets this engine from
    GSPMD on sharded inputs.)"""
    return _batched_ops(plan.params, plan.n_windows,
                        lambda V, fams: _sharded_window_sums(mesh, plan.groups, V, fams))


class FsaiRows(NamedTuple):
    """The rank's rows of an FSAI factor (sharded_fsai_setup): idx, mask and
    val (n/P, lfil), dval (3, n/P, lfil) or None, and the repaired-row count
    over all ranks."""

    idx: torch.Tensor
    mask: torch.Tensor
    val: torch.Tensor
    dval: Optional[torch.Tensor]
    breakdown: torch.Tensor

    def gather(self, mesh: PointsMesh) -> FsaiPrecond:
        """The whole factor on every rank, as fsai_setup returns it."""
        idx, mask, val = (mesh.all_gather(t, dim=0) for t in (self.idx, self.mask.to(torch.uint8), self.val))
        mask = mask.bool()
        dval = None if self.dval is None else mesh.all_gather(self.dval, dim=1)
        return FsaiPrecond(idx=idx, mask=mask, val=val, dval=dval, breakdown=self.breakdown,
                           pattern_t=transpose_pattern(idx, mask))


def sharded_fsai_setup(mesh: PointsMesh, kind: str, params: KernelParams, X, pattern, *,
                       require_grad: bool = False, windows=None) -> FsaiRows:
    """Row-sharded FSAI set-up: the kernel blocks and the batched row
    Cholesky factorizations of the rank's rows (rows are independent; the
    reference's OpenMP set-up loop, fsai.c:340-403).

    X: all points (a row's pattern reaches any global row); pattern: the
    rank's rows (idx, mask) of the KNN pattern.  The repaired-row count is
    summed over the ranks, which gives fsai_setup's count (the JAX package
    max-reduces its boolean flag)."""
    idx, mask = pattern
    blocks = kernel_blocks(kind, params, windows, require_grad)
    val, dval, bad = fsai_rows(lambda J: blocks(X[J]), idx, mask)
    return FsaiRows(idx=idx, mask=mask, val=val, dval=dval, breakdown=mesh.psum(bad))


@dataclasses.dataclass
class ShardedNystromPrecond(NystromPrecond):
    """A Nystrom factor whose U holds the rank's rows (sharded_nystrom_setup):
    the solve's k-projection U' r is all_reduced and the logdet counts all n
    points.  Solve and logdet only; no gradient terms."""

    mesh: Any = None

    @property
    def n(self):
        return self.mesh.n_global(self.U.shape[0])

    def solve(self, r):
        z = self.mesh.psum(r @ self.U)
        return r / self.eta + ((self.s - 1.0 / self.eta) * z) @ self.U.T


def _tsqr_svd(mesh: PointsMesh, Ufb):
    """Thin SVD of the row-sharded tall matrix whose rank holds the rows Ufb
    (n/P, k): (the rank's rows of U, sigma).  TSQR: a QR of the rank's rows,
    the ranks' R factors all-gathered (P k x k values), a QR of their stack
    and the SVD of its k x k R; U's rows are Q1 Q2_rank U_R."""
    Q1, R1 = torch.linalg.qr(Ufb)                             # (n/P, m), (m, k), m = min(n/P, k)
    Q2, R = torch.linalg.qr(mesh.all_gather(R1, dim=0))       # (P m, k'), (k', k)
    Ur, sigma, _ = torch.linalg.svd(R, full_matrices=False)
    m = R1.shape[0]
    return Q1 @ (Q2[mesh.rank * m:(mesh.rank + 1) * m] @ Ur), sigma


def sharded_nystrom_setup(mesh: PointsMesh, kind: str, params: KernelParams, X, Xk, *,
                          windows=None) -> ShardedNystromPrecond:
    """Row-sharded stabilized Nystrom set-up (solve / logdet).

    The reference's tall-factor SVD (nys.c:518-660) on row shards:
      K1 rows      : the rank's rectangular block K(X_b, Xk)
      L11          : replicated Cholesky of the k x k landmark block
      Uf = K1 L^-T : local triangular solves
      U, sigma     : the thin SVD of the sharded Uf by TSQR (_tsqr_svd):
                     one all_gather of the ranks' k x k R factors, the only
                     collective; U stays row-sharded
    X: the rank's rows (n/P, d); Xk (k, d): the landmark rows, replicated.

    The JAX package (parallel/sharded.py) eigendecomposes the Gram Uf' Uf
    instead, which squares Uf's condition number: in float32 at n = 1e6
    (scripts/torch_sharded_scale_demo.py's problem, on an NVIDIA H100) that
    preconditioner left Nystrom-FGMRES at relres 0.43 after 60 steps, where
    the tall SVD's reached 2.5e-3 (PERF.md).  Both give the same
    preconditioner in exact arithmetic."""
    noise_free = KernelParams(f=params.f, l=params.l, mu=torch.zeros_like(params.mu))
    if windows is None:
        build = lambda A, B: kernel_matrix(kind, noise_free, A, B)  # noqa: E731
    else:
        build = lambda A, B: additive_kernel_matrix(kind, noise_free, A, windows, B)  # noqa: E731
    L11, _ = stable_chol(build(Xk, Xk))
    Ufb = tril_solve(L11, build(X, Xk).T).T                  # (n/P, k)
    Ub, sigma = _tsqr_svd(mesh, Ufb)
    sigma2 = sigma * sigma
    f2 = params.f * params.f
    eta = params.mu * f2
    return ShardedNystromPrecond(perm=torch.arange(Ub.shape[1], device=X.device), U=Ub, s=1.0 / (sigma2 + eta),
                                 sigma2=sigma2, eta=eta, f2=f2, mesh=mesh)


# --- plans cut to the rank's rows ---------------------------------------------------
# Point axes are found by FIELD NAME (geom.x, geom.Tcs and nf_* carry points
# on their second-to-last axis): matching by `dimension == n` could cut a
# mode or table axis whose size happens to equal n.

POINT_FIELDS = frozenset({"x", "Tcs", "nf_idx", "nf_val", "nf_dval"})


def shard_plan(plan, rows: slice):
    """A fastsum geometry or plan (FastsumGeometry, FastsumPlan, their
    additive forms) with every point field cut to `rows` on its
    second-to-last axis; everything else, the near-field's global column
    indices included, as it is.  The counterpart of the JAX package's
    `_plan_specs`, which gives the same fields their PartitionSpecs."""

    def walk(obj, name=None):
        if isinstance(obj, torch.Tensor):
            if name in POINT_FIELDS and obj.ndim >= 2:
                return obj[(slice(None),) * (obj.ndim - 2) + (rows,)]
            return obj
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.replace(obj, **{f.name: walk(getattr(obj, f.name), f.name)
                                               for f in dataclasses.fields(obj) if f.init})
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            return obj._replace(**{f: walk(getattr(obj, f), f) for f in obj._fields})
        if isinstance(obj, (tuple, list)):
            return type(obj)(walk(o, name) for o in obj)
        return obj

    return walk(plan)


def sharded_stream_ops(mesh: PointsMesh, plan: fs.AdditiveFastsumPlan, *, table_dtype=None):
    """(matvec, dmatvec) on per-rank streamed packed tables.

    plan: an additive plan of 1-D / 2-D windows cut to the rank's rows
    (`shard_plan`).  The rank's packed phase table (its own points as
    columns, edge-trimmed modes, `table_dtype`) is built once here; every
    apply is then
      packed_adjoint (the table kernel, local) -> one all_reduce of all
      windows' mode tensors -> combine (replicated, small) ->
      packed_forward (local rows) [+ the cross-shard KNN near-field].
    A batch (nv, n/P) runs the kernels' multi-right-hand-side form: all
    probes share one table stream and one all_reduce a pass."""
    if any(dw == 3 for dw, _, _ in plan.groups):
        raise NotImplementedError("sharded_stream_ops supports 1-D/2-D windows (3-D windows take the "
                                  "table engine, sharded_table_ops)")
    pn = fs.packed_ndft_plan(plan, table_dtype=table_dtype)
    kw = dict(pairs=pn.pairs, singles=pn.singles)

    def sums(Xb, families):
        accs = list(torch.unbind(fs._two_pass(
            pn, Xb, families,
            lambda A: _modes_psum(mesh, *packed_adjoint(pn.Tp, A, **kw)),
            lambda G2, G1: packed_forward(pn.Tp, G2, G1, **kw)), dim=1))
        if pn.nf:
            Xf = mesh.all_gather(Xb, dim=-1)
            for s, fam in enumerate(families):
                for idx, val, dval in pn.nf:
                    accs[s] = accs[s] + _nearfield_local(idx, val if fam == "w" else dval, Xb, Xf, mesh,
                                                         sym=pn.nf_sym)
        return accs

    return _batched_ops(pn.params, pn.n_windows, sums)
