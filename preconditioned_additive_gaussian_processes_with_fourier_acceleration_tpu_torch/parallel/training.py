"""Sharded GP training: the multi-device train step (port of
parallel/training.py).

One process per device (parallel/mesh.py): X, y and the probe matrix are
row-sharded (`shard_training_data`), every Krylov dot product and norm is a
local partial plus an all_reduce (the `group` of the solvers and of
models/gp.gp_loss), and the operator maps the rank's rows to the rank's
rows.  Two operator engines:

  'stream' -- the packed-table kernels of ops/packed_ndft.py on each rank's
              own phase table, one all_reduce of the mode tensors a pass
              (parallel/sharded.sharded_stream_ops); 1-D / 2-D windows;
  'table'  -- the folded-NDFT products in torch, one all_reduce of the
              mode tensors a window group (sharded.sharded_table_ops);
  'auto'   -- 'stream' on CUDA tensors with a mesh, 'table' otherwise.

The operator options follow the JAX package's: oversampled coefficients,
the matern12 near-field on a lower-triangular KNN pattern (found once, on
all points; its column indices stay global and the transpose reaches other
ranks by a reduce-scatter), and random Nystrom landmarks.

The preconditioner (Nystrom or AFN) is NOT row-sharded: every rank builds it
on all points with the single-device set-ups, and an adapter all-gathers the
vector or probe rows, applies it whole and keeps the rank's rows; its logdet
and traces are the same on every rank.  These are the numbers GSPMD gives
the JAX package's replicated-landmark terms, at the cost of a replicated
factorization on every rank.
"""

from typing import Optional

import numpy as np
import torch

from ..models.adam import AdamState, adam_init, adam_step
from ..models.gp import GPConfig, gp_loss
from ..models.problem import _ops
from ..models.transforms import transform_inverse
from ..ops import fastsum as fs
from ..ops.kernels import KernelParams, make_windows
from ..preconds.afn import afn_plan as build_afn_plan
from ..preconds.afn import afn_setup_from_plan
from ..preconds.nystrom import nystrom_setup
from ..solvers.lanczos import rademacher_probes
from ..utils.datasets import rand_perm
from .mesh import PointsMesh, make_mesh
from .sharded import shard_plan, shard_points, sharded_stream_ops, sharded_table_ops


def shard_training_data(mesh: PointsMesh, X, y, probes):
    """This rank's rows of X (n, d) and y (n,) and columns of the probes
    (nvecs, n), on the mesh's device."""
    return shard_points(mesh, X, y) + [shard_points(mesh, probes, axis=1)]


class GatheredPrecond:
    """A preconditioner built on all points, applied to row shards: solve and
    dvp all-gather the vector or probe rows, apply it whole and keep the
    rank's rows; logdet and trace are the whole preconditioner's."""

    def __init__(self, precond, mesh: PointsMesh, rows: slice):
        self.precond, self.mesh, self.rows = precond, mesh, rows

    def solve(self, r):
        return self.precond.solve(self.mesh.all_gather(r, dim=-1))[..., self.rows]

    def dvp(self, z):
        return self.precond.dvp(self.mesh.all_gather(z, dim=-1))[..., self.rows]

    def logdet(self):
        return self.precond.logdet()

    def trace(self):
        return self.precond.trace()


def make_sharded_train_step(
    windows,
    *,
    kernel: str = "gaussian",
    precond: str = "nystrom",
    nys_rank: int = 64,
    slq_its: int = 10,
    nvecs: int = 10,
    fastsum_N: int = 32,
    oversample: int = 2,
    nearfield_lfil: Optional[int] = None,
    engine: str = "auto",
    table_dtype=None,
    tol: float = 1e-6,
    adam_alpha: float = 0.01,
    seed: int = 0,
    mesh: Optional[PointsMesh] = None,
    afn_plan=None,
    landmarks=None,
):
    """Returns train_step(state, X, y, probes) -> (state, loss, grad).

    With a mesh, X, y and probes are the rank's shards (shard_training_data)
    and the loss and gradient come out the same on every rank; with
    mesh=None they are whole and the step runs on one device (engine
    'stream' then runs the single-device packed engine, where the JAX
    package asks for a mesh).  precond: 'nystrom' (landmarks: the indices,
    default the first nys_rank of a permutation drawn from a torch generator
    seeded with `seed`; the JAX package draws rand_perm(PRNGKey(seed)),
    which tests hand over) or 'afn' (afn_plan: a plan from preconds.afn, or
    a JAX plan through models/problem.state_from_numpy).

    What depends on the points alone -- X gathered from the ranks, the
    fastsum geometry, the KNN near-field pattern -- is made at the first
    step and kept while the same X tensor comes back unmodified."""
    cfg = GPConfig(kind=kernel, maxits=slq_its, nvecs=nvecs, tol=tol)
    if engine not in ("auto", "stream", "table"):
        raise ValueError(f"unknown engine {engine}")
    if precond not in ("nystrom", "afn"):
        raise ValueError(f"unknown precond {precond}")
    if precond == "afn" and afn_plan is None:
        raise ValueError("precond='afn' needs afn_plan (preconds.afn.afn_plan)")
    warr = windows if isinstance(windows, torch.Tensor) else make_windows(windows)
    data = {}

    def data_setup(X):
        if data.get("src") is not X or data["version"] != X._version:
            X_full = X if mesh is None else mesh.all_gather(X, dim=0)
            n = X_full.shape[0]
            geom = fs.additive_fastsum_geometry(X_full, warr, N=fastsum_N)
            # per-group lfil: groups whose resolved lfil is 0 keep no pattern,
            # and nearfield_lfil=0 in the coefficients adds none for them
            pats = fs.additive_nearfield_patterns(kernel, geom, nearfield_lfil)
            perm = (torch.as_tensor(landmarks) if landmarks is not None
                    else rand_perm(torch.Generator().manual_seed(seed), n, nys_rank))
            data.clear()
            data.update(src=X, version=X._version, X=X_full, geom=geom, rows=slice(None) if mesh is None else mesh.rows(n),
                        pats=None if all(p is None for p in pats) else pats,
                        perm=perm.to(X.device))
        return data

    def loss_step(raw, X, y, probes):
        d = data_setup(X)
        use_stream = engine == "stream" or (engine == "auto" and mesh is not None and X.is_cuda)

        def build_ops(params):
            plan = fs.additive_fastsum_coeffs(kernel, params, d["geom"], oversample=oversample,
                                              nearfield_lfil=0, nf_patterns=d["pats"])
            if mesh is not None:
                plan = shard_plan(plan, d["rows"])
                if use_stream:
                    return sharded_stream_ops(mesh, plan, table_dtype=table_dtype)
                return sharded_table_ops(mesh, plan)
            if use_stream:
                pn = fs.packed_ndft_plan(plan, table_dtype=table_dtype)
                return _ops(lambda V: fs.packed_ndft_matvec_batch(pn, V),
                            lambda V: fs.packed_ndft_grad_matvec_batch(pn, V))
            return (lambda v: fs.additive_fastsum_matvec(plan, v),
                    lambda v: fs.additive_fastsum_grad_matvec(plan, v))

        def precond_setup(params):
            if precond == "afn":
                pre = afn_setup_from_plan(kernel, params, d["X"], afn_plan, require_grad=True, windows=warr)
            else:
                pre = nystrom_setup(kernel, params, d["X"], d["perm"], nys_rank, require_grad=True,
                                    windows=warr)
            return pre if mesh is None else GatheredPrecond(pre, mesh, d["rows"])

        res = gp_loss(raw, y, build_ops, probes, cfg, precond_setup, group=mesh)
        return res.loss, res.grad

    def train_step(state: AdamState, X, y, probes):
        loss, grad = loss_step(state.x, X, y, probes)
        return adam_step(state, grad, alpha=adam_alpha), loss, grad

    return train_step


def train_sharded(
    X, y, *, windows, n_devices: Optional[int] = None, init=(1.0, 1.0, 0.1),
    adam_maxits: int = 100, seed: int = 0, precond: str = "nystrom",
    mesh: Optional[PointsMesh] = None, device=None, **step_kwargs,
):
    """Convenience loop, run by every rank of the world: mesh (make_mesh
    over n_devices, unless given), sharding, Adam iterations.  X and y are
    all points on every rank (tensors, or numpy arrays keeping their dtype);
    the probes (torch generator seeded with `seed`) and the AFN plan (with
    precond='afn', made on all points at `init`) come out the same on every
    rank.  Returns (Adam state, losses)."""
    if mesh is None:
        mesh = make_mesh(n_devices, device=device)
    X, y = (t if isinstance(t, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(t)) for t in (X, y))
    X = X.to(mesh.device)
    y = y.to(device=mesh.device, dtype=X.dtype)
    probes = rademacher_probes(torch.Generator().manual_seed(seed), step_kwargs.get("nvecs", 10),
                               X.shape[0], X.dtype)
    afn_pl = None
    if precond == "afn":
        afn_pl = build_afn_plan(step_kwargs.get("kernel", "gaussian"),
                                KernelParams.make(*init, dtype=X.dtype, device=X.device), X,
                                maxrank=step_kwargs.get("nys_rank", 64),
                                generator=torch.Generator(device=X.device).manual_seed(seed))
    Xs, ys, ps = shard_training_data(mesh, X, y, probes)
    step = make_sharded_train_step(windows, mesh=mesh, precond=precond, afn_plan=afn_pl, seed=seed,
                                   **step_kwargs)
    state = adam_init(transform_inverse("softplus", torch.as_tensor(init, dtype=X.dtype, device=X.device)))
    losses = []
    for _ in range(adam_maxits):
        state, loss, _grad = step(state, Xs, ys, ps)
        losses.append(float(loss))
    return state, losses
