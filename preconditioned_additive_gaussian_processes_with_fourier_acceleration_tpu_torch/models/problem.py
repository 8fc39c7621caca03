"""High-level GP problem: kernel + operator + preconditioner + Adam loop
(port of models/problem.py, the training half).

Rebuild of SRC/optimizer/gp_problem.c: one object wires the kernel kind,
additive windows, the operator (exact dense or Fourier fastsum), the
preconditioner and the transform into a loss closure, and trains the
hyperparameters with Adam.  Prediction is not ported yet.
"""

import ast
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import fastsum as fs
from ..ops.kernels import make_windows
from ..preconds.nystrom import nystrom_setup
from ..solvers.lanczos import rademacher_probes
from ..utils.datasets import rand_perm
from .adam import adam_run
from .gp import GPConfig, gp_loss, make_dense_ops
from .transforms import transform_forward, transform_inverse

_SAVED_FIELDS = (
    "kernel", "operator", "precond", "transform", "rank", "lfil", "maxits", "nvecs",
    "tol", "fastsum_N", "fastsum_table_dtype", "fastsum_oversample",
    "fastsum_nearfield_lfil", "fastsum_fused", "fastsum_engine", "predict_operator", "seed",
)


class InjectedState(NamedTuple):
    raw_params: Optional[torch.Tensor]
    landmarks: Optional[torch.Tensor]
    probes: Optional[torch.Tensor]


def state_from_numpy(device, *, raw_params=None, landmarks=None, probes=None, dtype=None):
    """Turn numpy arrays drawn on the JAX side (raw hyperparameters, Nystrom
    landmark indices, the Rademacher probe matrix) into tensors on `device`,
    so both packages compute the same loss.  dtype applies to the float arrays
    (default: their own)."""
    def conv(a, is_index=False):
        if a is None:
            return None
        t = torch.from_numpy(np.array(a, copy=True))
        t = t.to(torch.int64) if is_index else (t.to(dtype) if dtype is not None else t)
        return t.to(device)

    return InjectedState(raw_params=conv(raw_params), landmarks=conv(landmarks, True),
                         probes=conv(probes))


def _stream_ops(pn):
    """(matvec, dmatvec) on the packed CUDA kernels; batches of rows go
    straight to the multi-RHS functions, which share one table stream."""
    def mv(v):
        return fs.packed_ndft_matvec(pn, v) if v.ndim == 1 else fs.packed_ndft_matvec_batch(pn, v)

    def dmv(v):
        return (fs.packed_ndft_grad_matvec(pn, v) if v.ndim == 1
                else fs.packed_ndft_grad_matvec_batch(pn, v))

    return mv, dmv


def _table_ops(plan):
    """(matvec, dmatvec) on the torch table engine; row batches loop."""
    def mv(v):
        if v.ndim == 1:
            return fs.additive_fastsum_matvec(plan, v)
        return torch.stack([fs.additive_fastsum_matvec(plan, r) for r in v])

    def dmv(v):
        if v.ndim == 1:
            return fs.additive_fastsum_grad_matvec(plan, v)
        return torch.stack([fs.additive_fastsum_grad_matvec(plan, r) for r in v])

    return mv, dmv


@dataclass
class GPProblem:
    """User-facing GP regression problem (ref gp_problem.h:20-75).

    kernel:   'gaussian' | 'matern32' | 'matern12'
    windows:  None (full kernel) or list of feature-index lists (additive)
    operator: 'dense' | 'fastsum' (fastsum: additive windows of 1-2 features)
    precond:  'none' | 'nystrom'

    fastsum_engine: 'stream' (the packed CUDA kernels; their plain torch
    versions on CPU tensors) | 'table' (torch products on per-window
    tables) | 'auto' (stream when X is a CUDA tensor, table on the CPU).
    fastsum_table_dtype: 'auto' = bfloat16 tables for float32 data, the data
    dtype otherwise; None / 'float32' / a torch dtype name force one.

    lfil, fastsum_fused and predict_operator are kept so that a problem
    saved by the JAX package loads; they select paths not ported yet.
    """

    kernel: str = "gaussian"
    windows: Optional[list] = None
    operator: str = "dense"
    precond: str = "nystrom"
    transform: str = "softplus"
    rank: int = 50
    lfil: int = 20
    maxits: int = 10             # SLQ steps; FGMRES uses 2x
    nvecs: int = 10              # SLQ probes
    tol: float = 1e-6
    fastsum_N: int = 32
    fastsum_table_dtype: Optional[str] = "auto"
    fastsum_oversample: int = 2
    fastsum_nearfield_lfil: Optional[int] = None
    fastsum_fused: bool = False
    fastsum_engine: str = "auto"
    predict_operator: str = "auto"
    seed: int = 0
    mask: tuple = (1, 1, 1)

    raw_params_: Optional[torch.Tensor] = None
    loss_history_: list = field(default_factory=list)

    def _windows_arr(self):
        return make_windows(self.windows) if self.windows is not None else None

    def _cfg(self):
        return GPConfig(kind=self.kernel, transform=self.transform, maxits=self.maxits,
                        nvecs=self.nvecs, tol=self.tol, mask=tuple(self.mask))

    def _table_dtype(self, X):
        if self.fastsum_table_dtype == "auto":
            return torch.bfloat16 if X.dtype == torch.float32 else None
        if self.fastsum_table_dtype in (None, "float32"):
            return None
        return getattr(torch, str(self.fastsum_table_dtype))

    def _build_ops_factory(self, X):
        warr = self._windows_arr()
        if self.operator == "dense":
            return make_dense_ops(self.kernel, X, windows=warr)
        if self.operator != "fastsum":
            raise ValueError(f"unknown operator {self.operator}")
        if warr is None:
            raise NotImplementedError("the torch fastsum operator needs additive windows")
        if self.fastsum_fused:
            raise NotImplementedError("fastsum_fused (phase-regenerating kernels) is not ported yet")
        nf = self.fastsum_nearfield_lfil
        if (16 if self.kernel == "matern12" else 0) if nf is None else nf:
            raise NotImplementedError("the fastsum near-field correction is not ported yet")
        if self.fastsum_engine not in ("auto", "stream", "table"):
            raise ValueError(f"unknown fastsum_engine {self.fastsum_engine}")
        use_stream = self.fastsum_engine == "stream" or (
            self.fastsum_engine == "auto" and X.is_cuda)
        tdt = self._table_dtype(X)
        geom = fs.additive_fastsum_geometry(X, warr, N=self.fastsum_N, table_dtype=tdt)

        def build(params):
            plan = fs.additive_fastsum_coeffs(self.kernel, params, geom,
                                              oversample=self.fastsum_oversample)
            if use_stream:
                return _stream_ops(fs.packed_ndft_plan(plan, table_dtype=tdt))
            return _table_ops(plan)

        return build

    def _precond_factory(self, X, landmarks=None):
        if self.precond == "none":
            return None
        if self.precond != "nystrom":
            raise NotImplementedError(f"precond {self.precond!r} is not ported yet")
        n = X.shape[0]
        k = min(self.rank, n)
        if landmarks is None:
            landmarks = rand_perm(torch.Generator().manual_seed(self.seed), n, k)
        landmarks = landmarks.to(X.device)
        warr = self._windows_arr()
        return lambda params: nystrom_setup(self.kernel, params, X, landmarks, k,
                                            require_grad=True, windows=warr)

    def make_loss(self, X, y, *, probes=None, landmarks=None):
        """raw_params -> (loss, grad) closure.

        probes (nvecs, n) and landmarks (>= rank indices) may be injected, the
        reference's hook for reproducible runs; by default they come from
        torch generators seeded with seed + 1 and seed.
        """
        build = self._build_ops_factory(X)
        psetup = self._precond_factory(X, landmarks)
        if probes is None:
            gen = torch.Generator().manual_seed(self.seed + 1)
            probes = rademacher_probes(gen, self.nvecs, X.shape[0], dtype=X.dtype)
        probes = probes.to(device=X.device, dtype=X.dtype)
        cfg = self._cfg()

        def loss_fn(raw):
            r = gp_loss(raw, y, build, probes, cfg, psetup)
            return r.loss, r.grad

        return loss_fn

    def fit(self, X, y, *, init=(1.0, 1.0, 0.1), adam_maxits=100, adam_alpha=0.01,
            adam_tol=1e-6, verbose=False, probes=None, landmarks=None, callback=None):
        """Train the hyperparameters with Adam (ref TEST4/foo.cpp:318-347).

        callback(it, state, loss, grad), if given, runs after every step."""
        x0 = transform_inverse(self.transform,
                               torch.as_tensor(init, dtype=X.dtype, device=X.device))

        def cb(it, state, loss, grad):
            if callback is not None:
                callback(it, state, loss, grad)
            if verbose:
                tv, _ = transform_forward(self.transform, state.x)
                print(f"{it + 1:6d} | {float(loss):15.8e} | {float(torch.linalg.norm(grad)):15.8e}"
                      f" | params: {float(tv[0]):.6g} {float(tv[1]):.6g} {float(tv[2]):.6g}")

        loss_fn = self.make_loss(X, y, probes=probes, landmarks=landmarks)
        state, losses, _, _ = adam_run(loss_fn, x0, maxits=adam_maxits, tol=adam_tol,
                                       alpha=adam_alpha, callback=cb)
        self.raw_params_ = state.x
        self.loss_history_ = [float(v) for v in losses]
        return self

    def save(self, path):
        """Persist hyperparameters, config and loss history (.npz), in the
        format of the JAX package's GPProblem.save."""
        cfg = {k: getattr(self, k) for k in _SAVED_FIELDS}
        np.savez(
            path,
            raw_params=(self.raw_params_.detach().cpu().numpy()
                        if self.raw_params_ is not None else np.zeros(0)),
            loss_history=np.asarray(self.loss_history_),
            windows=np.asarray([len(w) for w in self.windows] + sum(self.windows, [])
                               if self.windows else []),
            n_windows=len(self.windows) if self.windows else 0,
            config=np.asarray([str(cfg)]),
        )

    @staticmethod
    def load(path):
        """Restore a problem saved by either package (numpy only)."""
        data = np.load(path, allow_pickle=False)
        cfg = ast.literal_eval(str(data["config"][0]))
        nw = int(data["n_windows"])
        windows = None
        if nw:
            flat = data["windows"].tolist()
            lens, rest = flat[:nw], flat[nw:]
            windows, pos = [], 0
            for L in lens:
                windows.append([int(v) for v in rest[pos: pos + L]])
                pos += L
        prob = GPProblem(windows=windows, **cfg)
        if data["raw_params"].size:
            prob.raw_params_ = torch.from_numpy(np.array(data["raw_params"]))
        prob.loss_history_ = data["loss_history"].tolist()
        return prob
