"""High-level GP problem: kernel + operator + preconditioner + Adam loop +
prediction (port of models/problem.py).

Rebuild of SRC/optimizer/gp_problem.c: one object wires the kernel kind,
additive windows, the operator (exact dense or Fourier fastsum), the
preconditioner and the transform into a loss closure, trains the
hyperparameters with Adam and predicts the posterior mean and std.
"""

import ast
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import fastsum as fs
from ..ops.kernels import KernelParams, additive_kernel_matrix_with_grad, kernel_matrix_with_grad, make_windows
from ..ops.knn import knn_pattern
from ..preconds.afn import AfnPlan, afn_plan, afn_setup_from_plan, plan_from_arrays
from ..preconds.chol import chol_setup
from ..preconds.fsai import fsai_setup, transpose_pattern
from ..preconds.nystrom import nystrom_setup
from ..solvers.lanczos import rademacher_probes
from ..utils.datasets import rand_perm
from ..utils.timers import host_read
from .adam import AdamState, adam_init, adam_run
from .gp import GPConfig, gp_loss, gp_predict, gp_predict_fastsum, make_dense_ops
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
    nf_patterns: Optional[tuple]
    afn_plan: Optional[AfnPlan] = None
    adam_state: Optional[AdamState] = None


def state_from_numpy(device, *, raw_params=None, landmarks=None, probes=None, nf_patterns=None,
                     afn_plan=None, adam_state=None):
    """Turn numpy arrays drawn on the JAX side (raw hyperparameters, Nystrom
    landmark indices, the Rademacher probe matrix, the near-field patterns,
    an AFN plan, an Adam state) into tensors on `device`, so both packages
    compute the same loss and step.

    nf_patterns: per window group None or (idx, mask, sym), the output of the
    JAX symmetrize_nearfield_patterns (idx and mask (Wg, n, lfil) arrays).
    afn_plan: a JAX AfnPlan (its perm, k, use_ran and pattern are read).
    adam_state: a JAX AdamState (x, m, v and the step count t).
    Float arrays keep their own dtype."""
    def conv(a, kind=None):
        if a is None:
            return None
        t = torch.from_numpy(np.array(a, copy=True))
        return (t if kind is None else t.to(kind)).to(device)

    pats = None if nf_patterns is None else tuple(
        None if p is None else (conv(p[0], torch.int64), conv(p[1], torch.bool), bool(p[2]))
        for p in nf_patterns)
    plan = None if afn_plan is None else plan_from_arrays(
        afn_plan.perm, afn_plan.k, afn_plan.use_ran, afn_plan.pattern, device)
    adam = None if adam_state is None else AdamState(
        x=conv(adam_state.x), m=conv(adam_state.m), v=conv(adam_state.v), t=int(np.asarray(adam_state.t)))
    return InjectedState(raw_params=conv(raw_params), landmarks=conv(landmarks, torch.int64),
                         probes=conv(probes), nf_patterns=pats, afn_plan=plan, adam_state=adam)


def tensors_from_numpy(device, *arrays):
    """Copies of numpy arrays drawn on the JAX side (a dense K, right-hand
    sides, probe matrices, multiclass raw parameters) as tensors on `device`,
    each in its own dtype."""
    return tuple(torch.from_numpy(np.array(a, copy=True)).to(device) for a in arrays)


def _ops(matvec_batch, grad_matvec_batch):
    """(matvec, dmatvec) on one vector (n,) or a batch of rows (nv, n): the
    batch functions share one kernel pass across the rows."""
    def mv(v):
        return matvec_batch(v[None])[0] if v.ndim == 1 else matvec_batch(v)

    def dmv(v):
        return grad_matvec_batch(v[None])[0] if v.ndim == 1 else grad_matvec_batch(v)

    return mv, dmv


@dataclass
class GPProblem:
    """User-facing GP regression problem (ref gp_problem.h:20-75).

    kernel:   'gaussian' | 'matern32' | 'matern12'
    windows:  None (full kernel of at most 3 features for fastsum) or list
              of feature-index lists (additive windows of 1-3 features)
    operator: 'dense' | 'fastsum'
    precond:  'none' | 'chol' (dense K and dK, exact Cholesky) | 'nystrom' |
              'fsai' (KNN pattern of lfil, built once per dataset) | 'afn'
              (rank landmarks; the plan is made once per loss closure at
              params0, `afn_plan_`)

    fastsum_engine (additive windows): 'stream' (the packed table kernels;
    their plain torch versions on CPU tensors) | 'table' (torch products on
    per-window tables) | 'auto' (stream when X is a CUDA tensor, table on
    the CPU).  fastsum_fused: the phase-regenerating kernels instead (the
    plain versions on CPU tensors), with 'auto' or 'table' as the engine;
    'stream' conflicts with it.  3-feature windows run on the table path in
    the kernel engines; windows=None runs on the table path.
    fastsum_table_dtype: 'auto' = bfloat16 tables for float32 data, the data
    dtype otherwise; None / 'float32' / a torch dtype name force one.
    Prediction always uses tables in the data dtype.
    fastsum_nearfield_lfil: the near-field correction's size; None = 16 for
    matern12, else 0.  The stream engine corrects every pair within a
    radius rho, the pitch of a cell grid sized for about lfil neighbours
    (`nf_stencils_`); when a grid degenerates (clustered or duplicate
    data), and on the other engines and 3-feature windows, the correction
    sits on a KNN pattern of lfil neighbours (`nf_patterns_`,
    symmetrized unless the skewed in-degree guard trips).  Both are built
    once per dataset.
    predict_operator: 'auto' (the training operator; but matern12 fastsum
    predicts on the dense kernel while n <= 20000, and warns above) |
    'dense' | 'fastsum'.

    device: where numpy inputs go (default "cuda", where floating ones
    become float32; tensors keep their own device and dtype); it is not
    saved.
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
    device: Optional[str] = None

    raw_params_: Optional[torch.Tensor] = None
    loss_history_: list = field(default_factory=list)
    nf_patterns_: Optional[tuple] = None
    nf_stencils_: Optional[tuple] = None
    afn_plan_: Optional[AfnPlan] = None

    def _tensors(self, X, *others):
        """X and the arrays that go with it as tensors.  A tensor keeps its
        device and dtype.  A numpy X goes to `device` (default CUDA, and an
        error without a card); on CUDA a floating X becomes float32, the
        kernels' type, as jnp.asarray makes it under JAX's default (x64
        off), while on the CPU it keeps its dtype.  The other numpy arrays
        go to X's device, floating ones in X's dtype."""
        if not isinstance(X, torch.Tensor):
            dev = torch.device(self.device if self.device is not None else "cuda")
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("numpy inputs go to the CUDA device and there is none; "
                                   "set device='cpu' to run on the CPU")
            X = torch.as_tensor(np.asarray(X))
            if dev.type == "cuda" and X.is_floating_point():
                X = X.float()
            X = X.to(dev)

        def follow(o):
            t = torch.as_tensor(np.asarray(o), device=X.device)
            return t.to(X.dtype) if t.is_floating_point() and X.is_floating_point() else t

        return (X,) + tuple(o if isinstance(o, torch.Tensor) else follow(o) for o in others)

    def _windows_arr(self):
        return make_windows(self.windows) if self.windows is not None else None

    def _nf_lfil(self):
        if self.fastsum_nearfield_lfil is None:
            return 16 if self.kernel == "matern12" else 0
        return self.fastsum_nearfield_lfil

    def _cfg(self):
        return GPConfig(kind=self.kernel, transform=self.transform, maxits=self.maxits,
                        nvecs=self.nvecs, tol=self.tol, mask=tuple(self.mask))

    def _table_dtype(self, X):
        if self.fastsum_table_dtype == "auto":
            return torch.bfloat16 if X.dtype == torch.float32 else None
        if self.fastsum_table_dtype in (None, "float32"):
            return None
        return getattr(torch, str(self.fastsum_table_dtype))

    def _build_ops_factory(self, X, nf_patterns=None, nf_stencils=None):
        warr = self._windows_arr()
        if self.operator == "dense":
            return make_dense_ops(self.kernel, X, windows=warr)
        if self.operator != "fastsum":
            raise ValueError(f"unknown operator {self.operator}")
        if warr is None:
            return self._full_fastsum_factory(X, nf_patterns)
        if self.fastsum_engine not in ("auto", "stream", "table"):
            raise ValueError(f"unknown fastsum_engine {self.fastsum_engine}")
        if self.fastsum_fused and self.fastsum_engine == "stream":
            raise ValueError("fastsum_fused=True conflicts with fastsum_engine='stream' -- pick one "
                             "(fused regenerates the phases, stream reads packed tables)")
        use_stream = self.fastsum_engine == "stream" or (
            self.fastsum_engine == "auto" and not self.fastsum_fused and X.is_cuda)
        nf_lfil = self._nf_lfil()
        tdt = self._table_dtype(X)
        geom = fs.additive_fastsum_geometry(X, warr, N=self.fastsum_N, table_dtype=tdt)
        # the near-field's pairs do not depend on the hyperparameters: once
        # per dataset (the correction values refresh with params inside build)
        nf_stens, nf_lfil_build = None, nf_lfil
        if nf_lfil > 0:
            if use_stream:
                nf_stens = (nf_stencils if nf_stencils is not None
                            else fs.additive_nearfield_stencil_direct(geom, self.kernel, nf_lfil))
            if nf_stens is not None:
                # the radius near-field serves the d <= 2 windows; KNN
                # patterns remain for the 3-feature groups (table path)
                nf_lfil_build = 0
                if nf_patterns is None and any(dw == 3 for dw, _, _ in geom.groups):
                    pats = fs.additive_nearfield_patterns(self.kernel, geom, nf_lfil)
                    nf_patterns = fs.symmetrize_nearfield_patterns(
                        tuple(p if dw == 3 else None for p, (dw, _, _) in zip(pats, geom.groups)))
            elif nf_patterns is None:
                # degenerate grids (clustered or duplicate features) and the
                # other engines: KNN patterns, symmetrized
                nf_patterns = fs.symmetrize_nearfield_patterns(
                    fs.additive_nearfield_patterns(self.kernel, geom, nf_lfil))
        self.nf_patterns_ = nf_patterns if nf_lfil > 0 else None
        self.nf_stencils_ = nf_stens

        def build(params):
            plan = fs.additive_fastsum_coeffs(self.kernel, params, geom,
                                              oversample=self.fastsum_oversample,
                                              nearfield_lfil=nf_lfil_build, nf_patterns=self.nf_patterns_)
            if use_stream:
                pn = fs.packed_ndft_plan(plan, table_dtype=tdt, nf_stencils=nf_stens)
                return _ops(lambda V: fs.packed_ndft_matvec_batch(pn, V),
                            lambda V: fs.packed_ndft_grad_matvec_batch(pn, V))
            if self.fastsum_fused:
                return _ops(lambda V: fs.additive_fastsum_matvec_fused_batch(plan, V),
                            lambda V: fs.additive_fastsum_grad_matvec_fused_batch(plan, V))
            return _ops(lambda V: fs.additive_fastsum_matvec(plan, V),
                        lambda V: fs.additive_fastsum_grad_matvec(plan, V))

        return build

    def _full_fastsum_factory(self, X, nf_pattern=None):
        """windows=None: one fastsum plan over all features (at most 3) on
        the table path, its KNN near-field pattern symmetrized unless the
        skewed in-degree guard trips."""
        nf_lfil = self._nf_lfil()
        geom = fs.fastsum_geometry(X, self.fastsum_N, table_dtype=self._table_dtype(X))
        if nf_lfil > 0 and nf_pattern is None:
            nf_pattern = fs.nearfield_patterns(self.kernel, geom, nf_lfil, sym=True)
        self.nf_patterns_ = nf_pattern if nf_lfil > 0 else None
        self.nf_stencils_ = None

        def build(params):
            plan = fs.fastsum_coeffs(self.kernel, params, geom, oversample=self.fastsum_oversample,
                                     nearfield_lfil=nf_lfil, nf_pattern=self.nf_patterns_)
            return (lambda v: fs.fastsum_matvec(plan, v)), (lambda v: fs.fastsum_grad_matvec(plan, v))

        return build

    def _precond_factory(self, X, params0: KernelParams, landmarks=None, plan=None):
        """(setup, plan): setup(params) -> preconditioner, or None; plan the
        AFN plan (injected or made at params0) with precond='afn', else None."""
        if self.precond == "none":
            return None, None
        warr = self._windows_arr()
        if self.precond == "chol":
            def setup(params):
                if warr is None:
                    K, dK = kernel_matrix_with_grad(self.kernel, params, X)
                else:
                    K, dK = additive_kernel_matrix_with_grad(self.kernel, params, X, warr)
                return chol_setup(K, dK=dK, require_grad=True)

            return setup, None
        if self.precond == "fsai":
            pattern = knn_pattern(X, self.lfil)
            pattern_t = transpose_pattern(*pattern)
            return (lambda params: fsai_setup(self.kernel, params, X, self.lfil, require_grad=True,
                                              windows=warr, pattern=pattern, pattern_t=pattern_t)), None
        if self.precond == "afn":
            if plan is None:
                plan = afn_plan(self.kernel, params0, X, maxrank=self.rank, lfil=self.lfil,
                                generator=torch.Generator(device=X.device).manual_seed(self.seed))
            return (lambda params: afn_setup_from_plan(self.kernel, params, X, plan, require_grad=True,
                                                       windows=warr)), plan
        if self.precond != "nystrom":
            raise ValueError(f"unknown precond {self.precond}")
        n = X.shape[0]
        k = min(self.rank, n)
        if landmarks is None:
            landmarks = rand_perm(torch.Generator().manual_seed(self.seed), n, k)
        if landmarks.device != X.device:
            landmarks = host_read(landmarks, lambda lm: lm.to(X.device))
        return (lambda params: nystrom_setup(self.kernel, params, X, landmarks, k,
                                             require_grad=True, windows=warr)), None

    def make_loss(self, X, y, params0=(1.0, 1.0, 0.1), *, probes=None, landmarks=None,
                  nf_patterns=None, nf_stencils=None, afn_plan=None):
        """raw_params -> (loss, grad) closure.  X and y: tensors, or numpy
        arrays (see `device`).  params0: the (f, l, mu) the AFN plan's rank
        estimate runs at.

        probes (nvecs, n), landmarks (>= rank indices), the KNN near-field
        patterns (per window group None or (idx, mask, sym), see
        state_from_numpy; with windows=None one (idx, mask, sym)), the
        stream engine's radius near-field (`nf_stencils_` of a problem on
        the same points) and the AFN plan (`afn_plan_`, or a JAX plan
        through state_from_numpy) may be injected, the reference's hook for
        reproducible runs; by default the probes, landmarks and the rank
        estimate's subsamples come from torch generators seeded with
        seed + 1, seed and seed, the near-field from the points.
        """
        X, y = self._tensors(X, y)
        return self._loss(X, y, self._build_ops_factory(X, nf_patterns, nf_stencils), params0,
                          probes, landmarks, afn_plan)

    def _loss(self, X, y, build, params0, probes, landmarks, afn_plan):
        """make_loss on tensors, around the operator factory `build`."""
        p0 = KernelParams.make(*params0, dtype=X.dtype, device=X.device)
        psetup, plan = self._precond_factory(X, p0, landmarks, afn_plan)
        if plan is not None:
            self.afn_plan_ = plan
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
            adam_tol=1e-6, verbose=False, replan_every=0, probes=None, landmarks=None,
            nf_patterns=None, nf_stencils=None, afn_plan=None, callback=None):
        """Train the hyperparameters with Adam (ref TEST4/foo.cpp:318-347).

        replan_every > 0 (AFN only): make the AFN plan (rank estimate, FPS,
        KNN pattern) anew every `replan_every` Adam steps at the current
        hyperparameters, the Adam state carried across (the reference
        re-runs the set-up at every loss evaluation, gp_loss.c:163-172); an
        injected afn_plan serves the first segment.  The operator (tables,
        near-field) is built once for all segments.  The other injections
        are those of make_loss.  callback(it, state, loss, grad), if given,
        runs after every step (`it` counts within a segment, as verbose
        does)."""
        X, y = self._tensors(X, y)
        x0 = transform_inverse(self.transform,
                               torch.as_tensor(init, dtype=X.dtype, device=X.device))

        def cb(it, state, loss, grad):
            if callback is not None:
                callback(it, state, loss, grad)
            if verbose:
                tv, _ = transform_forward(self.transform, state.x)
                print(f"{it + 1:6d} | {float(loss):15.8e} | {float(torch.linalg.norm(grad)):15.8e}"
                      f" | params: {float(tv[0]):.6g} {float(tv[1]):.6g} {float(tv[2]):.6g}")

        # the operator's geometry and near-field depend on X alone: built once,
        # while each segment makes its AFN plan anew
        build = self._build_ops_factory(X, nf_patterns, nf_stencils)
        seg_len = replan_every if replan_every and self.precond == "afn" else adam_maxits
        state, losses, cur, plan = adam_init(x0), [], tuple(init), afn_plan
        remaining = adam_maxits
        while remaining > 0:
            seg = min(seg_len, remaining)
            loss_fn = self._loss(X, y, build, cur, probes, landmarks, plan)
            state, seg_losses, _, grads = adam_run(loss_fn, state.x, maxits=seg, tol=adam_tol,
                                                   alpha=adam_alpha, callback=cb, state0=state)
            losses.extend(seg_losses)
            tv, _ = transform_forward(self.transform, state.x)
            cur, plan = tuple(float(v) for v in tv), None
            remaining -= seg
            if grads and float(torch.linalg.norm(grads[-1])) < adam_tol:
                break
        self.raw_params_ = state.x
        self.loss_history_ = [float(v) for v in losses]
        return self

    def predict(self, X, y, X_test, *, with_std=False, maxits=None, landmarks=None, afn_plan=None):
        """Posterior mean (and std) at X_test with the fitted hyperparameters.

        maxits: FGMRES steps per solve, default 2 * maxits * 10.  landmarks
        and afn_plan: as in make_loss.  The AFN plan is made at
        (f, l, mu) = (1, 1, 0.1), not at the fitted values, as in the JAX
        package; `afn_plan_` keeps the training plan."""
        if self.raw_params_ is None:
            raise RuntimeError("call fit() first (or set raw_params_)")
        X, y, X_test = self._tensors(X, y, X_test)
        raw = self.raw_params_.to(device=X.device, dtype=X.dtype)
        p0 = KernelParams.make(1.0, 1.0, 0.1, dtype=X.dtype, device=X.device)
        psetup, _ = self._precond_factory(X, p0, landmarks, afn_plan)
        kw = dict(windows=self._windows_arr(), precond_setup=psetup, with_std=with_std,
                  maxits=maxits or 2 * self.maxits * 10)
        pred_op = self.predict_operator
        if pred_op == "auto":
            pred_op = self.operator
            if self.operator == "fastsum" and self.kernel == "matern12":
                if X.shape[0] <= 20_000:
                    pred_op = "dense"
                else:
                    print("[predict] WARNING: matern12 fastsum predictions carry the Fourier kink "
                          "error; set predict_operator='dense' if the train set fits, or raise "
                          "fastsum_N", flush=True)
        if pred_op == "fastsum":
            res = gp_predict_fastsum(raw, X, y, X_test, self._cfg(), fastsum_N=self.fastsum_N,
                                     oversample=self.fastsum_oversample,
                                     nearfield_lfil=self._nf_lfil(), **kw)
        else:
            res = gp_predict(raw, X, y, X_test, self._cfg(), **kw)
        return (res.mean, res.std) if with_std else res.mean

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
