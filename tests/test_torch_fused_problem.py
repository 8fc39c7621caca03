"""Port parity: the fused-engine matern12 GPProblem (loss, a 2-step Adam fit,
the near-field patterns it builds) and the same problem on the table engine,
against the JAX package on CPU, float64.  JAX's own
GPProblem(fastsum_fused=True) does not run on a CPU backend (its factory
calls the Pallas kernels without interpret mode), so its loss is composed
from the package's parts with the kernels in interpret mode (block=128) and
jitted once for the module.

Tolerances:
- fused engine against the composed JAX fused loss: loss rtol 1e-5,
  gradient 1e-4 relative to its largest entry, and the same over a 2-step
  Adam fit -- the JAX kernels' dots return float32 (preferred_element_type)
  even for float64 operands, and FGMRES and SLQ carry that rounding;
- table engine against JAX gp_loss on the table matvecs: rtol 1e-9
  (float64 throughout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models.adam import adam_run as j_adam_run
from nfft4gp_tpu.models.gp import gp_loss as j_gp_loss
from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.models.transforms import transform_inverse as j_transform_inverse
from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.problem import state_from_numpy
from nfft4gp_torch.models.transforms import transform_inverse

BLOCK = 128

PROBLEM = dict(kernel="matern12", windows=[[0, 1, 2], [3, 4], [5]], operator="fastsum",
               precond="nystrom", rank=10, maxits=5, nvecs=3, fastsum_N=16, seed=2)
INIT = (1.0, 1.0, 0.1)


@pytest.fixture(scope="module")
def problem():
    """Data, the JAX fused and table losses composed from the package's parts
    (JAX's own GPProblem(fastsum_fused=True) does not run on a CPU backend:
    its factory calls the kernels without interpret mode), jitted once, and
    the JAX-drawn probes, landmarks and near-field patterns as port tensors."""
    rng = np.random.default_rng(83)
    n = 200
    X = rng.uniform(size=(n, 6))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 3]) + 0.1 * rng.normal(size=n)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    jprob = JProblem(**PROBLEM)
    geom = jfs.additive_fastsum_geometry(Xj, j_windows(PROBLEM["windows"]), N=PROBLEM["fastsum_N"])
    pats = jfs.symmetrize_nearfield_patterns(jfs.additive_nearfield_patterns("matern12", geom, 16))
    psetup = jprob._precond_factory(Xj, JParams.make(*INIT, dtype=Xj.dtype))
    probes = j_probes(jax.random.PRNGKey(PROBLEM["seed"] + 1), PROBLEM["nvecs"], n, dtype=jnp.float64)
    perm = j_rand_perm(jax.random.PRNGKey(PROBLEM["seed"]), n, PROBLEM["rank"])
    cfg = jprob._cfg()

    def loss(fused):
        def build(params):
            plan = jfs.additive_fastsum_coeffs("matern12", params, geom, nearfield_lfil=16,
                                               nf_patterns=pats)
            if fused:
                kw = dict(block=BLOCK, interpret=True)
                return (lambda v: jfs.additive_fastsum_matvec_fused(plan, v, **kw),
                        lambda v: jfs.additive_fastsum_grad_matvec_fused(plan, v, **kw))
            return (lambda v: jfs.additive_fastsum_matvec(plan, v),
                    lambda v: jfs.additive_fastsum_grad_matvec(plan, v))

        def run(raw):
            r = j_gp_loss(raw, yj, build, probes, cfg, psetup)
            return r.loss, r.grad

        return jax.jit(run)

    inj = state_from_numpy("cpu", landmarks=np.asarray(perm), probes=np.asarray(probes),
                           nf_patterns=[None if p is None else (np.asarray(p[0]), np.asarray(p[1]), p[2])
                                        for p in pats])
    return dict(X=torch.tensor(X), y=torch.tensor(y), jfused=loss(True), jtable=loss(False), inj=inj)


def _port_kw(inj):
    return dict(probes=inj.probes, landmarks=inj.landmarks, nf_patterns=inj.nf_patterns)


def test_fused_problem_loss_and_fit(problem):
    X, y, inj = problem["X"], problem["y"], problem["inj"]
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.4, 0.1], dtype=torch.float64))
    tprob = TProblem(fastsum_fused=True, **PROBLEM)
    tl, tg = tprob.make_loss(X, y, **_port_kw(inj))(raw)
    jl, jg = problem["jfused"](jnp.asarray(raw.numpy()))
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())

    # 2 Adam steps, as GPProblem.fit runs them in both packages
    x0 = j_transform_inverse("softplus", jnp.asarray(INIT, jnp.float64))
    jstate, jlosses, _, _ = j_adam_run(problem["jfused"], x0, maxits=2, alpha=0.05)
    tp = TProblem(fastsum_fused=True, **PROBLEM).fit(X, y, init=INIT, adam_maxits=2, adam_alpha=0.05,
                                                      **_port_kw(inj))
    np.testing.assert_allclose(tp.loss_history_, [float(v) for v in jlosses], rtol=1e-5)
    np.testing.assert_allclose(tp.raw_params_.numpy(), np.asarray(jstate.x), rtol=1e-5)


def test_fused_problem_builds_the_jax_patterns(problem):
    """Without injection the port's own KNN and symmetrization give the
    JAX patterns (tie-free data)."""
    X, y, inj = problem["X"], problem["y"], problem["inj"]
    tprob = TProblem(fastsum_fused=True, **PROBLEM)
    tprob.make_loss(X, y, probes=inj.probes, landmarks=inj.landmarks)
    assert len(tprob.nf_patterns_) == len(inj.nf_patterns)
    for t, j in zip(tprob.nf_patterns_, inj.nf_patterns):
        assert t[2] == j[2]
        np.testing.assert_array_equal(t[0].numpy(), j[0].numpy())
        np.testing.assert_array_equal(t[1].numpy(), j[1].numpy())


def test_table_problem_loss(problem):
    X, y, inj = problem["X"], problem["y"], problem["inj"]
    raw = transform_inverse("softplus", torch.tensor([0.9, 0.6, 0.08], dtype=torch.float64))
    tl, tg = TProblem(fastsum_engine="table", **PROBLEM).make_loss(X, y, **_port_kw(inj))(raw)
    jl, jg = problem["jtable"](jnp.asarray(raw.numpy()))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)
