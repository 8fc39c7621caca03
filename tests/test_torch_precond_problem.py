"""Port parity: GPProblem with precond="fsai" and "afn" (loss, gradient,
fit with AFN re-planning, prediction, saved state) vs the JAX package's
models/problem.py, on CPU in float64 with JAX's probes injected.

The problems have n <= 500 = RankestConfig.nsample, so each rank estimate's
subsample is the whole point set in both packages, whatever their random
streams draw: the AFN plans come out equal without injection (checked); the
first test also injects JAX's plan through state_from_numpy.

Tolerances: loss and gradient rtol 1e-8 (the FSAI / AFN factors agree to
1e-13, tests/test_torch_fsai.py and test_torch_afn.py, and FGMRES and SLQ
carry that through; measured 1e-12), the gradient also atol 1e-8 of its
largest entry; the predictive mean 1e-8 relative L2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.preconds.afn import afn_plan as j_afn_plan
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.problem import state_from_numpy
from nfft4gp_torch.models.transforms import transform_inverse


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(71)
    n = 150
    X = rng.uniform(size=(n, 3))
    y = np.sin(5 * X[:, 0]) + np.cos(4 * X[:, 1]) * X[:, 2] + 0.05 * rng.normal(size=n)
    return X, y


def _probes(kw, n):
    return np.asarray(j_probes(jax.random.PRNGKey(kw["seed"] + 1), kw["nvecs"], n, dtype=jnp.float64))


BASE = dict(kernel="gaussian", windows=[[0, 1], [2]], rank=20, lfil=8, maxits=8, nvecs=4, seed=5)
CASES = {
    "fsai-dense": dict(BASE, operator="dense", precond="fsai"),
    "afn-dense": dict(BASE, operator="dense", precond="afn"),
    "fsai-table": dict(BASE, operator="fastsum", precond="fsai", fastsum_N=16),
    "afn-table": dict(BASE, operator="fastsum", precond="afn", fastsum_N=16),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_gradient(synth, case):
    """On the CPU the fastsum operator runs the table engine in both."""
    X, y = synth
    kw = CASES[case]
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.15, 0.05], dtype=torch.float64))
    p0 = (1.0, 0.1, 0.05)                   # rough enough for the AFN branch
    jl, jg = JProblem(**kw).make_loss(jnp.asarray(X), jnp.asarray(y), params0=p0)(jnp.asarray(raw.numpy()))
    jplan = None
    if kw["precond"] == "afn":
        jplan = j_afn_plan(kw["kernel"], JParams.make(*p0), jnp.asarray(X), maxrank=kw["rank"],
                           lfil=kw["lfil"], key=jax.random.PRNGKey(kw["seed"]))
    inj = state_from_numpy("cpu", probes=_probes(kw, X.shape[0]), afn_plan=jplan)
    prob = TProblem(**kw)
    tl, tg = prob.make_loss(torch.tensor(X), torch.tensor(y), p0, probes=inj.probes,
                            afn_plan=inj.afn_plan)(raw)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-8)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-8, atol=1e-8 * np.abs(jg).max())
    if jplan is not None:
        assert prob.afn_plan_ is inj.afn_plan and not jplan.use_ran
        # the port's own plan on these points equals JAX's
        own = TProblem(**kw)
        own.make_loss(torch.tensor(X), torch.tensor(y), p0, probes=inj.probes)
        assert own.afn_plan_.k == jplan.k and not own.afn_plan_.use_ran
        np.testing.assert_array_equal(own.afn_plan_.perm.numpy(), np.asarray(jplan.perm))
        np.testing.assert_array_equal(own.afn_plan_.pattern[0].numpy(), np.asarray(jplan.pattern[0]))


def test_fit_replan_predict_and_save(synth, tmp_path):
    """fit(replan_every=2): four Adam steps in two segments, each planned at
    its own start (a rough kernel, l = 0.1: the AFN branch both times); then
    the AFN-preconditioned mean, planned at (1, 1, 0.1) in both; then the
    saved problem loads and predicts the same."""
    X, y = synth
    kw = CASES["afn-dense"]
    fit_kw = dict(init=(1.0, 0.1, 0.05), adam_maxits=4, adam_alpha=0.05, replan_every=2)
    jp = JProblem(**kw).fit(jnp.asarray(X), jnp.asarray(y), **fit_kw)
    tp = TProblem(**kw).fit(torch.tensor(X), torch.tensor(y), probes=torch.tensor(_probes(kw, X.shape[0])),
                            **fit_kw)
    assert len(tp.loss_history_) == 4 and not tp.afn_plan_.use_ran
    np.testing.assert_allclose(tp.loss_history_, jp.loss_history_, rtol=1e-8)
    np.testing.assert_allclose(tp.raw_params_.numpy(), np.asarray(jp.raw_params_), rtol=1e-8)
    Xt = np.random.default_rng(3).uniform(size=(20, 3))
    jm = np.asarray(jp.predict(jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xt)))
    tm = tp.predict(torch.tensor(X), torch.tensor(y), torch.tensor(Xt)).numpy()
    assert np.linalg.norm(tm - jm) <= 1e-8 * np.linalg.norm(jm)
    path = tmp_path / "afn.npz"
    tp.save(str(path))
    again = TProblem.load(str(path))
    assert (again.precond, again.rank, again.lfil) == ("afn", kw["rank"], kw["lfil"])
    np.testing.assert_array_equal(again.predict(torch.tensor(X), torch.tensor(y), torch.tensor(Xt)).numpy(), tm)


def test_replan_builds_the_operator_once(synth, monkeypatch):
    """fit(replan_every=2) over 5 steps makes three AFN plans but builds the
    fastsum operator (tables, near-field) once, as X does not change; the
    losses equal a run whose every segment rebuilds it through make_loss.
    predict's own plan at (1, 1, 0.1) leaves afn_plan_, the training plan."""
    from nfft4gp_torch.models import problem as pm
    from nfft4gp_torch.models.adam import adam_init, adam_run
    from nfft4gp_torch.models.transforms import transform_forward

    X, y = (torch.tensor(a) for a in synth)
    kw = CASES["afn-table"]
    init, alpha = (1.0, 0.1, 0.05), 0.05
    builds, plans = [], []
    build_ops, make_plan = pm.GPProblem._build_ops_factory, pm.afn_plan
    monkeypatch.setattr(pm.GPProblem, "_build_ops_factory",
                        lambda self, *a: builds.append(a) or build_ops(self, *a))
    monkeypatch.setattr(pm, "afn_plan", lambda *a, **k: plans.append(a) or make_plan(*a, **k))
    prob = TProblem(**kw).fit(X, y, init=init, adam_maxits=5, adam_alpha=alpha, replan_every=2)
    assert (len(builds), len(plans), len(prob.loss_history_)) == (1, 3, 5)

    ref = TProblem(**kw)
    state, losses, cur = adam_init(transform_inverse("softplus", torch.tensor(init, dtype=X.dtype))), [], init
    for seg in (2, 2, 1):
        state, seg_losses, _, _ = adam_run(ref.make_loss(X, y, cur), state.x, maxits=seg, alpha=alpha,
                                           tol=1e-6, state0=state)
        losses += [float(v) for v in seg_losses]
        cur = tuple(float(v) for v in transform_forward("softplus", state.x)[0])
    assert len(builds) == 4
    np.testing.assert_allclose(prob.loss_history_, losses, rtol=1e-12)
    np.testing.assert_allclose(prob.raw_params_.numpy(), state.x.numpy(), rtol=1e-12)

    plan = prob.afn_plan_
    prob.predict(X, y, X[:8])
    assert len(plans) == 7 and prob.afn_plan_ is plan
