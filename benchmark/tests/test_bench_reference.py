"""The plain reference against the port's plain versions, float64 on the CPU.

The reference imports nothing of the port; these tests put the two side by
side at tiny sizes: the operator of each engine the cells run, the Nystrom
preconditioner, the loss and gradient, Adam steps from a state part-way
through a run, the residual of a solve, and the posterior mean.
"""

import importlib
import math

import pytest
import torch

from benchmark.reference import gp_reference as ref
from benchmark.tests.conftest import ROOT  # noqa: F401

PORT = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch"


def port(name):
    return importlib.import_module(f"{PORT}.{name}")


def _data(n, d=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(n, d, generator=g, dtype=torch.float64)
    y = torch.sin(3 * X[:, 0]) + torch.cos(2 * X[:, 3]) + 0.1 * torch.randn(n, generator=g, dtype=torch.float64)
    return X, y


def _params(f=0.8, l=0.6, mu=0.3):  # noqa: E741
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    return (t(f), t(l), t(mu)), port("ops.kernels").KernelParams(f=t(f), l=t(l), mu=t(mu))


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.parametrize("trim", [False, True])
def test_operator_matches_the_table_and_stream_engines(trim):
    fs = port("ops.fastsum")
    X, _ = _data(600)
    windows = [[0, 1], [2, 3], [4]]
    p, kp = _params()
    geom = fs.additive_fastsum_geometry(X, port("ops.kernels").make_windows(windows), N=16)
    plan = fs.additive_fastsum_coeffs("gaussian", kp, geom)
    V = torch.randn(3, 600, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    if trim:
        pn = fs.packed_ndft_plan(plan)
        want, dwant = fs.packed_ndft_matvec_batch(pn, V), fs.packed_ndft_grad_matvec_batch(pn, V)
    else:
        want, dwant = fs.additive_fastsum_matvec(plan, V), fs.additive_fastsum_grad_matvec(plan, V)
    specs = [ref.WindowSpec(tuple(w), not trim, None) for w in windows]
    op = ref.AdditiveOperator("gaussian", specs, X, p, 16, ref.REFERENCE)
    assert _rel(op.matvec(V), want) < 1e-12
    assert _rel(op.grad_matvec(V), dwant) < 1e-12


def test_bf16_tables_match_the_stream_engine_on_bf16_tables():
    fs = port("ops.fastsum")
    X, _ = _data(500)
    windows = [[0, 1], [2, 3]]
    p, kp = _params()
    plan = fs.additive_fastsum_coeffs("gaussian", kp, fs.additive_fastsum_geometry(
        X, port("ops.kernels").make_windows(windows), N=16))
    pn = fs.packed_ndft_plan(plan, table_dtype=torch.bfloat16)
    V = torch.randn(2, 500, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    specs = [ref.WindowSpec(tuple(w), False, torch.bfloat16) for w in windows]
    got = ref.AdditiveOperator("gaussian", specs, X, p, 16, ref.REFERENCE).matvec(V)
    assert _rel(got, fs.packed_ndft_matvec_batch(pn, V)) < 1e-10


def _f32_shift(monkeypatch):
    """The port in float64 with the stabilization shift of float32 data (the
    reference's), so both factor the same K11 + nu I."""
    nys = port("preconds.nystrom")
    orig = nys.stable_chol

    def shifted(K, extra_shift=0.0):
        fro = torch.linalg.norm(K)
        ulp64 = float(torch.nextafter(fro, fro.new_tensor(math.inf)) - fro)
        return orig(K, extra_shift=math.sqrt(K.shape[0]) * (ref.ulp32(float(fro)) - ulp64))

    monkeypatch.setattr(nys, "stable_chol", shifted)


def test_nystrom_matches_the_port(monkeypatch):
    _f32_shift(monkeypatch)
    X, _ = _data(400)
    windows = [[0, 1], [2, 3], [4]]
    p, kp = _params()
    lm = torch.randperm(400, generator=torch.Generator().manual_seed(4))[:30]
    mine = ref.Nystrom("gaussian", X, lm, windows, p, 30)
    theirs = port("preconds.nystrom").nystrom_setup("gaussian", kp, X, lm, 30, require_grad=True,
                                                      windows=port("ops.kernels").make_windows(windows))
    R = torch.randn(3, 400, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    assert _rel(mine.solve(R), theirs.solve(R)) < 1e-9
    assert float(abs(mine.logdet() - theirs.logdet())) < 1e-9 * abs(float(theirs.logdet()))
    assert _rel(mine.trace(), theirs.trace()) < 1e-8
    assert _rel(mine.dvp(R), theirs.dvp(R)) < 1e-8


def _loss_problem(n=500):
    X, y = _data(n)
    windows = [[0, 1], [2, 3], [4]]
    g = torch.Generator().manual_seed(6)
    probes = (2 * torch.randint(0, 2, (4, n), generator=g) - 1).double()
    lm = torch.randperm(n, generator=g)[:30]
    specs = tuple(ref.WindowSpec(tuple(w), True, None) for w in windows)
    return ref.Problem(kind="gaussian", X=X, y=y, probes=probes, landmarks=lm, specs=specs, N=16, rank=30), windows


def _port_loss(rp, windows):
    GP = port("models.problem").GPProblem
    prob = GP(kernel="gaussian", windows=windows, operator="fastsum", precond="nystrom", rank=30, nvecs=4,
              fastsum_N=16, device="cpu")
    return prob.make_loss(rp.X, rp.y, probes=rp.probes, landmarks=rp.landmarks)


def test_loss_and_gradient_match_the_port(monkeypatch):
    _f32_shift(monkeypatch)
    rp, windows = _loss_problem()
    raw = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    loss, grad = _port_loss(rp, windows)(raw)
    rloss, rgrad = ref.loss_and_grad(rp, raw)
    assert abs(float(rloss - loss)) < 1e-9 * abs(float(loss))
    assert _rel(rgrad, grad) < 1e-7


def test_adam_steps_from_a_state_match_the_port(monkeypatch):
    """Three steps from a state part-way through a run, as the window's
    check takes them, against the port's adam_run from that state."""
    _f32_shift(monkeypatch)
    rp, windows = _loss_problem()
    adam = port("models.adam")
    fn = _port_loss(rp, windows)
    st = adam.adam_init(torch.zeros(3, dtype=torch.float64))
    for _ in range(2):
        st = adam.adam_run(fn, st.x, maxits=1, state0=st)[0]
    start = ref.AdamStart(st.x, st.m, st.v, st.t)
    end, losses, _, grads = adam.adam_run(fn, st.x, maxits=3, state0=st)
    rlosses, rg1, rx = ref.adam_steps(rp, start, 3)
    assert max(abs(a - float(b)) / abs(float(b)) for a, b in zip(rlosses, losses)) < 1e-9
    assert _rel(rg1, grads[0]) < 1e-7
    assert _rel(rx - st.x, end.x - st.x) < 1e-6


def test_solve_residual_reads_the_answer_on_its_own_operator():
    rp, _ = _loss_problem(300)
    raw = torch.tensor([0.2, 0.1, -0.5], dtype=torch.float64)
    params, _ = ref._params(raw, ref.REFERENCE, rp.X.device)
    op = ref.AdditiveOperator("gaussian", rp.specs, rp.X, params, rp.N, ref.REFERENCE)
    K = op.matvec(torch.eye(300, dtype=torch.float64))
    x = torch.linalg.solve(K, rp.y)
    assert ref.solve_residual(rp, raw, x) < 1e-10
    assert ref.solve_residual(rp, raw, x.float()) < 1e-5
    half = ref.solve_residual(rp, raw, x[:150])
    assert half == pytest.approx(float(torch.linalg.norm(K[:, 150:] @ x[150:]) / torch.linalg.norm(rp.y)))
    assert half > 0.1


def test_posterior_mean_matches_the_port(monkeypatch):
    _f32_shift(monkeypatch)
    X, y = _data(500)
    windows = [[0, 1], [2, 3], [4]]
    Xt = torch.rand(60, 5, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    lm = torch.randperm(500, generator=torch.Generator().manual_seed(8))[:30]
    prob = port("models.problem").GPProblem(kernel="gaussian", windows=windows, operator="fastsum",
                                            precond="nystrom", rank=30, fastsum_N=16, device="cpu")
    prob.raw_params_ = torch.zeros(3, dtype=torch.float64)
    want = prob.predict(X, y, Xt, landmarks=lm, maxits=40)
    specs = tuple(ref.WindowSpec(tuple(w), True, None) for w in windows)
    rp = ref.Problem(kind="gaussian", X=X, y=y, probes=None, landmarks=lm, specs=specs, N=16, rank=30)
    (got,) = ref.posterior_mean(rp, torch.zeros(3, dtype=torch.float64), [Xt], 40)
    assert _rel(got, want) < 1e-8


def test_the_reference_imports_nothing_of_the_port():
    src = (ROOT / "benchmark" / "reference" / "gp_reference.py").read_text()
    assert "import" in src and PORT not in src and "jax" not in src
