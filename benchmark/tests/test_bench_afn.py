"""The AFN training cell on the CPU: the plain AFN reference against dense
algebra and against the port's AfnPrecond, the near-field training operator
against the port and against finite differences, the gaussian reference's
numbers as they were, and the cell's readers on a traced run."""

import importlib
import json
import math
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import afn_reference as aref
from benchmark.reference import gp_reference as ref
from benchmark.reference import solve_reference as sref
from benchmark.tests.conftest import ROOT, afn_cell, tiny_cell

PORT = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch"
CELL = "m12-afn-2e5.train"        # out of BENCHMARK.json: conftest.afn_cell
WINDOWS = [[0, 1], [2, 3]]


def port(name):
    return importlib.import_module(f"{PORT}.{name}")


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _params(f=0.9, l=0.3, mu=0.05):  # noqa: E741
    return tuple(torch.tensor(v, dtype=torch.float64) for v in (f, l, mu))


def _dyadic(n, d=4, seed=0):
    """Points on a 1/256 grid: their squared distances are exact in float64
    however they are formed, so the port's |x|^2 + |y|^2 - 2 x.y and the
    reference's differences give the same kernel."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, d), generator=g).double() / 256.0


def _plan(X, k, lfil, seed=1):
    """A plan made here: random landmarks, each Schur row its lfil - 1
    nearest earlier points (slots in front, padding masked) and itself last."""
    n = X.shape[0]
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    X2 = X[perm[k:]]
    n2 = n - k
    idx = torch.zeros((n2, lfil), dtype=torch.int64)
    mask = torch.zeros((n2, lfil), dtype=torch.bool)
    D = torch.cdist(X2, X2)
    for i in range(n2):
        prev = torch.argsort(D[i, :i])[: lfil - 1]
        idx[i, : prev.numel()], mask[i, : prev.numel()] = prev, True
        idx[i, -1], mask[i, -1] = i, True
    return aref.Plan(perm=perm, k=k, use_ran=False, idx=idx, mask=mask)


def _afn(X, plan, params, kind="matern12"):
    return aref.Afn(ref.kernel_with_grad(kind, WINDOWS, params), X, plan)


def _dense(afn, plan):
    """(M, dM (3, n, n)) in the plan's order from the factors: M = U'U."""
    k, n = plan.k, afn.n
    n2 = n - k
    rows = torch.arange(n2)[:, None].expand_as(plan.idx)

    def on_pattern(vals):
        A = torch.zeros((n2, n2), dtype=vals.dtype)
        A.index_put_((rows[plan.mask], plan.idx[plan.mask]), vals[plan.mask], accumulate=True)
        return A

    Gi = torch.linalg.inv(on_pattern(afn.g))
    U = torch.zeros((n, n), dtype=torch.float64)
    U[:k, :k], U[:k, k:], U[k:, k:] = afn.L.T, afn.W, Gi.T
    dM = []
    for j in range(3):
        dU = torch.zeros_like(U)
        dU[:k, :k], dU[:k, k:] = afn.dL[j].T, afn.dW[j]
        dU[k:, k:] = -Gi.T @ on_pattern(afn.dg[j]).T @ Gi.T
        dM.append(dU.T @ U + U.T @ dU)
    return U.T @ U, torch.stack(dM)


def test_afn_reference_against_dense_algebra():
    """solve, logdet, trace and dvp against M = U'U formed densely at n =
    1000; L11 and the rows of G against their definitions; dM against
    central differences of M in (f, l, mu)."""
    X = torch.rand(1000, 4, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    plan = _plan(X, 60, 8)
    assert aref.plan_faults(plan, 1000, 60) == []
    params = _params()
    afn = _afn(X, plan, params)
    assert afn.repaired == 0
    M, dM = _dense(afn, plan)
    perm = plan.perm
    R = torch.randn(3, 1000, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    assert _rel(afn.solve(R)[:, perm], torch.linalg.solve(M, R[:, perm].T).T) < 1e-10
    assert abs(float(afn.logdet() - torch.linalg.slogdet(M)[1])) < 1e-10 * abs(float(afn.logdet()))
    want = torch.stack([torch.trace(torch.linalg.solve(M, dM[j])) for j in range(3)])
    assert _rel(afn.trace(), want) < 1e-10
    want = torch.stack([torch.linalg.solve(M, dM[j] @ R[:, perm].T).T for j in range(3)], dim=1)
    assert _rel(afn.dvp(R)[:, :, perm], want) < 1e-10
    # the factors are what they stand for
    Xp = X[perm]
    K, _ = ref.kernel_with_grad("matern12", WINDOWS, params)(Xp)
    nu = math.sqrt(60) * aref.ulp(float(torch.linalg.norm(K[:60, :60])), torch.float32)
    assert _rel(afn.L @ afn.L.T, K[:60, :60] + nu * torch.eye(60, dtype=torch.float64)) < 1e-14
    S = K[60:, 60:] - afn.W.T @ afn.W
    for i in (0, 5, 400, 939):
        J = plan.idx[i][plan.mask[i]]
        got = S[J][:, J] @ afn.g[i][plan.mask[i]]
        assert _rel(got, torch.eye(len(J), dtype=torch.float64)[-1] / afn.g[i, -1]) < 1e-10
    for j in range(3):
        h = 1e-6 * float(params[j])
        up = tuple(p + h * (i == j) for i, p in enumerate(params))
        down = tuple(p - h * (i == j) for i, p in enumerate(params))
        fd = (_dense(_afn(X, plan, up), plan)[0] - _dense(_afn(X, plan, down), plan)[0]) / (2 * h)
        assert _rel(fd, dM[j]) < 1e-6, j


def _f32_shift(monkeypatch, module):
    """The port in float64 with the Cholesky shift of float32 data (the
    reference's), so both factor the same K11 + nu I."""
    mod = port(module)
    orig = mod.stable_chol

    def shifted(K, extra_shift=0.0):
        fro = torch.linalg.norm(K)
        ulp64 = float(torch.nextafter(fro, fro.new_tensor(math.inf)) - fro)
        return orig(K, extra_shift=math.sqrt(K.shape[0]) * (ref.ulp32(float(fro)) - ulp64))

    monkeypatch.setattr(mod, "stable_chol", shifted)


@pytest.mark.parametrize("kind", ["matern12", "gaussian"])
def test_afn_reference_matches_the_port(kind, monkeypatch):
    """The port's plan (FPS landmarks, cell-sorted Schur tail, KNN pattern)
    and its AfnPrecond in float64 against the reference on that plan's
    structure, to 1e-10."""
    _f32_shift(monkeypatch, "preconds.afn")
    afn_mod, kernels = port("preconds.afn"), port("ops.kernels")
    X = _dyadic(900)
    params = _params()
    kp = kernels.KernelParams(*params)
    plan = afn_mod.afn_plan(kind, kp, X, maxrank=50, lfil=10, rank=50, force_afn=True)
    theirs = afn_mod.afn_setup_from_plan(kind, kp, X, plan, require_grad=True, windows=kernels.make_windows(WINDOWS))
    structure = harness.plan_structure(plan)
    assert aref.plan_faults(structure, 900, 50) == []
    mine = _afn(X, structure, params, kind)
    assert mine.repaired == int(theirs.breakdown) == 0
    R = torch.randn(3, 900, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    assert _rel(mine.solve(R), theirs.solve(R)) < 1e-10
    assert abs(float(mine.logdet() - theirs.logdet())) < 1e-10 * abs(float(theirs.logdet()))
    assert _rel(mine.trace(), theirs.trace()) < 1e-10
    assert _rel(mine.dvp(R), theirs.dvp(R)) < 1e-10


def test_plan_faults_name_what_is_wrong():
    X = torch.rand(300, 4, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    plan = _plan(X, 40, 6)
    assert aref.plan_faults(plan, 300, 40) == []
    assert aref.plan_faults(plan._replace(use_ran=True), 300, 40) == ["use_ran: the plain-Nystrom branch"]
    assert aref.plan_faults(plan, 300, 50)[0] == "k = 40, not 50"
    twice = plan.perm.clone()
    twice[1] = twice[0]
    assert aref.plan_faults(plan._replace(perm=twice), 300, 40) == ["perm is not a permutation of 300 points"]
    later = plan.idx.clone()
    later[7, 0] = 9
    assert aref.plan_faults(plan._replace(idx=later), 300, 40) == ["a pattern row holds a point that is not before it"]
    other = plan.idx.clone()
    other[3, -1] = 2
    assert aref.plan_faults(plan._replace(idx=other), 300, 40) == ["a pattern row does not end in its own point"]
    assert len(aref.plan_faults(plan, 400, 40)) == 2


def _nf_operator(X, params, N=32, nf=16, prec=ref.REFERENCE):
    specs = tuple(ref.WindowSpec(tuple(w), False, None) for w in WINDOWS)
    Xd = X.to(prec.dtype)
    nearfield = tuple(sref.NearField(*ref.scaled_points(Xd[:, w], prec.dtype), nf) for w in WINDOWS)
    return ref.AdditiveOperator("matern12", specs, Xd, params, N, prec, nearfield)


def test_nearfield_training_operator_matches_the_port():
    """The reference's training operator (trimmed far field, tapered radius
    near-field, unclipped coefficients) and its gradient rows against the
    port's stream-engine plan with the radius near-field, float64."""
    fs, kernels = port("ops.fastsum"), port("ops.kernels")
    X = torch.rand(2000, 4, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    params = _params(1.0, 0.1, 0.01)
    geom = fs.additive_fastsum_geometry(X, kernels.make_windows(WINDOWS), N=32)
    stencils = fs.additive_nearfield_stencil_direct(geom, "matern12", 16)
    plan = fs.additive_fastsum_coeffs("matern12", kernels.KernelParams(*params), geom, nearfield_lfil=0)
    pn = fs.packed_ndft_plan(plan, nf_stencils=stencils)
    V = torch.randn(3, 2000, generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    op = _nf_operator(X, params)
    assert _rel(op.matvec(V), fs.packed_ndft_matvec_batch(pn, V)) < 1e-10
    assert _rel(op.grad_matvec(V), fs.packed_ndft_grad_matvec_batch(pn, V)) < 1e-10
    plain = ref.AdditiveOperator("matern12", tuple(ref.WindowSpec(tuple(w), False, None) for w in WINDOWS), X,
                                 params, 32, ref.REFERENCE)
    assert _rel(op.matvec(V), plain.matvec(V)) > 1e-3          # the correction is there


def test_nearfield_l_gradient_against_finite_differences():
    X = torch.rand(1500, 4, generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    f, l, mu = _params(1.0, 0.1, 0.01)  # noqa: E741
    V = torch.randn(2, 1500, generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    h = 1e-6
    fd = (_nf_operator(X, (f, l + h, mu)).matvec(V) - _nf_operator(X, (f, l - h, mu)).matvec(V)) / (2 * h)
    got = _nf_operator(X, (f, l, mu)).grad_matvec(V)[:, 1]
    assert _rel(got, fd) < 1e-7
    far = ref.AdditiveOperator("matern12", tuple(ref.WindowSpec(tuple(w), False, None) for w in WINDOWS), X,
                               (f, l, mu), 32, ref.REFERENCE)
    assert _rel(got, far.grad_matvec(V)[:, 1]) > 1e-3          # the near-field's d/dl is in it


# the parent's gp_reference on this problem (float64, CPU): the last digit of
# the gradient's l leaf moves from run to run with the CPU's BLAS
GAUSSIAN_GOLDEN = {
    "gaussian": (0.6246922428355735, [0.6415397156105753, 0.01609611737384095, 0.31497548729600067],
                 71.21068796431524),
    "matern12": (0.6609875856440619, [0.6486639027957095, -0.017028835182211734, 0.2991434166333261],
                 50.125623468501416),
}


@pytest.mark.parametrize("kind", sorted(GAUSSIAN_GOLDEN))
def test_nystrom_reference_numbers_are_unchanged(kind):
    """Without AFN and a near-field the training reference gives the numbers
    it gave before either was added (Nystrom, bf16 tables, trimmed)."""
    g = torch.Generator().manual_seed(0)
    X = torch.rand(500, 5, generator=g, dtype=torch.float64)
    y = torch.sin(3 * X[:, 0]) + torch.cos(2 * X[:, 3]) + 0.1 * torch.randn(500, generator=g, dtype=torch.float64)
    X, y = X.float(), y.float()
    g = torch.Generator().manual_seed(6)
    probes = (2 * torch.randint(0, 2, (4, 500), generator=g) - 1).float()
    lm = torch.randperm(500, generator=g)[:30]
    specs = tuple(ref.WindowSpec(tuple(w), False, torch.bfloat16) for w in [[0, 1], [2, 3], [4]])
    rp = ref.Problem(kind=kind, X=X, y=y, probes=probes, landmarks=lm, specs=specs, N=16, rank=30)
    raw = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    loss, grad = ref.loss_and_grad(rp, raw)
    want_loss, want_grad, want_res = GAUSSIAN_GOLDEN[kind]
    assert float(loss) == want_loss
    assert torch.allclose(grad, torch.tensor(want_grad, dtype=torch.float64), rtol=1e-13, atol=0.0)
    assert ref.solve_residual(rp, raw, y[:400] * 0.5) == pytest.approx(want_res, rel=1e-14)


def test_readers_on_a_traced_cpu_cell():
    """A traced CPU run of the cell reads every per-layer metric of the
    program's spans and counters, AFN's two among them; the device's need
    a card."""
    timers = harness.port("utils.timers")
    timers.profiled().clear()
    out = harness.run(tiny_cell(CELL), 2400000017, 0.0, True, "cpu", time.perf_counter())
    timers.profiled().clear()
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for m in ("afn_apply_ms.train", "afn_dvp_ms.train", "precond_ms.train", "fgmres_ms.train", "slq_ms.train",
              "op_build_ms.train", "host_syncs.train"):
        assert got[m] > 0, m
    assert "ndft_launches.train" not in got and "ndft_roofline_pct.train" not in got
    # each Adam step: FGMRES's applies and SLQ's, one dvp
    assert got["afn_dvp_ms.train"] < got["slq_ms.train"]


def test_the_left_out_cell_is_its_files():
    """The cell waits outside BENCHMARK.json (PERF.md section 7) with its
    configuration and readers in place: the configuration makes a
    GPProblem, the readers read the AFN spans, and the cells that are in
    keep their bounds."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = afn_cell()
    assert cell.config["reduced"] == [] and cell.config["problem"]["precond"] == "afn"
    prob = port("models.problem").GPProblem(**cell.config["problem"])
    assert prob._nf_lfil() == harness.nearfield_lfil(cell.config["problem"]) == 16
    reading = harness.Reading(cell=cell, units=4, spans={"afn_solve": 0.2, "afn_dvp": 1.0}, span_units=4,
                              launches={}, stretch=None, stretch_launches={})
    assert harness.read_metric("afn_apply_ms.train", reading) == pytest.approx(50.0)
    assert harness.read_metric("afn_dvp_ms.train", reading) == pytest.approx(250.0)
    spans = {e.get("span") for e in json.loads((ROOT / "benchmark" / "spans.json").read_text())["wrap"]}
    assert {"afn_solve", "afn_dvp"} <= spans
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]} == {"step_s": 0.2, "predict_s": 0.08,
                                                                    "solve_s": 0.25, "setup_s": 0.25}


def test_the_reference_imports_nothing_of_the_port():
    src = (ROOT / "benchmark" / "reference" / "afn_reference.py").read_text()
    assert "import" in src and PORT not in src and "jax" not in src
