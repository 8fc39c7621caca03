"""The solve cell on the CPU: its plain reference against the port in float64,
the harness's run and its check under each planted fault, the wide pair's
roofline, and the cell's entries in BENCHMARK.json."""

import importlib
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import solve_reference as sref
from benchmark.tests.conftest import ROOT, tiny_cell

PORT = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch"
CELL = "m12-afn-pcg-1e5.solve"
SEED = 987654321012


def port(name):
    return importlib.import_module(f"{PORT}.{name}")


def _sites(n=2000, seed=3):
    return torch.rand(n, 2, generator=torch.Generator().manual_seed(seed), dtype=torch.float64)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def test_operator_matches_the_port_in_float64():
    """The reference's operator against the port's stream-engine operator
    (radius near-field, psd_clip, trimmed far field) at the AFN-PCG bench
    script's CPU size: n = 2000, N = 64, a 32-neighbour near-field."""
    fs, kernels = port("ops.fastsum"), port("ops.kernels")
    X = _sites()
    params = kernels.KernelParams.make(1.0, 0.1, 0.01, dtype=torch.float64)
    geom = fs.additive_fastsum_geometry(X, kernels.make_windows([[0, 1]]), N=64)
    stencils = fs.additive_nearfield_stencil_direct(geom, "matern12", 32)
    plan = fs.additive_fastsum_coeffs("matern12", params, geom, psd_clip=True, nearfield_lfil=0)
    pn = fs.packed_ndft_plan(plan, nf_stencils=stencils, nf_require_grad=False)
    V = torch.randn(3, 2000, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    op = sref.Operator(sref.Spec("matern12", ((0, 1),), 1.0, 0.1, 0.01, 64, 32, True), X)
    assert _rel(op.matvec(V), fs.packed_ndft_matvec_batch(pn, V)) < 1e-10
    # the same pairs as the port's radius stencil, each once a direction
    assert 2 * op.windows[0].nf.rows.numel() + 2000 == stencils[0][0].pos.numel()


def test_dense_kernel_matches_the_port():
    """The dense apply against ops/kernels.matern12_kernel; the port's
    distances come from |x|^2 + |y|^2 - 2 x.y, whose cancellation near r = 0
    puts exp(-r / l) some 1e-9 off float64's."""
    X = _sites(1500)
    params = port("ops.kernels").KernelParams.make(0.7, 0.1, 0.01, dtype=torch.float64)
    op = sref.Operator(sref.Spec("matern12", ((0, 1),), 0.7, 0.1, 0.01, 32, 0, True), X)
    V = torch.randn(2, 1500, generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    want = V @ port("ops.kernels").matern12_kernel(params, X).T
    assert _rel(op.exact_matvec(V, block=400), want) < 1e-7


def test_cg_reaches_its_tolerance():
    X = _sites(500)
    op = sref.Operator(sref.Spec("matern12", ((0, 1),), 1.0, 0.1, 0.5, 32, 16, True), X)
    b = torch.randn(500, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    x, steps = sref.cg(op.matvec, b, 1e-8, 500)
    assert 0 < steps < 500
    assert float(torch.linalg.norm(b - op.matvec(x[None])[0]) / torch.linalg.norm(b)) <= 1e-8


@pytest.mark.parametrize("fault", [None] + sorted(faults.FAULTS["solve"]))
def test_run_and_each_fault_against_the_limits(fault):
    """The whole run of the cell at n = 2000 reads `correct`; under each
    fault one compared number, not only `failed`, is past its limit."""
    cell = tiny_cell(CELL)
    if fault is None:
        out = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
        assert out["correct"] and out["failed"] == 0, out["checks"]
        assert set(out["metrics"]) == {"solve_s", "setup_s"}
        return
    with faults.FAULTS["solve"][fault]():
        out = harness.run(cell, SEED, 0.0, False, "cpu", time.perf_counter())
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]


def test_traced_run_reads_the_program_metrics():
    """A traced run on the CPU reads the spans and counters (the device's
    metrics need a card: no NDFT kernel launches here)."""
    out = harness.run(tiny_cell(CELL), SEED + 1, 0.0, True, "cpu", time.perf_counter())
    got = out["metrics"]
    assert out["correct"], out["checks"]
    assert got["pcg_iters.solve"]["value"] >= 1
    assert got["matvec_ms.solve"]["value"] > 0 and got["afn_apply_ms.solve"]["value"] > 0
    assert "ndft_launches.solve" not in got and "ndft_roofline_pct.solve" not in got


def test_a_solve_run_loads_no_jax():
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark import harness\n"
        "out = harness.run(tiny_cell(%r), 5, 0.0, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps({'bad': harness.forbidden_modules(), 'correct': out['correct']}))\n" % (str(ROOT), CELL))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"bad": [], "correct": True}


def test_the_cell_its_metrics_and_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.load_cell(CELL, ROOT, bench)
    assert cell.chips == 1 and cell.traffic["kind"] == "solve"
    assert {m["name"] for m in cell.end_to_end} == {"solve_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {"pcg_iters.solve", "matvec_ms.solve", "afn_apply_ms.solve",
                                                   "ndft_launches.solve", "ndft_roofline_pct.solve",
                                                   "device_idle_pct.solve"}
    assert all(m["moves"] == "solve_s" for m in cell.per_layer)
    assert set(cell.limits) == {"solve_res"}
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}["predict_s"] <= 0.089


def test_the_reference_imports_nothing_of_the_port():
    src = (ROOT / "benchmark" / "reference" / "solve_reference.py").read_text()
    assert "import" in src and PORT not in src and "jax" not in src
