"""The check catches each planted fault, on tiny cells on the CPU.

Each test drives the rest of a run (inputs, set-up, window, check) with the
look for a card skipped and the timed path broken underneath
(benchmark/faults.py, the faults each cell can have), and sees `correct`
come out false with a compared number past its limit; unbroken, it comes
out true.
"""

import json
import subprocess
import sys
import time

import pytest

from benchmark import faults, harness
from benchmark.tests.conftest import AFN_CELL, ROOT, afn_cell, tiny_cell

CELLS = {"gauss-add-1e6.train": harness.load_cell("gauss-add-1e6.train", ROOT),
         "gauss-add-1e6.predict": harness.load_cell("gauss-add-1e6.predict", ROOT), AFN_CELL: afn_cell()}
CASES = [(cell, fault) for cell, c in CELLS.items() for fault in [None] + sorted(faults.for_cell(c))]


@pytest.mark.parametrize("cell,fault", CASES)
def test_correct_reads_the_fault(cell, fault):
    c = tiny_cell(cell)
    if fault is None:
        out = harness.run(c, 987654321012, 0.0, False, "cpu", time.perf_counter())
        assert out["correct"], out["checks"]
        return
    with faults.for_cell(c)[fault]():
        out = harness.run(c, 987654321012, 0.0, False, "cpu", time.perf_counter())
    assert not out["correct"], out["checks"]
    assert any(not c["value"] <= c["limit"] for c in out["checks"].values()), out["checks"]


def test_a_run_loads_no_jax():
    """A whole traced run in a fresh process leaves no module of JAX or of
    the JAX package in sys.modules (top-level names compared whole: the
    port's own name only begins with the JAX package's)."""
    code = (
        "import sys, time, json; sys.path.insert(0, %r)\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark import harness\n"
        "out = harness.run(tiny_cell('gauss-add-1e6.predict'), 5, 0.0, True, 'cpu', time.perf_counter())\n"
        "print(json.dumps({'bad': harness.forbidden_modules(), 'port': any(m.startswith(harness.PORT) "
        "for m in sys.modules), 'correct': out['correct']}))\n" % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "port": True, "correct": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxfoo", sys)
    monkeypatch.setitem(sys.modules, "nfft4gp_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert harness.forbidden_modules() == ["jaxlib.xla"]


def test_the_command_fails_without_a_card(tmp_path):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gauss-add-1e6.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert res.returncode != 0 and res.stdout.strip() == ""
