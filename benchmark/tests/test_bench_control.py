"""The control on the card: the reference in the program's place at the
precision below the configuration's fails the cell's limits, while the
program passes them, at the cell's own size on one seed.

`benchmark/control.py` makes the readings the limits were set from (a dozen
seeds for the program, three for the control and each fault; PERF.md).
Card-only: skips without a CUDA device.
"""

import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gauss-add-1e6.train", "gauss-add-1e6.predict", "m12-afn-pcg-1e5.solve"])
def test_control_fails_where_the_program_passes(name, cuda_device):
    cell = harness.load_cell(name, ROOT)
    seed = 90000000001
    inp = harness.make_inputs(cell, seed, cuda_device)
    w = harness.run_program(cell, inp, 0.0, False, cuda_device, time.perf_counter(), seed)
    nums, reference = harness.numbers(cell, inp, seed, w.answers)
    assert harness.check.verdict(nums, cell.limits)[0], nums
    ctl = harness.numbers(cell, inp, seed, harness.control_answers(cell, inp, seed, w.answers), reference)[0]
    assert not harness.check.verdict(ctl, cell.limits)[0], ctl
