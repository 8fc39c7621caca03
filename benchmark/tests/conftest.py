"""Shared helpers of the benchmark's tests: the checkout root on sys.path and
cells cut to sizes a CPU test run holds."""

import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
# a few threads a process: the tests run in several workers at once
torch.set_num_threads(2)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the CPU runs the gaussian training traffic on the stream engine's plain
# versions, as the card does (GPProblem's "auto" picks it only for CUDA tensors);
# the solve cell at the AFN-PCG bench script's CPU size (N = 64, a
# 32-neighbour near-field)
CPU_PROBLEM = {"gauss-add-1e6.train": {"fastsum_engine": "stream"},
               "m12-afn-pcg-1e5.solve": {"fastsum_N": 64, "nf_lfil": 32}}
CPU_N = {"gauss-add-1e6.train": 800, "gauss-add-1e6.predict": 800, "m12-afn-pcg-1e5.solve": 2000}


def tiny_cell(name, n=None):
    from benchmark import harness

    cell = harness.load_cell(name, ROOT)
    cfg = copy.deepcopy(cell.config)
    cfg["n"] = n or CPU_N[name]
    cfg["problem"].update(CPU_PROBLEM.get(name, {}))
    return cell._replace(config=cfg)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
