"""Shared helpers of the benchmark's tests: the checkout root on sys.path and
cells cut to sizes a CPU test run holds."""

import copy
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
# a few threads a process: the tests run in several workers at once
torch.set_num_threads(2)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the CPU runs the training traffic on the stream engine's plain versions,
# as the card does (GPProblem's "auto" picks it only for CUDA tensors); the
# solve cell at the AFN-PCG bench script's CPU size (N = 64, a 32-neighbour
# near-field); the AFN training cell keeps its rank 200, 800 Schur points
CPU_PROBLEM = {"gauss-add-1e6.train": {"fastsum_engine": "stream"},
               "m12-afn-2e5.train": {"fastsum_engine": "stream"},
               "m12-afn-pcg-1e5.solve": {"fastsum_N": 64, "nf_lfil": 32}}
CPU_N = {"gauss-add-1e6.train": 800, "gauss-add-1e6.predict": 800, "m12-afn-2e5.train": 1000,
         "m12-afn-pcg-1e5.solve": 2000}


# the AFN training cell is not in BENCHMARK.json while the port's float32
# Matern-1/2 kernel blocks stay inexact near r = 0 (PERF.md section 7): the
# tests make it from its files, held to the gaussian training cell's limits
# but `solve_res` (its FGMRES(20) stops near 0.12 by design)
AFN_CELL = "m12-afn-2e5.train"
AFN_READERS = ("fgmres_ms.train", "slq_ms.train", "precond_ms.train", "op_build_ms.train", "ndft_launches.train",
               "ndft_roofline_pct.train", "device_idle_pct.train", "host_syncs.train", "afn_apply_ms.train",
               "afn_dvp_ms.train")
AFN_CPU_LIMITS = {"plan_bad": 0.0, "loss_gap": 0.0033, "grad_gap": 0.35, "change_gap": 0.3, "w_loss_gap": 0.0033,
                  "w_grad_gap": 0.35, "w_change_gap": 0.3}


def afn_cell():
    """m12-afn-2e5.train from its configuration, the train traffic and its readers."""
    from benchmark import harness

    bdir = ROOT / "benchmark"
    return harness.Cell(name=AFN_CELL, chips=1, config=json.loads((bdir / "configs" / "m12-afn-2e5.json").read_text()),
                        traffic=json.loads((bdir / "traffic" / "train.json").read_text()),
                        end_to_end=[{"name": "step_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
                        per_layer=[{"name": m, "unit": "ms/step"} for m in AFN_READERS], limits=AFN_CPU_LIMITS)


def tiny_cell(name, n=None):
    from benchmark import harness

    cell = afn_cell() if name == AFN_CELL else harness.load_cell(name, ROOT)
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
