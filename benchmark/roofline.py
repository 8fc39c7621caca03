"""The NDFT kernels' least time on an H100, from the algorithm's work.

The work is the plain NDFT contraction at each launch's shape, whatever
kernel implements it: per window and per right-hand side (adjoint) or
weight set (forward) n (2P)^dw multiply-adds, two operations each.  The
bytes are the coordinates and vectors read once and the outputs written
once; phase tables are one implementation's choice and are not counted.
The least time of a launch is the larger of its operations over the dense
bf16 tensor peak (the highest rate that carries float32-accurate products
by splitting) and its bytes over the HBM bandwidth (NVIDIA H100 SXM data
sheet, 700 W).  3-feature windows and phase generation are left out.
"""

import json
import re
from pathlib import Path

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
F32 = 4
HERE = Path(__file__).resolve().parent

# the port's launch counters (ops/packed_ndft.py): wrapper -> (op, phase source)
WRAPPERS = {
    "packed_adjoint": ("adjoint", "table"),
    "packed_forward": ("forward", "table"),
    "packed_adjoint_regen": ("adjoint", "regen"),
    "packed_forward_regen": ("forward", "regen"),
    "packed_adjoint_wide": ("adjoint", None),
    "packed_forward_wide": ("forward", None),
}


def window_layout(windows):
    """(pairs, singles) of the windows the NDFT kernels take."""
    return sum(len(w) == 2 for w in windows), sum(len(w) == 1 for w in windows)


def launch_work(op: str, n: int, pairs: int, singles: int, width: int, count: int):
    """(operations, bytes) of one launch over `count` right-hand sides
    (adjoint) or weight sets (forward) at 2P = width."""
    modes = pairs * width * width + singles * width
    flops = 2.0 * n * modes * count
    coords = F32 * n * (2 * pairs + singles)
    vectors = F32 * n * count
    mode_tensors = F32 * modes * count
    return flops, float(coords + vectors + mode_tensors)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def _parse(shape: str):
    keys = dict(re.findall(r"(\w+)=(\d+)", shape))
    count = int(keys.get("nv", keys.get("nsets", 0)))
    return (int(keys["2P"]) if "2P" in keys else None), count


def ndft_least_seconds(launches: dict, n: int, windows, N: int) -> float:
    """Sum of the least times of the launches, {wrapper: {shape: launches}}."""
    pairs, singles = window_layout(windows)
    total = 0.0
    for wrapper, shapes in launches.items():
        if wrapper not in WRAPPERS:
            continue
        op, source = WRAPPERS[wrapper]
        for shape, times in shapes.items():
            width, count = _parse(shape)
            if width is None:
                width = N if source == "table" else N + 2
            total += times * least_seconds(*launch_work(op, n, pairs, singles, width, count))
    return total


def ndft_kernel_names(path: Path = HERE / "ndft_kernels.json"):
    return json.loads(path.read_text())["kernels"]


def ndft_device_seconds(kernels: dict, names) -> float:
    """Device seconds of the operations whose name holds one of `names`."""
    return sum(t for k, t in kernels.items() if any(nm in k for nm in names))
