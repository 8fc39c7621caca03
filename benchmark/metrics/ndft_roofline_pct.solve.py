"""The NDFT kernels' share of their roofline over the profiled stretch: the
least time of the stretch's launches (benchmark/roofline.py, from the
launch counters by shape) over the profiler's device time of the kernels
that ndft_kernels.json names."""

from benchmark import roofline


def read(r):
    if r.stretch is None:
        return None
    busy = roofline.ndft_device_seconds(r.stretch.kernels, roofline.ndft_kernel_names())
    p = r.cell.config["problem"]
    least = roofline.ndft_least_seconds(r.stretch_launches, r.cell.config["n"], p["windows"], p["fastsum_N"])
    return None if busy <= 0.0 or least <= 0.0 else 100.0 * least / busy
