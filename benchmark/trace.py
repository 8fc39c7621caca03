"""The device trace of a short stretch of a traced run.

`torch.profiler` over the stretch, recording the device's activity alone
where there is a device: the host's events would cost the host some tens
of microseconds an operation and idle the device for it.  From its events
the device's busy time (the union of the intervals of every operation on
the device: kernels, copies, sets), the device time of each operation's
name, and the idle gaps between device work, each labelled by the device
operation that ended last before it ("after <name>"): the host work that
follows it holds the device.
"""

import time
from typing import NamedTuple

import torch
from torch.profiler import ProfilerActivity, profile

LABEL_CHARS = 60


class Stretch(NamedTuple):
    wall_s: float                 # host seconds of the stretch, synchronized at both ends
    busy_s: float                 # union of device intervals
    kernels: dict                 # device seconds by operation name
    gaps: dict                    # idle device seconds by the operation before the gap


def _device_work(prof):
    """[(name, start_ns, end_ns)] of the profile's device operations."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def _merge(work):
    """[start, end, name of the operation that ends it] of the union of the
    intervals of `work` [(name, start, end)]."""
    merged = []
    for name, s, e in sorted(work, key=lambda w: w[1]):
        if merged and s <= merged[-1][1]:
            if e >= merged[-1][1]:
                merged[-1][1:] = [e, name]
        else:
            merged.append([s, e, name])
    return merged


def profiled(fn, device):
    """(fn(), Stretch) with fn run under the profiler."""
    dev = torch.device(device)
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t
    work = _device_work(prof)
    kernels = {}
    for name, s, e in work:
        kernels[name] = kernels.get(name, 0.0) + (e - s) * 1e-9
    merged = _merge(work)
    busy = sum(e - s for s, e, _ in merged) * 1e-9
    gaps = {}
    for (_, e0, name), (s1, _, _) in zip(merged, merged[1:]):
        label = f"after {name[:LABEL_CHARS]}"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-9
    return out, Stretch(wall_s=wall, busy_s=busy, kernels=kernels, gaps=gaps)


def breakdown(stretch: Stretch, top: int = 10) -> dict:
    """The contract's `breakdown`: the device operations that took most time
    and the idle gaps by the operation before them, at most `top` each."""
    ops = sorted(stretch.kernels.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(stretch.gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
