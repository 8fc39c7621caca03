"""Per-stage timers and profiling hooks (port of utils/timers.py).

The reference accumulates wall time inside each preconditioner struct
(_tset/_titt/_tits/_tlogdet/_tdvp, ref fsai.h:28-32, nys.c:168-170) and
prints ad-hoc stage lines.  Here:

- StageTimers: host wall time around calls, the device of the tensors
  handed in synchronized before the clock is read (CUDA launches return
  before the card finishes);
- trace(): torch.profiler on the CPU and, for device="cuda", the card, one
  Chrome trace written into a directory.
"""

import contextlib
import os
import time
from collections import defaultdict

import torch


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)


def synchronize(obj):
    """Wait for the CUDA devices of the tensors in obj (a tensor, or a tuple
    or list of them, nested) to finish their queued work; CPU tensors need
    no wait.  Returns obj."""
    for dev in {t.device for t in _tensors(obj) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return obj


class StageTimers:
    """Accumulating wall timers keyed by stage name.

    >>> timers = StageTimers()
    >>> with timers("precond_setup", sync=pre.U):
    ...     pre = nystrom_setup(...)
    >>> print(timers.summary())

    sync: a tensor, or a tuple or list of tensors, whose device is
    synchronized before the clock is read at the end of the stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["stage                | total (s) | calls | per-call (ms)"]
        for name in sorted(self.totals):
            tot = self.totals[name]
            cnt = self.counts[name]
            lines.append(f"{name:20s} | {tot:9.3f} | {cnt:5d} | {1e3 * tot / cnt:10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(logdir: str, device: str = "cuda"):
    """Profile the block with torch.profiler (the CPU, and for device="cuda"
    the card) and write a Chrome trace, trace.json, into logdir.  Yields the
    profiler (its key_averages() give times by op).  There is no fallback:
    device="cuda" without a card raises."""
    from torch.profiler import ProfilerActivity, profile

    if device not in ("cuda", "cpu"):
        raise ValueError(f"trace device must be 'cuda' or 'cpu', got {device!r}")
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace(device='cuda') needs a CUDA device; pass device='cpu' to trace the CPU")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if device == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def timed_block_until_ready(fn, *args, **kwargs):
    """Run fn, wait for the devices of its outputs, return (result,
    elapsed_seconds).  The name is the JAX package's."""
    t0 = time.perf_counter()
    out = synchronize(fn(*args, **kwargs))
    return out, time.perf_counter() - t0
