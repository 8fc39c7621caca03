"""The port's tracer, stage timers and profiler entry (port of utils/timers.py).

The reference accumulates wall time inside each preconditioner struct
(_tset/_titt/_tits/_tlogdet/_tdvp, ref fsai.h:28-32, nys.c:168-170) and
prints ad-hoc stage lines.  Here one tracer serves all three:

- span(name, **attrs) around a layer's work and count(name, k) at the same
  boundaries.  Off, they cost a call and two global reads: no allocation,
  no clock read, no synchronize.  Tracing is on inside `tracing()`, and while a
  torch.profiler profile runs, so that any profile of the port carries its
  spans; the latter gather in `profiled()`.  On, a span is kept in memory
  as (id, parent, name, t0_ns, t1_ns, attrs), its parent the span open on
  the host when it began.  Nothing waits for the device: t0 and t1 are
  the host's, on the clock of torch.profiler's events (time.time_ns), so
  a device gap can be put down to the span the host was in;
- host_read(x, how): the one way the hot loops block on the device (a
  device value read on the host, a host value copied to it); counted as
  `host_syncs` and spanned as `sync`;
- StageTimers: host wall time by stage, a summary of its own spans;
- trace(): torch.profiler on the CPU and, for device="cuda", the card, with
  tracing on; a Chrome trace and the spans, both on one clock, written
  into a directory.

The open-span stack is the host thread's that runs the port: one thread.
"""

import contextlib
import itertools
import json
import os
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

now_ns = time.time_ns      # the clock of torch.profiler's Kineto events


class SpanRecord(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict


class _Span:
    __slots__ = ("trace", "name", "attrs", "id", "parent", "t0")

    def __init__(self, trace, name, attrs):
        self.trace, self.name, self.attrs = trace, name, attrs

    def __enter__(self):
        tr = self.trace
        self.id = next(tr._ids)
        self.parent = tr.open[-1].id if tr.open else None
        tr.open.append(self)
        self.t0 = now_ns()
        return self

    def __exit__(self, *exc):
        t1 = now_ns()
        tr = self.trace
        tr.open.pop()
        tr.spans.append(SpanRecord(self.id, self.parent, self.name, self.t0, t1, self.attrs))
        return False

    def set(self, **attrs):
        """Attributes known only at the end of the span's work."""
        self.attrs.update(attrs)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NO_SPAN = _NoSpan()


class Trace:
    """Spans (SpanRecord, in the order they end), counters, and the spans
    open now, innermost last."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.open = []
        self._ids = itertools.count()

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def count(self, name: str, k: int = 1):
        self.counters[name] = self.counters.get(name, 0) + k

    def clear(self):
        self.spans.clear()
        self.counters.clear()


_active: Optional[Trace] = None     # the innermost tracing() block's
_PROFILED = Trace()                 # what a profiler run outside tracing() records


def _sink() -> Optional[Trace]:
    if _active is not None:
        return _active
    return _PROFILED if _profiler._is_profiler_enabled else None


def span(name: str, **attrs):
    """Context manager around a layer's work; `.set(**attrs)` adds
    attributes before it ends.  Off: the shared NO_SPAN."""
    tr = _sink()
    return NO_SPAN if tr is None else tr.span(name, **attrs)


def count(name: str, k: int = 1):
    """Add k to a counter of the trace that is on."""
    tr = _sink()
    if tr is not None:
        tr.count(name, k)


def host_read(x, how):
    """how(x), for a `how` that blocks until the device has run the work
    queued before it: float, bool, torch.Tensor.tolist on a device value,
    or a copy of a host value to the device.  The result is how(x)'s."""
    tr = _sink()
    if tr is None:
        return how(x)
    tr.count("host_syncs")
    with tr.span("sync"):
        return how(x)


@contextlib.contextmanager
def tracing():
    """Turn tracing on for the block; yields the Trace it records into."""
    global _active
    prev, tr = _active, Trace()
    _active = tr
    try:
        yield tr
    finally:
        _active = prev


def profiled() -> Trace:
    """The spans and counters recorded while a torch.profiler profile ran
    outside tracing(), from every such profile until cleared."""
    return _PROFILED


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
    """Accumulating wall timers keyed by stage name: a summary of its own
    spans (`trace`).

    >>> timers = StageTimers()
    >>> with timers("precond_setup", sync=pre.U):
    ...     pre = nystrom_setup(...)
    >>> print(timers.summary())

    sync: a tensor, or a tuple or list of tensors, whose device is
    synchronized before the span ends."""

    def __init__(self):
        self.trace = Trace()

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        with self.trace.span(name):
            try:
                yield
            finally:
                if sync is not None:
                    synchronize(sync)

    @property
    def totals(self) -> dict:
        out = defaultdict(float)
        for s in self.trace.spans:
            out[s.name] += (s.t1_ns - s.t0_ns) * 1e-9
        return out

    @property
    def counts(self) -> dict:
        out = defaultdict(int)
        for s in self.trace.spans:
            out[s.name] += 1
        return out

    def summary(self) -> str:
        totals, counts = self.totals, self.counts
        lines = ["stage                | total (s) | calls | per-call (ms)"]
        for name in sorted(totals):
            tot, cnt = totals[name], counts[name]
            lines.append(f"{name:20s} | {tot:9.3f} | {cnt:5d} | {1e3 * tot / cnt:10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.trace.clear()


@contextlib.contextmanager
def trace(logdir: str, device: str = "cuda"):
    """Profile the block with torch.profiler (the CPU, and for device="cuda"
    the card) and tracing on, and write a Chrome trace, trace.json, and the
    port's spans and counters on its clock, spans.json, into logdir.
    Yields the profiler (its key_averages() give times by op).  There is no
    fallback: device="cuda" without a card raises."""
    from torch.profiler import ProfilerActivity, profile

    if device not in ("cuda", "cpu"):
        raise ValueError(f"trace device must be 'cuda' or 'cpu', got {device!r}")
    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace(device='cuda') needs a CUDA device; pass device='cpu' to trace the CPU")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing() as tr, profile(activities=activities) as prof:
        yield prof
        if device == "cuda":
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        base = json.load(f).get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = [{"ph": "X", "cat": "port_span", "name": s.name, "pid": pid, "tid": pid,
               "ts": (s.t0_ns - base) / 1e3, "dur": (s.t1_ns - s.t0_ns) / 1e3,
               "args": {"id": s.id, "parent": s.parent, **s.attrs}} for s in tr.spans]
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"baseTimeNanoseconds": base, "counters": tr.counters, "traceEvents": events}, f)
