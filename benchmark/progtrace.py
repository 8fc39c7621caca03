"""The port's own spans and counters in a profiled stretch, and the device's
idle time put down to them.

While a torch.profiler profile runs, the port's tracer (utils/timers.py)
records its spans and counters into `timers.profiled()`, on the clock of
the profiler's events; the stretch of a traced run is such a profile.
`recorded()` reads them (None where the port has no tracer).
`idle_by_span` gives each nanosecond of every idle gap between the
device's operations to the innermost span that was open on the host at
that moment, or to None where none was.

Run as a script, it runs one traced run of a cell through the harness,
keeps the stretch's device intervals, and prints the stretch's idle time
by span, per unit, as one JSON line:

    python3 benchmark/progtrace.py --workload <cell> --seed <n> --seconds <s>
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch"
KRYLOV = ("fgmres", "slq")
UNITS = {"train": "step", "predict": "predict"}     # the span of one unit of a traffic kind


def recorded():
    """The port's Trace of what ran under a profiler, or None."""
    try:
        timers = importlib.import_module(f"{PORT}.utils.timers")
    except ImportError:
        return None
    profiled = getattr(timers, "profiled", None)
    return None if profiled is None else profiled()


def per_unit(kind: str, value):
    """value / the units in the recorded stretch (their spans), or None."""
    tr = recorded()
    if tr is None:
        return None
    units = sum(s.name == UNITS[kind] for s in tr.spans)
    return None if units == 0 else value(tr) / units


def _innermost(spans):
    """[(a, b, id)]: the spans' union cut where the innermost open span
    changes.  Spans of one thread nest."""
    pieces, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s.t0_ns, -s.t1_ns)):
        while stack and stack[-1][0] <= s.t0_ns:
            t1, sid = stack.pop()
            pieces.append((t, t1, sid))
            t = t1
        if stack:
            pieces.append((t, s.t0_ns, stack[-1][1]))
        stack.append((s.t1_ns, s.id))
        t = s.t0_ns
    while stack:
        t1, sid = stack.pop()
        pieces.append((t, t1, sid))
        t = t1
    return [p for p in pieces if p[1] > p[0]]


def idle_gaps(busy, start, end):
    """[(a, b)]: [start, end] less the sorted, disjoint intervals busy
    [(s, e, ...)]."""
    gaps, t = [], start
    for s, e, *_ in busy:
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [g for g in gaps if g[1] > g[0]]


def idle_by_span(busy, spans, start=None, end=None) -> dict:
    """{span id, or None outside every span: idle ns} over [start, end]
    (by default the first device interval's start to the last's end).
    busy: the merged device intervals [(s, e, ...)], sorted and disjoint;
    spans: SpanRecords.  The values sum to the idle time."""
    if start is None:
        start = busy[0][0] if busy else 0
    if end is None:
        end = busy[-1][1] if busy else 0
    out = {}
    pieces = _innermost(spans)
    i = 0
    for a, b in idle_gaps(busy, start, end):
        covered = 0
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                out[pieces[j][2]] = out.get(pieces[j][2], 0) + hi - lo
                covered += hi - lo
            j += 1
        if b - a > covered:
            out[None] = out.get(None, 0) + b - a - covered
    return out


def label(sid, by_id) -> str:
    """A span's name, `<parent>/sync` for a sync, `outside` for None."""
    if sid is None:
        return "outside"
    s = by_id[sid]
    if s.name == "sync" and s.parent is not None:
        return f"{by_id[s.parent].name}/sync"
    return s.name


def by_label(idle: dict, spans) -> dict:
    by_id = {s.id: s for s in spans}
    out = {}
    for sid, ns in idle.items():
        k = label(sid, by_id)
        out[k] = out.get(k, 0) + ns
    return out


def krylov_ns(labelled: dict) -> int:
    """Idle ns whose innermost span is fgmres, slq or a sync under them."""
    return sum(ns for k, ns in labelled.items() if k in KRYLOV or k in {f"{n}/sync" for n in KRYLOV})


def attributed(cell, seed: int, seconds: float, device) -> dict:
    """One traced run of `cell` (harness.run) whose stretch's idle device
    time is put down to the port's spans; the numbers per unit of the
    stretch."""
    from benchmark import harness, trace

    kept, device_work = [], trace._device_work

    def keep(prof):
        kept.append(device_work(prof))
        return kept[-1]

    tr = recorded()
    tr.clear()
    trace._device_work = keep
    try:
        result = harness.run(cell, seed, seconds, True, device, T0)
    finally:
        trace._device_work = device_work
    busy, spans = trace._merge(kept[-1]), tr.spans
    start = min([b[0] for b in busy[:1]] + [s.t0_ns for s in spans])
    end = max([b[1] for b in busy[-1:]] + [s.t1_ns for s in spans])
    labelled = by_label(idle_by_span(busy, spans, start, end), spans)
    units = sum(s.name == UNITS[cell.traffic["kind"]] for s in spans)
    return {"workload": cell.name, "seed": seed, "card": result["card"], "correct": result["correct"],
            "units": units, "wall_s": result["device"].get("window_s"), "busy_s": result["device"].get("busy_s"),
            "idle_attributed_s": sum(labelled.values()) * 1e-9,
            "idle_first_to_last_op_s": sum(b - a for a, b in idle_gaps(busy, busy[0][0], busy[-1][1])) * 1e-9
            if busy else 0.0,
            "idle_ms_per_unit": {k: ns * 1e-6 / units for k, ns in sorted(labelled.items(), key=lambda kv: -kv[1])},
            "krylov_idle_ms": krylov_ns(labelled) * 1e-6 / units,
            "outside_idle_ms": (labelled.get("outside", 0) + labelled.get("step", 0)) * 1e-6 / units,
            "counters_per_unit": {k: v / units for k, v in tr.counters.items()},
            "fgmres_per_unit": {k: sum(s.attrs[k] for s in spans if s.name == "fgmres") / units
                                for k in ("iters", "restarts")},
            "metrics": result["metrics"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("[progtrace] needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(attributed(harness.load_cell(args.workload, ROOT), args.seed, args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
