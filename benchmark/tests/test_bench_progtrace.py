"""The port's spans in a profiled stretch (benchmark/progtrace.py): the
attribution of idle device time on synthetic intervals, and the readers of
the port's counters on tiny traced CPU cells."""

import time
from typing import NamedTuple

import pytest

from benchmark import harness, progtrace
from benchmark.tests.conftest import tiny_cell


class Span(NamedTuple):
    id: int
    parent: object
    name: str
    t0_ns: int
    t1_ns: int
    attrs: dict = {}


def test_a_gap_is_split_over_two_spans():
    busy = [(0, 10, "a"), (30, 40, "b")]
    spans = [Span(0, None, "x", 5, 20), Span(1, None, "y", 20, 35)]
    assert progtrace.idle_by_span(busy, spans) == {0: 10, 1: 10}


def test_a_gap_outside_every_span_goes_to_none():
    busy = [(0, 10, "a"), (30, 40, "b"), (50, 60, "c")]
    spans = [Span(0, None, "x", 12, 18)]
    assert progtrace.idle_by_span(busy, spans) == {0: 6, None: 24}


def test_the_innermost_of_nested_spans_wins():
    busy = [(0, 10, "a"), (100, 110, "b")]
    spans = [Span(2, 1, "sync", 40, 50), Span(1, 0, "fgmres", 20, 80), Span(0, None, "step", 5, 105)]
    idle = progtrace.idle_by_span(busy, spans)
    assert idle == {0: 10 + 20, 1: 20 + 30, 2: 10}
    labelled = progtrace.by_label(idle, spans)
    assert labelled == {"step": 30, "fgmres": 50, "fgmres/sync": 10}
    assert progtrace.krylov_ns(labelled) == 60


def test_the_parts_sum_to_the_stretch_idle():
    busy = [(3, 7, "a"), (9, 30, "b"), (31, 33, "c"), (70, 71, "d")]
    spans = [Span(0, None, "step", 0, 60), Span(1, 0, "loss", 2, 50), Span(2, 1, "slq", 8, 40),
             Span(3, 2, "sync", 29, 32), Span(4, None, "step", 65, 90), Span(5, 4, "sync", 66, 69)]
    idle = progtrace.idle_by_span(busy, spans, 0, 100)
    gaps = progtrace.idle_gaps(busy, 0, 100)
    assert sum(idle.values()) == sum(b - a for a, b in gaps) == 100 - (4 + 21 + 2 + 1)
    assert idle[None] == 5 + 10       # 60-65 between the steps, 90-100 after them
    assert idle[3] == 1               # 30-31 inside the sync under slq


def _traced(name):
    timers = harness.port("utils.timers")
    timers.profiled().clear()
    out = harness.run(tiny_cell(name), 2200000017, 0.0, True, "cpu", time.perf_counter())
    return out, timers


@pytest.mark.parametrize("name, metrics", [
    ("gauss-add-1e6.train", ("host_syncs.train",)),
    ("gauss-add-1e6.predict", ("host_syncs.predict", "fgmres_iters.predict")),
])
def test_readers_on_a_traced_cpu_cell(name, metrics):
    out, timers = _traced(name)
    tr = timers.profiled()
    kind = "step" if name.endswith("train") else "predict"
    units = sum(s.name == kind for s in tr.spans)
    assert units == tiny_cell(name).traffic["profile_units"]
    for m in metrics:
        assert out["metrics"][m]["value"] > 0
    assert out["metrics"][metrics[0]]["value"] == tr.counters["host_syncs"] / units
    if kind == "predict":
        iters = [s.attrs["iters"] for s in tr.spans if s.name == "fgmres"]
        assert out["metrics"]["fgmres_iters.predict"]["value"] == sum(iters) / units
    timers.profiled().clear()


def test_an_untraced_run_leaves_the_record_empty():
    timers = harness.port("utils.timers")
    timers.profiled().clear()
    out = harness.run(tiny_cell("gauss-add-1e6.predict"), 2200000018, 0.0, False, "cpu", time.perf_counter())
    assert out["correct"] and not timers.profiled().spans and not timers.profiled().counters


def test_readers_read_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setattr(progtrace, "PORT", "no_such_port")
    reading = harness.Reading(cell=tiny_cell("gauss-add-1e6.train"), units=1, spans={}, span_units=0, launches={},
                              stretch=None, stretch_launches={})
    for m in ("host_syncs.train", "host_syncs.predict", "fgmres_iters.predict"):
        assert harness.read_metric(m, reading) is None


def test_the_attribution_of_a_traced_cpu_cell():
    out = progtrace.attributed(tiny_cell("gauss-add-1e6.train"), 2200000019, 0.0, "cpu")
    assert out["units"] == 3 and out["correct"]
    assert out["counters_per_unit"]["host_syncs"] == out["metrics"]["host_syncs.train"]["value"]
    # no device operations: the spans' whole extent is idle, each part given to a span
    assert out["idle_first_to_last_op_s"] == 0.0 and out["idle_attributed_s"] > 0
    parts = out["idle_ms_per_unit"]
    assert sum(parts.values()) * out["units"] * 1e-3 == pytest.approx(out["idle_attributed_s"], rel=1e-9)
    assert {"step", "loss", "fgmres", "fgmres/sync", "slq/sync", "step/sync"} <= set(parts)
    assert out["krylov_idle_ms"] == pytest.approx(sum(v for k, v in parts.items()
                                                      if k.split("/")[0] in ("fgmres", "slq")), rel=1e-9)
