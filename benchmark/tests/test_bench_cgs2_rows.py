"""The `cgs2_rows.predict` reader: on synthetic recordings, the port's
`cgs2_rows` counter per `predict` span of the recorded stretch, and None
without a tracer, without the counter, or without a request; on a tiny
traced CPU cell, the same division of what the port recorded."""

import time
from typing import NamedTuple

import pytest

from benchmark import harness, progtrace
from benchmark.tests.conftest import tiny_cell


class Span(NamedTuple):
    name: str


class Recorded(NamedTuple):
    spans: list
    counters: dict


def _reading():
    return harness.Reading(cell=tiny_cell("gauss-add-1e6.predict"), units=2, spans={}, span_units=0,
                           launches={}, stretch=None, stretch_launches={})


def _read(monkeypatch, recorded):
    monkeypatch.setattr(progtrace, "recorded", lambda: recorded)
    return harness.read_metric("cgs2_rows.predict", _reading())


def test_rows_per_request(monkeypatch):
    spans = [Span("fgmres"), Span("predict"), Span("sync"), Span("fgmres"), Span("predict")]
    recorded = Recorded(spans, {"cgs2_rows": 2 * 1830, "host_syncs": 1546})
    assert _read(monkeypatch, recorded) == 1830.0


@pytest.mark.parametrize("recorded", [
    None,                                                         # the port has no tracer
    Recorded([Span("predict")], {"host_syncs": 773}),             # nor the counter
    Recorded([Span("step")], {"cgs2_rows": 210}),                 # no request in the stretch
])
def test_nothing_to_read_reads_none(monkeypatch, recorded):
    assert _read(monkeypatch, recorded) is None


def test_rows_per_request_on_a_traced_cpu_cell():
    timers = harness.port("utils.timers")
    timers.profiled().clear()
    cell = tiny_cell("gauss-add-1e6.predict")
    out = harness.run(cell, 2200000021, 0.0, True, "cpu", time.perf_counter())
    tr = timers.profiled()
    units = sum(s.name == "predict" for s in tr.spans)
    assert units == cell.traffic["profile_units"] and tr.counters["cgs2_rows"] > 0
    assert out["metrics"]["cgs2_rows.predict"]["value"] == tr.counters["cgs2_rows"] / units
    timers.profiled().clear()
