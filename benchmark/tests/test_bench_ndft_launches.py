"""The `ndft_launches.predict` reader on synthetic readings: the launch
counters summed over wrappers and shapes, per request; None where nothing
launched."""

from benchmark import harness
from benchmark.tests.conftest import tiny_cell


def _reading(units, launches):
    return harness.Reading(cell=tiny_cell("gauss-add-1e6.predict"), units=units, spans={}, span_units=0,
                           launches=launches, stretch=None, stretch_launches={})


def test_launches_per_request():
    launches = {"packed_adjoint": {}, "packed_forward": {},
                "packed_adjoint_regen": {"nv=1": 420, "nv=16": 2},
                "packed_forward_regen": {"nsets=1": 420, "nsets=16": 2},
                "packed_adjoint_wide": {}, "packed_forward_wide": {}}
    assert harness.read_metric("ndft_launches.predict", _reading(2, launches)) == 422.0


def test_nothing_launched_reads_none():
    empty = {"packed_adjoint_regen": {}, "packed_forward_regen": {}}
    assert harness.read_metric("ndft_launches.predict", _reading(3, empty)) is None
    assert harness.read_metric("ndft_launches.predict", _reading(3, {})) is None
    assert harness.read_metric("ndft_launches.predict", _reading(0, {"packed_adjoint_regen": {"nv=1": 5}})) is None
