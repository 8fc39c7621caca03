"""Blocking device reads per request: the port's `host_syncs` counter
(utils/timers.py `host_read`) over the profiled stretch, per `predict`
span recorded there (benchmark/progtrace.py).  None where the port has no
tracer."""

from benchmark import progtrace


def read(r):
    return progtrace.per_unit("predict", lambda tr: tr.counters.get("host_syncs", 0))
