"""Blocking device reads per Adam step: the port's `host_syncs` counter
(utils/timers.py `host_read`) over the profiled stretch, per `step` span
recorded there (benchmark/progtrace.py).  None where the port has no
tracer."""

from benchmark import progtrace


def read(r):
    return progtrace.per_unit("train", lambda tr: tr.counters.get("host_syncs", 0))
