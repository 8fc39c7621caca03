"""FGMRES iterations per request: the `iters` of the port's `fgmres` spans
in the profiled stretch, per `predict` span recorded there
(benchmark/progtrace.py).  None where the port has no tracer."""

from benchmark import progtrace


def read(r):
    return progtrace.per_unit("predict", lambda tr: sum(s.attrs.get("iters", 0) for s in tr.spans
                                                         if s.name == "fgmres"))
