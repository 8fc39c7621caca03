"""Basis rows FGMRES's CGS2 projects against, per request: the port's
`cgs2_rows` counter (solvers/fgmres.py) over the profiled stretch, per
`predict` span recorded there (benchmark/progtrace.py).  None where the
port has no tracer or does not keep the counter."""

from benchmark import progtrace


def read(r):
    tr = progtrace.recorded()
    if tr is None or "cgs2_rows" not in tr.counters:
        return None
    return progtrace.per_unit("predict", lambda tr: tr.counters["cgs2_rows"])
