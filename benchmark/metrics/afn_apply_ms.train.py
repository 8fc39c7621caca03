"""Host milliseconds inside the `afn_solve` span (spans.json: AFN's
M^-1 apply, AfnPrecond.solve, for FGMRES and SLQ) per Adam step of the
window."""


def read(r):
    return r.per_unit_ms("afn_solve")
