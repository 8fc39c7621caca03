"""Host milliseconds inside the `afn_dvp` span (spans.json: AFN's
M^-1 dM_j z over the SLQ probes, AfnPrecond.dvp) per Adam step of the
window."""


def read(r):
    return r.per_unit_ms("afn_dvp")
