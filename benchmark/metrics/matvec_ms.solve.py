"""Host milliseconds inside the `matvec` span (spans.json: the operator
closure handed to PCG) per request of the window."""


def read(r):
    return r.per_unit_ms("matvec")
