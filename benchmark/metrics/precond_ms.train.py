"""Host milliseconds inside the `precond` span (spans.json) per unit of the window."""


def read(r):
    return r.per_unit_ms("precond")
