"""Host milliseconds inside the `op_build` span (spans.json) per unit of the window."""


def read(r):
    return r.per_unit_ms("op_build")
