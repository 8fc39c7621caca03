"""Host milliseconds inside the `fgmres` span (spans.json) per unit of the window."""


def read(r):
    return r.per_unit_ms("fgmres")
