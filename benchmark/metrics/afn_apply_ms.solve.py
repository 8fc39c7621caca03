"""Host milliseconds inside the `precond_apply` span (spans.json: the AFN
preconditioner's solve handed to PCG) per request of the window."""


def read(r):
    return r.per_unit_ms("precond_apply")
