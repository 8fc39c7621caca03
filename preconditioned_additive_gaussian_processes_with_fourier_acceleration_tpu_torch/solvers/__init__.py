from . import reductions, fgmres, lanczos  # noqa: F401
