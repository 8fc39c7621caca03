from .nystrom import NystromPrecond, nystrom_setup  # noqa: F401
