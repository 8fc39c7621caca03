from . import transforms, adam, gp, problem  # noqa: F401
