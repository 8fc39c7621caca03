from . import config, datasets  # noqa: F401
