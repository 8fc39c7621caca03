from . import config, datasets  # noqa: F401
from .config import default_real_dtype  # noqa: F401
from .datasets import expand_perm, generate_grid2d, generate_uniform, rand_perm  # noqa: F401
