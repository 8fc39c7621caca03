from . import distances, kernels, matops, packed_ndft, fastsum  # noqa: F401
