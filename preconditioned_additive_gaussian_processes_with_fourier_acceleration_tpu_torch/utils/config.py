"""Numeric dtype helpers (port of utils/config.py).

Precision follows the input tensors.  The defaults follow torch's default
dtype: float64 for CPU parity runs that set it, float32 otherwise.
"""

import torch


def x64_enabled() -> bool:
    """True when torch's default floating dtype is float64 (the counterpart
    of JAX's jax_enable_x64)."""
    return torch.get_default_dtype() == torch.float64


def default_real_dtype():
    return torch.get_default_dtype()


def default_complex_dtype():
    return torch.complex128 if x64_enabled() else torch.complex64


def finfo_eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)
