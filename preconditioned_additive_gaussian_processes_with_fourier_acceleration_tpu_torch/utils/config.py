"""Numeric dtype helpers (port of utils/config.py).

Precision follows the input tensors.  The defaults follow torch's default
dtype: float64 for CPU parity runs that set it, float32 otherwise.
"""

import torch


def default_real_dtype():
    return torch.get_default_dtype()


def finfo_eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)
