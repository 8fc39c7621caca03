"""Permutation helpers (port of utils/datasets.py).

Randomness comes from an explicit `torch.Generator`.  Its stream differs
from that of the JAX package's keys, so parity tests draw with numpy or JAX
and inject.
"""

import torch


def rand_perm(generator: torch.Generator, n: int, k: int | None = None):
    """Random permutation of n, optionally truncated to the first k entries.

    Ref: Nfft4GPRandPerm (SRC/utils/utils.h:82).  The permutation is drawn on
    the generator's device.
    """
    perm = torch.randperm(n, generator=generator, device=generator.device)
    if k is not None:
        perm = perm[:k]
    return perm
