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


def expand_perm(perm_prefix, n: int):
    """Complete a k-prefix permutation to a full n-permutation, the remaining
    indices appended in ascending order (ref Nfft4GPExpandPerm,
    SRC/utils/utils.h:141-149).  On the prefix's device."""
    perm_prefix = torch.as_tensor(perm_prefix)
    mask = torch.ones(n, dtype=torch.bool, device=perm_prefix.device)
    mask[perm_prefix] = False
    return torch.cat([perm_prefix, torch.nonzero(mask).flatten().to(perm_prefix.dtype)])
