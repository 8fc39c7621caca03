"""Synthetic dataset generators and permutation helpers (port of
utils/datasets.py).

Randomness comes from an explicit `torch.Generator`.  Its stream differs
from that of the JAX package's keys, so parity tests draw with numpy or JAX
and inject.
"""

import torch


def generate_uniform(generator: torch.Generator, n: int, d: int, low: float = 0.0, high: float = 1.0,
                     dtype=None):
    """n uniform random points in [low, high)^d, shape (n, d), on the
    generator's device (ref Nfft4GPDatasetUniformRandom, SRC/utils/utils.c)."""
    dtype = dtype or torch.get_default_dtype()
    u = torch.rand((n, d), generator=generator, dtype=dtype, device=generator.device)
    return low + (high - low) * u


def generate_grid2d(nx: int, ny: int, dtype=None, device=None):
    """Regular 2-D grid of nx*ny points in [0, 1]^2, shape (nx*ny, 2), the
    first coordinate varying slowest (indexing="ij"; ref
    Nfft4GPDatasetRegular2D, SRC/utils/utils.c)."""
    dtype = dtype or torch.get_default_dtype()

    def unit(m):
        # i * (1 / (m - 1)) in the dtype and the endpoint 1, as the JAX
        # package's jnp.linspace(0, 1, m) comes out of XLA (torch's linspace
        # rounds some entries the other way)
        t = torch.arange(m, dtype=dtype, device=device)
        if m > 1:
            t = t * torch.reciprocal(torch.tensor(m - 1, dtype=dtype, device=device))
            t[-1] = 1.0
        return t

    xs, ys = unit(nx), unit(ny)
    xx, yy = torch.meshgrid(xs, ys, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)


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
