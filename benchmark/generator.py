"""The benchmark's one traffic generator: inputs made on the device from the seed.

Everything a run feeds the program comes from here, from `--seed` alone:
the points and labels (uniform features in [0, 1]^d, y = sin 3 x0 + cos 2 x3
+ 0.1 noise, the generator of chip_smoke.py's `make_data`), the SLQ
probes, the Nystrom landmarks and each prediction request's test points;
for a solve, the sites (uniform in [0, 1]^d) and each request's right-hand
side (N(0, 1) entries).  The same seed gives the same inputs, and each
part draws from a generator of its own, so a cell that uses fewer parts
draws the others unchanged.
"""

from typing import NamedTuple

import torch

# sub-streams of one seed
_DATA, _PROBES, _LANDMARKS, _REQUEST, _SITES, _RHS = 1, 2, 3, 4, 5, 6
_MASK63 = (1 << 63) - 1


def generator(seed: int, stream: int, device, index: int = 0) -> torch.Generator:
    """A generator for one part of one seed's inputs (any integer seed)."""
    key = (int(seed) * 1_000_003 + stream * 7_919 + index * 104_729) & _MASK63
    return torch.Generator(device=device).manual_seed(key)


class Inputs(NamedTuple):
    X: torch.Tensor                  # (n, d) float32
    y: torch.Tensor                  # (n,) float32
    probes: torch.Tensor             # (nvecs, n) float32 +-1
    landmarks: torch.Tensor          # (rank,) int64


def points(n: int, d: int, gen: torch.Generator, device, sort_feature=None):
    """Uniform features and the smooth label with 0.1 Gaussian noise; rows
    in ascending order of one feature, as a data file sorted by a key has
    them, when `sort_feature` is given."""
    X = torch.rand((n, d), generator=gen, device=device, dtype=torch.float32)
    noise = torch.randn((n,), generator=gen, device=device, dtype=torch.float32)
    y = torch.sin(3.0 * X[:, 0]) + torch.cos(2.0 * X[:, 3]) + 0.1 * noise
    if sort_feature is not None:
        order = torch.argsort(X[:, sort_feature])
        X, y = X[order], y[order]
    return X, y


def make_inputs(config: dict, seed: int, device) -> Inputs:
    n, d = config["n"], config["d"]
    p = config["problem"]
    X, y = points(n, d, generator(seed, _DATA, device), device, config.get("sort_feature"))
    bits = torch.randint(0, 2, (p["nvecs"], n), generator=generator(seed, _PROBES, device), device=device)
    probes = (2 * bits - 1).to(torch.float32)
    landmarks = torch.randperm(n, generator=generator(seed, _LANDMARKS, device), device=device)[: p["rank"]]
    return Inputs(X=X, y=y, probes=probes, landmarks=landmarks)


def test_points(config: dict, traffic: dict, seed: int, index: int, device):
    """The test points of prediction request `index`."""
    m = int(round(config["n"] * traffic["test_points_per_train_point"]))
    gen = generator(seed, _REQUEST, device, index + 1)
    return torch.rand((m, config["d"]), generator=gen, device=device, dtype=torch.float32)


class Sites(NamedTuple):
    X: torch.Tensor                  # (n, d) float32


def solve_inputs(config: dict, seed: int, device) -> Sites:
    """The sites of a solve deployment: uniform in [0, 1]^d, float32."""
    gen = generator(seed, _SITES, device)
    return Sites(X=torch.rand((config["n"], config["d"]), generator=gen, device=device, dtype=torch.float32))


def rhs(config: dict, seed: int, index: int, device):
    """The right-hand side b (n,) of solve request `index`: N(0, 1) entries,
    float32."""
    gen = generator(seed, _RHS, device, index + 1)
    return torch.randn((config["n"],), generator=gen, device=device, dtype=torch.float32)
