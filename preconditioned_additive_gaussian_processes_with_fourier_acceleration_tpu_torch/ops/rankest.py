"""Rank estimation for the AFN preconditioner (port of ops/rankest.py).

Rebuild of SRC/linearalg/rankest.c (+ MATLAB afn_setup.m:111-292):

- estimate_rank (Nfft4GPRankestNysScaled, rankest.c:248-392): subsample m
  points, scale the coordinates by (m/n)^(1/d), FPS-order them, and find the
  smallest rank whose Nystrom approximation has relative Frobenius error
  below tol; scale it back by n/m and average over nsample_r subsamples.
- rankest_default (Nfft4GPRankestDefault, rankest.c:133-179): the
  eigen-count and fill-distance-knee estimate on the subsamples, then FPS on
  the full set with the learned fill-distance tolerance.

The JAX package draws each subsample with jax.random.choice from a chain of
split keys, a stream torch cannot reproduce.  Here the subsamples come from
a torch.Generator, or are passed in as index arrays (`subsamples`, one per
repeat), which is how the tests hand over JAX's draws.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .fps import fps
from .kernels import KernelParams, kernel_matrix


class RankestConfig(NamedTuple):
    nsample: int = 500       # subsample size (rankest.c:3-17)
    nsample_r: int = 2       # repeats (C default 5; the JAX package uses 2)
    max_rank: int = 2000
    full_tol: float = 0.9    # if k > full_tol * nsample -> "not low rank"
    tol: float = 0.1         # relative Frobenius error target


def draw_subsamples(n: int, cfg: RankestConfig, generator: Optional[torch.Generator] = None):
    """nsample_r index tensors of min(nsample, n) distinct points each."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    m = min(cfg.nsample, n)
    return [torch.randperm(n, generator=gen, device=gen.device)[:m] for _ in range(cfg.nsample_r)]


def _subsamples(X, cfg, generator, subsamples):
    subs = subsamples if subsamples is not None else draw_subsamples(X.shape[0], cfg, generator)
    if len(subs) != cfg.nsample_r:
        raise ValueError(f"{len(subs)} subsamples for nsample_r = {cfg.nsample_r}")
    return [(s if isinstance(s, torch.Tensor) else torch.from_numpy(np.array(s, dtype=np.int64)))
            .to(device=X.device, dtype=torch.int64) for s in subs]


def nystrom_error_curve(kind: str, params: KernelParams, Xs, ranks):
    """Relative Frobenius Nystrom error of the FPS-ordered subsample Xs at
    each rank in `ranks` (ref rankest.c:183-242 NysError).

    With K + nu I = L L' (nu = sqrt(m) ulp(||K||_F)), the rank-k Nystrom
    factor is L[:, :k], so the error matrix is L[:, k:] L[:, k:]' and its
    squared norm the sum of C_ij^2 over i, j >= k, C = L'L: one suffix sum
    gives every rank (the JAX package forms each difference matrix)."""
    m = Xs.shape[0]
    K = kernel_matrix(kind, params, Xs)
    fro = torch.linalg.norm(K)
    ulp = torch.nextafter(fro, torch.full_like(fro, float("inf"))) - fro
    L = torch.linalg.cholesky(K + float(m) ** 0.5 * ulp * torch.eye(m, dtype=K.dtype, device=K.device))
    C2 = (L.T @ L) ** 2
    tail = torch.flip(torch.cumsum(torch.flip(C2, (0, 1)), 0).cumsum(1), (0, 1))  # [k, l] = sum_{i>=k, j>=l}
    resid = torch.cat([torch.diagonal(tail), tail.new_zeros(1)])                 # rank k keeps columns < k
    ranks = torch.as_tensor(ranks, device=K.device)
    return torch.sqrt(torch.clamp(resid[ranks], min=0.0)) / fro


def _eigs(kind, params, Xs):
    return torch.linalg.eigvalsh(kernel_matrix(kind, params, Xs))


def eigencurve_rank(kind: str, params: KernelParams, X, idx, thresh_factor: float = 1.1):
    """Eigen-curve rank estimate (rankest.c:30-179; afn_setup.m:230-292): the
    eigenvalues of the subsample X[idx] above thresh_factor * noise, scaled
    back to the full set."""
    n, m = X.shape[0], idx.shape[0]
    noise = params.f * params.f * params.mu
    count = int(torch.sum(_eigs(kind, params, X[idx]) > thresh_factor * noise))
    return max(1, int(np.ceil(count * n / m)))


def fill_distance_estimate(kind: str, params: KernelParams, X, idx, thresh_factor: float = 1.1,
                           knee_tol: float = 0.41, knee_tol2: float = 0.2):
    """Eigen-count + fill-distance-knee estimate on the subsample X[idx]
    (rankest.c:30-128).  Returns (est_rank, h): the refined rank and the
    fill-distance tolerance h = dist[rank] of the full-set FPS stage."""
    m = idx.shape[0]
    Xs = X[idx]
    eigs = _eigs(kind, params, Xs).cpu().numpy()
    dists = fps(Xs, m).dists.cpu().numpy()
    noise = float(params.f) ** 2 * float(params.mu)
    rank = max(int(np.sum(eigs > thresh_factor * noise)), 1)
    rank2 = rank - 1
    # knee walk-down (rankest.c:103-112)
    r = rank
    while r > 1:
        r -= 1
        jump = (dists[r - 1] - dists[r]) / dists[r] if dists[r] > 0 else np.inf
        if jump > knee_tol or dists[r] <= (1.0 + knee_tol2) * dists[rank2]:
            break
    return r + 1, float(dists[min(r, m - 1)])


def rankest_default(kind: str, params: KernelParams, X, generator=None,
                    cfg: RankestConfig = RankestConfig(), *, maxrank: int = 2000, subsamples=None):
    """Eigen-curve rank estimation with fill-distance refinement
    (rankest.c:133-179): average h over the subsamples; if the mean estimated
    rank fraction exceeds full_tol, the data is "not low rank" (maxrank);
    otherwise FPS on the full set, counting the landmarks whose fill
    distance is >= h.  Returns (rank, perm): rank <= maxrank and the full-set
    FPS prefix (maxrank,) as numpy."""
    n = X.shape[0]
    m = min(cfg.nsample, n)
    hs, est_total = [], 0
    for idx in _subsamples(X, cfg, generator, subsamples):
        est, h = fill_distance_estimate(kind, params, X, idx)
        hs.append(h)
        est_total += est
    h = float(np.mean(hs))
    maxrank = min(maxrank, n)
    res = fps(X, maxrank)
    perm = res.perm.cpu().numpy()
    if est_total / float(m * cfg.nsample_r) > cfg.full_tol:
        return maxrank, perm
    rank = int(np.sum(res.dists.cpu().numpy() >= h))     # dists[0] = inf always counts
    return int(np.clip(rank, 1, maxrank)), perm


def estimate_rank(kind: str, params: KernelParams, X, generator=None,
                  cfg: RankestConfig = RankestConfig(), *, subsamples=None) -> int:
    """Scaled-subsample Nystrom-error rank estimate (a Python int: it sizes
    arrays)."""
    n, d = X.shape
    m = min(cfg.nsample, n)
    scale = (m / n) ** (1.0 / d)
    ranks = torch.arange(1, m + 1)
    ests = []
    for idx in _subsamples(X, cfg, generator, subsamples):
        Xs = X[idx] * scale
        curve = nystrom_error_curve(kind, params, Xs[fps(Xs, m).perm], ranks)
        below = (curve < cfg.tol).cpu().numpy()
        k = int(np.argmax(below)) + 1 if below.any() else m
        ests.append(k * n / m)
    return min(int(np.ceil(float(np.mean(ests)))), cfg.max_rank, n)
