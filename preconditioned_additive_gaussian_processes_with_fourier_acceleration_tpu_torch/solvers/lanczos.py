"""Preconditioned Lanczos and stochastic Lanczos quadrature (port of
solvers/lanczos.py).

The recursion keeps the pair of bases V (preconditioned side, v = M^{-1} z)
and Z (A side), normalized by sqrt(v' z), and records the tridiagonal via
two-basis CGS2 (ref SRC/solvers/lanczos.c, matops.c:346-433).

Every recursion here is BATCHED over right-hand sides: `lanczos_batch`
runs the Lanczos of all rows of B in lockstep on one (nv, n) matvec, so the
operator's streamed kernels read their phase table once per step for all
probes.  A row whose recursion breaks down freezes, exactly as the JAX
version's vmapped while-loop freezes it; the loop exits when all rows stop.

SLQ (ref lanczos.c:421-610), per Rademacher probe z:
  logdet/n    ~ mean_probes sum_j (e1' v_j)^2 log|theta_j|  + logdet(M)/n
  dlogdet_i/n ~ mean_probes [(dA_i z)' x - (M^{-1} dM_i z)' z]/n + tr(M^{-1} dM_i)/n

Under a row-sharded process group (`group`, parallel/mesh.py) each rank
holds its rows of the probes and of every basis vector; the sums over
points (norms, v'z, the CGS2 projections, the SLQ contractions) are local
partials summed over the ranks, and n is the global count.
"""

from typing import Callable, NamedTuple, Optional

import torch

from .reductions import psum


class LanczosResult(NamedTuple):
    x: torch.Tensor        # approximate solutions of A x = b, (nv, n)
    alpha: torch.Tensor    # TD, (nv, maxits), identity-padded past tsize
    beta: torch.Tensor     # TE, (nv, maxits-1), zero-padded past tsize-1
    tsize: torch.Tensor    # (nv,) effective tridiagonal sizes
    relres: torch.Tensor   # (nv,)
    niter: torch.Tensor    # (nv,)


def _row_norm(X, group):
    """The 2-norms of the rows of X over all points."""
    if group is None:
        return torch.linalg.norm(X, dim=1)
    return torch.sqrt(group.psum(torch.sum(X * X, dim=1)))


def _where(mask, new, old):
    """Row-wise select: mask (nv,) broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def lanczos_batch(
    matvec: Callable,
    B: torch.Tensor,
    *,
    precond: Optional[Callable] = None,
    maxits: int = 50,
    full_reorth: bool = True,
    wsize: Optional[int] = None,
    tol: float = 0.0,
    atol: bool = False,
    group=None,
) -> LanczosResult:
    """Preconditioned Lanczos (x0 = 0) on every row of B (nv, n) at once.

    matvec and precond map (nv, n) -> (nv, n).  tol=0 runs maxits steps
    unless a recursion breaks down (the SLQ setting).  wsize limits the
    reorthogonalization window; full_reorth=False is the three-term
    recursion.  group: the points axis's process group; B and the
    operators are then this rank's columns.
    """
    nv, n = B.shape
    dtype, dev = B.dtype, B.device
    psolve = precond if precond is not None else (lambda r: r)
    eps = torch.finfo(dtype).eps
    one = torch.ones((), dtype=dtype, device=dev)

    def safe(v):
        return torch.where(v == 0, one, v)

    z0 = B
    v0 = psolve(z0)
    beta0 = torch.sqrt(torch.clamp(psum(torch.sum(v0 * z0, dim=1), group), min=0.0))
    normb = _row_norm(B, group)
    tolb = torch.full_like(normb, tol) if atol else tol * normb

    V = torch.zeros((nv, maxits + 1, n), dtype=dtype, device=dev)
    Z = torch.zeros_like(V)
    V[:, 0] = v0 / safe(beta0)[:, None]
    Z[:, 0] = z0 / safe(beta0)[:, None]
    TD = torch.ones((nv, maxits), dtype=dtype, device=dev)
    TE = torch.zeros((nv, max(maxits - 1, 1)), dtype=dtype, device=dev)
    TLD = torch.zeros(nv, dtype=dtype, device=dev)
    ls = torch.zeros(nv, dtype=dtype, device=dev)
    normr = normb.clone()
    it = torch.zeros(nv, dtype=torch.int64, device=dev)
    stop = beta0 < eps
    rows = torch.arange(maxits + 1, device=dev)

    # active rows all sit at the same step k: a row is active at step k only
    # if it was active at every earlier step
    for k in range(maxits):
        active = ~stop
        if not bool(active.any()):
            break
        w = matvec(V[:, k])
        if full_reorth:
            wmask = ((rows > k - wsize) & (rows <= k)).to(dtype) if wsize is not None else 1.0
            t1 = psum(torch.einsum("vjn,vn->vj", V, w), group) * wmask
            w = w - torch.einsum("vj,vjn->vn", t1, Z)
            t2 = psum(torch.einsum("vjn,vn->vj", V, w), group) * wmask
            w = w - torch.einsum("vj,vjn->vn", t2, Z)
            coeff = t1 + t2
            td = coeff[:, k]
            te = coeff[:, k - 1] if k > 0 else torch.zeros_like(td)
        else:
            td = psum(torch.sum(V[:, k] * w, dim=1), group)
            te = psum(torch.sum(V[:, max(k - 1, 0)] * w, dim=1), group) if k > 0 else torch.zeros_like(td)
            w = w - td[:, None] * Z[:, k] - te[:, None] * Z[:, max(k - 1, 0)]

        t = _row_norm(w, group)
        break1 = t < eps
        vnew = psolve(w)
        dotvz = torch.sqrt(torch.clamp(psum(torch.sum(vnew * w, dim=1), group), min=0.0))
        break2 = dotvz < eps
        keep = ~(break1 | break2)
        zero = torch.zeros_like(w)
        V[:, k + 1] = _where(active, _where(keep, vnew / safe(dotvz)[:, None], zero), V[:, k + 1])
        Z[:, k + 1] = _where(active, _where(keep, w / safe(dotvz)[:, None], zero), Z[:, k + 1])
        TD[:, k] = torch.where(active & ~break1, td, TD[:, k])
        if k > 0:
            TE[:, k - 1] = torch.where(active & ~break1, te, TE[:, k - 1])

        # incremental Cholesky residual estimate (ref lanczos.c:223-247)
        normz = _row_norm(Z[:, k + 1], group)
        if k == 0:
            tld_new = torch.sqrt(torch.clamp(td, min=0.0))
            tle_new = torch.zeros_like(td)
        else:
            tld_new = torch.sqrt(torch.clamp(td - (te / safe(TLD)) ** 2, min=0.0))
            tle_new = te / safe(TLD)
        if k == 0:
            ls_new = 1.0 / safe(tld_new)
            normr_new = dotvz / safe(td) * beta0 * normz
        else:
            ls_new = -ls * tle_new / safe(tld_new)
            normr_new = torch.abs(ls_new / safe(tld_new)) * dotvz * beta0 * normz
        normr_est = torch.where(keep, normr_new, normr)

        TLD = torch.where(active, tld_new, TLD)
        ls = torch.where(active, ls_new, ls)
        normr = torch.where(active, normr_est, normr)
        it = it + active.to(it.dtype)
        stop = stop | (active & (break1 | break2 | (normr_est <= tolb)))

    tsize = it
    idx = torch.arange(maxits, device=dev)
    TD = torch.where(idx[None, :] < tsize[:, None], TD, one)
    if maxits > 1:
        eidx = torch.arange(maxits - 1, device=dev)
        TE = torch.where(eidx[None, :] < tsize[:, None] - 1, TE[:, : maxits - 1], 0.0 * one)
    else:
        TE = torch.zeros((nv, 0), dtype=dtype, device=dev)

    # x = V[:tsize]^T y with T y = beta0 e1 (ref lanczos.c:262-283)
    T = _tridiag(TD, TE)
    e1 = torch.zeros((nv, maxits), dtype=dtype, device=dev)
    e1[:, 0] = beta0
    y = torch.linalg.solve(T, e1)
    y = torch.where(idx[None, :] < tsize[:, None], y, 0.0 * one)
    x = torch.einsum("vj,vjn->vn", y, V[:, :maxits])
    return LanczosResult(x=x, alpha=TD, beta=TE, tsize=tsize,
                         relres=normr / safe(normb), niter=it)


def _tridiag(diag, off):
    """Batched symmetric tridiagonal matrices from (nv, m) and (nv, m-1)."""
    T = torch.diag_embed(diag)
    if off.shape[-1] > 0:
        T = T + torch.diag_embed(off, 1) + torch.diag_embed(off, -1)
    return T


def lanczos(matvec: Callable, b: torch.Tensor, *, precond: Optional[Callable] = None,
            **kw) -> LanczosResult:
    """Single right-hand side Lanczos: matvec and precond map (n,) -> (n,).
    Results carry the batch axis of length 1 (see lanczos_batch)."""
    ps = None if precond is None else (lambda R: precond(R[0])[None])
    return lanczos_batch(lambda V: matvec(V[0])[None], b[None], precond=ps, **kw)


class SlqResult(NamedTuple):
    logdet: torch.Tensor       # logdet(K)/n estimate
    dlogdet: torch.Tensor      # (p,) trace terms tr(K^{-1} dK_i)/n


def rademacher_probes(generator: torch.Generator, nvecs: int, n: int, dtype=None):
    """Rademacher +-1 probe matrix (nvecs, n) on the generator's device."""
    dtype = dtype or torch.get_default_dtype()
    bits = torch.randint(0, 2, (nvecs, n), generator=generator, device=generator.device)
    return (2 * bits - 1).to(dtype)


def slq_logdet(matvec: Callable, dmatvec: Callable, probes: torch.Tensor, *,
               maxits: int = 10, precond=None, group=None) -> SlqResult:
    """SLQ for logdet(K)/n and tr(K^{-1} dK_i)/n, all probes in lockstep.

    matvec: (nv, n) -> (nv, n); dmatvec: (nv, n) -> (nv, p, n).
    precond: optional object with .solve/.dvp on (nv, n) rows and
    .logdet()/.trace(); Lanczos then runs on M^{-1}K and the estimate is
    corrected by logdet(M)/n and tr(M^{-1} dM_i)/n (ref lanczos.c:456-466).
    group: the points axis's process group; probes are then this rank's
    columns, and precond's logdet and trace come out the same on every rank.
    """
    nvecs, n = probes.shape
    if group is not None:
        n = group.n_global(n)
    psolve = precond.solve if precond is not None else None
    res = lanczos_batch(matvec, probes, precond=psolve, maxits=maxits, tol=0.0, group=group)

    # NaN trim per probe: keep the leading finite block of the tridiagonal
    # (ref lanczos.c:526-548); trimmed diagonal entries pad with 1
    idx = torch.arange(maxits, device=probes.device)
    big = torch.full_like(res.alpha, maxits, dtype=torch.int64)
    keep = torch.min(torch.where(~torch.isfinite(res.alpha), idx.expand_as(big), big), dim=1).values
    alpha = torch.where(idx[None, :] < keep[:, None], res.alpha, 1.0)
    beta = res.beta
    if maxits > 1:
        eidx = torch.arange(maxits - 1, device=probes.device)
        bigb = torch.full_like(res.beta, maxits, dtype=torch.int64)
        keepb = torch.min(torch.where(~torch.isfinite(res.beta), (eidx + 1).expand_as(bigb), bigb), dim=1).values
        keep = torch.minimum(keep, keepb)
        alpha = torch.where(idx[None, :] < keep[:, None], res.alpha, 1.0)
        beta = torch.where(eidx[None, :] < keep[:, None] - 1, res.beta, 0.0)
    theta, vecs = torch.linalg.eigh(_tridiag(alpha, beta))
    vals = torch.sum(vecs[:, 0, :] ** 2 * torch.log(torch.abs(theta)), dim=1)

    dAz = dmatvec(probes)                                   # (nv, p, n)
    x = torch.where(torch.isfinite(res.x), res.x, 0.0)
    dvals = torch.einsum("vpn,vn->vp", dAz, x)
    if precond is not None:
        dvals = dvals - torch.einsum("vpn,vn->vp", precond.dvp(probes), probes)
    dvals = psum(dvals, group)
    logdet = torch.mean(vals)
    dlogdet = torch.mean(dvals, dim=0) / n
    if precond is not None:
        logdet = logdet + precond.logdet() / n
        dlogdet = dlogdet + precond.trace() / n
    return SlqResult(logdet=logdet, dlogdet=dlogdet)
