"""Fused dense Krylov solves: a whole CG solve, or the Lanczos recursions of
all probes, in one kernel launch (port of solvers/pallas_pcg.py).

For a dense SPD K of n up to a few thousand (the multiclass and small
regression problems) a Krylov step is one matvec and a few dots, so a
solver that launches each op separately is bound by launch and host
latency, not by work.  The two kernels of csrc/fused_pcg.cu run every step
in one persistent cooperative launch:

- `fused_pcg_dense`: unpreconditioned CG on K x = b (replaces
  `_pcg_kernel`), returning (x, relres, niter);
- `fused_lanczos_dense`: the Lanczos recursions of the nv probes with
  two-pass classical Gram-Schmidt against the whole history (replaces
  `_lanczos_kernel`), returning (alpha, beta, V, beta0), the SLQ input.

Neither is wired into `gp_loss` (nor is its JAX counterpart): the shipped
solvers are solvers/pcg.py and solvers/lanczos.py.

Both work in float32, as the JAX functions cast; x comes back in b's
dtype.  Each has a plain torch version beside it.  The wrapper follows one
rule: a CPU tensor goes to the plain version; a CUDA tensor launches the
hand-written kernel (built at first use by ops/_cuda_build.py) and raises
if it cannot.  Each wrapper counts its launches in `.launches`.
"""

import torch

from ..ops import _cuda_build

# largest n either kernel takes (PCG keeps p, n floats, in shared memory)
MAX_N = 16384
# the Lanczos kernel's limits: probes per launch (per-thread accumulators)
# and steps (the coefficient history lives in shared memory)
MAX_NV = 16
MAX_ITS = 64
_EPS32 = torch.finfo(torch.float32).eps


def _safe(v):
    return torch.where(v == 0, torch.ones_like(v), v)


# --- plain versions ------------------------------------------------------------

def fused_pcg_dense_plain(K, b, *, maxits: int = 100, tol: float = 1e-6):
    """Plain torch CG with the TPU kernel's semantics: x = 0 start, the stop
    test on the squared recursion residual, breakdown on rho == 0 or
    pq <= 0, niter counting active steps.  Leaves the loop once stopped
    (every later step is a no-op)."""
    K32, b32 = K.to(torch.float32), b.to(torch.float32)
    nb2 = torch.sum(b32 * b32)
    safe_nb2 = _safe(nb2)
    tolb_sq = (tol * tol) * safe_nb2
    x = torch.zeros_like(b32)
    r, p = b32.clone(), b32.clone()
    normr_sq, rho_prev = nb2, torch.zeros_like(nb2)
    niter = 0
    stop = bool(nb2 <= tolb_sq)
    for it in range(maxits):
        if stop:
            break
        rho = torch.sum(r * r)
        if it > 0:
            p = r + (rho / _safe(rho_prev)) * p
        else:
            p = r.clone()
        q = K32 @ p
        pq = torch.sum(p * q)
        breakdown = bool(rho == 0.0) or bool(pq <= 0.0)
        alpha = torch.zeros_like(rho) if breakdown else rho / _safe(pq)
        x = x + alpha * p
        r = r - alpha * q
        normr_sq = torch.sum(r * r)
        niter += 1
        stop = breakdown or bool(normr_sq <= tolb_sq)
        rho_prev = rho
    relres = torch.sqrt(torch.clamp(normr_sq, min=0.0) / safe_nb2)
    return x.to(b.dtype), relres, torch.tensor(niter, dtype=torch.int32, device=b.device)


def fused_lanczos_dense_plain(K, Z, *, maxits: int = 10):
    """Plain torch batched Lanczos with the TPU kernel's semantics (M = I):
    w = v_it K, two CGS passes against the whole history, alpha = coeff[it],
    beta = coeff[it-1] (the reorthogonalization coefficient), the absolute
    break test ||w|| < float32 eps, identity/zero padding after a stop."""
    K32, Z32 = K.to(torch.float32), Z.to(torch.float32)
    nv, n = Z32.shape
    dev = Z32.device
    beta0 = torch.sqrt(torch.clamp(torch.sum(Z32 * Z32, dim=1), min=0.0))
    V = torch.zeros((nv, maxits + 1, n), dtype=torch.float32, device=dev)
    V[:, 0] = Z32 / _safe(beta0)[:, None]
    alpha = torch.ones((nv, maxits), dtype=torch.float32, device=dev)
    beta = torch.zeros((nv, max(maxits - 1, 0)), dtype=torch.float32, device=dev)
    stop = torch.zeros(nv, dtype=torch.bool, device=dev)
    for it in range(maxits):
        if bool(stop.all()):
            break
        w = V[:, it] @ K32
        coeff = torch.zeros((nv, maxits + 1), dtype=torch.float32, device=dev)
        for _ in range(2):
            t = torch.einsum("vjn,vn->vj", V, w)
            w = w - torch.einsum("vj,vjn->vn", t, V)
            coeff = coeff + t
        tn = torch.sqrt(torch.sum(w * w, dim=1))
        brk = tn < _EPS32
        live = ~stop & ~brk
        V[:, it + 1] = torch.where(live[:, None], w / _safe(tn)[:, None], 0.0)
        alpha[:, it] = torch.where(live, coeff[:, it], 1.0)
        if it > 0:
            beta[:, it - 1] = torch.where(live, coeff[:, it - 1], 0.0)
        stop = stop | brk
    return alpha, beta, V, beta0


# --- wrappers ------------------------------------------------------------------

def _check_square(K, n):
    if K.ndim != 2 or tuple(K.shape) != (n, n):
        raise ValueError(f"K must be ({n}, {n}), got {tuple(K.shape)}")


def _check_cuda(K, other, n):
    if other.device != K.device:
        raise ValueError(f"tensors on {K.device} and {other.device}")
    if n > MAX_N:
        raise ValueError(f"the fused CUDA kernels take n <= {MAX_N}, got {n}")


def fused_pcg_dense(K, b, *, maxits: int = 100, tol: float = 1e-6):
    """Solve K x = b (SPD dense K, no preconditioner) in one kernel launch.

    Replaces the TPU kernel `_pcg_kernel` (solvers/pallas_pcg.py).
    K (n, n), b (n,), both cast to float32.  Returns (x in b's dtype,
    relres float32, niter int32): the JAX `fused_pcg_dense` outputs."""
    n = b.shape[0]
    _check_square(K, n)
    if K.device.type == "cpu" and b.device.type == "cpu":
        return fused_pcg_dense_plain(K, b, maxits=maxits, tol=tol)
    if not (K.is_cuda and b.is_cuda):
        raise ValueError(f"K on {K.device}, b on {b.device}")
    _check_cuda(K, b, n)
    x, relres, niter = _cuda_build.fused_pcg(K.to(torch.float32).contiguous(),
                                             b.to(torch.float32).contiguous(), maxits, tol)
    fused_pcg_dense.launches += 1
    return x.to(b.dtype), relres, niter


def fused_lanczos_dense(K, Z, *, maxits: int = 10):
    """Batched unpreconditioned Lanczos of all probes in one kernel launch.

    Replaces the TPU kernel `_lanczos_kernel` (solvers/pallas_pcg.py).
    K (n, n) SPD, Z (nv, n) probes, cast to float32.  Returns
    (alpha (nv, maxits), beta (nv, maxits - 1), V (nv, maxits + 1, n),
    beta0 (nv,)), float32: the JAX `fused_lanczos_dense` outputs."""
    nv, n = Z.shape
    _check_square(K, n)
    if maxits < 1:
        raise ValueError(f"maxits must be >= 1, got {maxits}")
    if K.device.type == "cpu" and Z.device.type == "cpu":
        return fused_lanczos_dense_plain(K, Z, maxits=maxits)
    if not (K.is_cuda and Z.is_cuda):
        raise ValueError(f"K on {K.device}, Z on {Z.device}")
    _check_cuda(K, Z, n)
    if nv > MAX_NV or maxits > MAX_ITS:
        raise ValueError(f"the fused CUDA Lanczos takes nv <= {MAX_NV} and maxits <= {MAX_ITS}, "
                         f"got {nv} and {maxits}")
    out = _cuda_build.fused_lanczos(K.to(torch.float32).contiguous(),
                                    Z.to(torch.float32).contiguous(), maxits)
    fused_lanczos_dense.launches += 1
    return out


KERNEL_WRAPPERS = (fused_pcg_dense, fused_lanczos_dense)


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
