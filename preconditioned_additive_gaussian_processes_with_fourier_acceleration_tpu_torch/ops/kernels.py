"""Kernel matrices with analytic hyperparameter gradients (port of ops/kernels.py).

  K      = f^2 * (k(r) + mu * I)      (noise only on same-set evaluations)
  dK/df  = 2 f (k(r) + mu I),  dK/dl = f^2 dk/dl,  dK/dmu = f^2 I

  gaussian  : k = exp(-r^2 / (2 l^2)),   dk/dl = (r^2 / l^3) k
  matern32  : k = (1 + sqrt(3) r / l) exp(-sqrt(3) r / l),
              dk/dl = (3 r^2 / l^3) exp(-sqrt(3) r / l)
  matern12  : k = exp(-r / l),           dk/dl = (r / l^2) k

Gradients stack as dK[3, n, m] in (df, dl, dmu) order.  Point sets may
carry leading batch dimensions, (..., n, d) -> K (..., n, m) and dK
(3, ..., n, m) (the FSAI row blocks).  Additive kernels
average the base kernel over feature windows, a (W, dw) index tensor with
-1 padding (ref SRC/linearalg/kernels.c:3046-3495).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.timers import host_read
from .distances import sq_distance

SQRT3 = 1.7320508075688772935


@dataclass
class KernelParams:
    """Hyperparameters (f, l, mu) as 0-dim tensors."""

    f: torch.Tensor
    l: torch.Tensor  # noqa: E741
    mu: torch.Tensor

    @staticmethod
    def make(f=1.0, l=1.0, mu=0.01, dtype=None, device=None):  # noqa: E741
        dtype = dtype or torch.get_default_dtype()

        def put(v):
            return host_read(v, lambda v: torch.as_tensor(v, dtype=dtype, device=device))

        return KernelParams(f=put(f), l=put(l), mu=put(mu))


def _gaussian_base(r2, l):  # noqa: E741
    k = torch.exp(-r2 / (2.0 * l * l))
    return k, (r2 / (l * l * l)) * k


def _matern32_base(r2, l):  # noqa: E741
    r = torch.sqrt(r2)
    e = torch.exp(-SQRT3 * r / l)
    return (1.0 + SQRT3 * r / l) * e, (3.0 * r2 / (l * l * l)) * e


def _matern12_base(r2, l):  # noqa: E741
    r = torch.sqrt(r2)
    k = torch.exp(-r / l)
    return k, (r / (l * l)) * k


BASE_KERNELS = {
    "gaussian": _gaussian_base,
    "matern32": _matern32_base,
    "matern12": _matern12_base,
}


def base_kernel(name: str):
    """The base kernel k(r2, l) -> (k, dk/dl) on squared distances, without
    f or mu."""
    return BASE_KERNELS[name]


def _eye_like(r2, same_points: bool):
    n, m = r2.shape[-2:]
    if same_points:
        return torch.eye(n, m, dtype=r2.dtype, device=r2.device)
    return torch.zeros((n, m), dtype=r2.dtype, device=r2.device)


def kernel_matrix(kind: str, params: KernelParams, X, Y=None):
    """Dense K(X, Y); noise on the diagonal only when Y is None."""
    k, _ = BASE_KERNELS[kind](sq_distance(X, Y), params.l)
    f2 = params.f * params.f
    return f2 * (k + params.mu * _eye_like(k, Y is None))


def kernel_matrix_with_grad(kind: str, params: KernelParams, X, Y=None):
    """(K, dK[3]) with gradients stacked (df, dl, dmu)."""
    k, dk_dl = BASE_KERNELS[kind](sq_distance(X, Y), params.l)
    return _assemble_grad(params, k, dk_dl, Y is None)


def gaussian_kernel(params, X, Y=None):
    return kernel_matrix("gaussian", params, X, Y)


def matern32_kernel(params, X, Y=None):
    return kernel_matrix("matern32", params, X, Y)


def matern12_kernel(params, X, Y=None):
    return kernel_matrix("matern12", params, X, Y)


def _assemble_grad(params, k, dk_dl, same_points):
    f2 = params.f * params.f
    eye = _eye_like(k, same_points)
    kmu = k + params.mu * eye
    dK = torch.stack([2.0 * params.f * kmu, f2 * dk_dl, f2 * eye.expand_as(k)])
    return f2 * kmu, dK


def make_windows(window_list):
    """Pad per-window feature-index lists to a (W, dw_max) int64 tensor, -1 = pad."""
    dw = max(len(w) for w in window_list)
    arr = np.full((len(window_list), dw), -1, dtype=np.int64)
    for i, w in enumerate(window_list):
        arr[i, : len(w)] = w
    return torch.from_numpy(arr)


def _window_slice(X, window):
    """Columns of X selected by one window row; padded (-1) columns are zero,
    so they add nothing to a squared distance (ref kernels.c:3054-3060)."""
    window = host_read(window, lambda w: w.to(X.device))
    cols = X[..., torch.clamp(window, min=0)]
    return cols * (window >= 0).to(X.dtype)


def _additive_r2(X, Y, windows):
    """Per-window squared distances, shape (W, ..., n, m)."""
    return torch.stack([
        sq_distance(_window_slice(X, w), None if Y is None else _window_slice(Y, w))
        for w in windows
    ])


def additive_kernel_matrix(kind: str, params: KernelParams, X, windows, Y=None):
    """K_add = (1/W) sum_w K_base(X[:, window_w]); noise added once."""
    k, _ = BASE_KERNELS[kind](_additive_r2(X, Y, windows), params.l)
    kbar = torch.mean(k, dim=0)
    f2 = params.f * params.f
    return f2 * (kbar + params.mu * _eye_like(kbar, Y is None))


def additive_kernel_matrix_with_grad(kind: str, params: KernelParams, X, windows, Y=None):
    k, dk_dl = BASE_KERNELS[kind](_additive_r2(X, Y, windows), params.l)
    return _assemble_grad(params, torch.mean(k, dim=0), torch.mean(dk_dl, dim=0), Y is None)


# --- matvec closures -------------------------------------------------------------

def dense_symv(K):
    """y = K x closure (ref Nfft4GPDenseMatSymv, matops.c:3-14)."""
    return lambda x: K @ x


def dense_grad_symv(dK):
    """y[3, n] = dK[i] x closure (ref Nfft4GPDenseGradMatSymv, matops.c:15-30)."""
    return lambda x: torch.einsum("knm,m->kn", dK, x)
