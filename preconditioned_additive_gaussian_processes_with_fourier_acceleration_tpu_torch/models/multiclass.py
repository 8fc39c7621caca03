"""Exact multi-class GP (one-vs-all) with fixed per-point noise (port of
models/multiclass.py).

Rebuild of the MATLAB prototype's classification stack
(exact_class_gp_loss.m, exact_class_gp_prediction.m, with the fixed-noise
kernel gaussianKernelFixedNoise.m):

  K_c = f_c^2 k(X; l_c) + mu_c I + diag(mu2[:, c])
  loss = sum_c 0.5 (y_c' K_c^{-1} y_c + logdet K_c + n log 2pi) / n
  dK/df = 2 f k,  dK/dl = f^2 dk/dl,  dK/dmu = I   (the noise is not
  f^2-scaled in this variant, unlike the regression kernel)

The classes are a batch dimension: one batched Cholesky factorization and
batched solves; prediction is the argmax of the per-class posterior means.
"""

import math
from typing import NamedTuple, Optional

import torch

from ..ops.distances import sq_distance
from ..ops.kernels import BASE_KERNELS
from .transforms import transform_forward

LOG_2PI = math.log(2.0 * math.pi)


def _class_kernels(kind, fs, ls, mus, mu2, X, Y=None, grad=False):
    """Batched fixed_noise_kernel: fs, ls, mus (C,), mu2 (n, C) ->
    K (C, n, m) and, with grad, dK (C, 3, n, m)."""
    same = Y is None
    r2 = sq_distance(X, Y)
    k, dk_dl = BASE_KERNELS[kind](r2[None], ls[:, None, None])
    f = fs[:, None, None]
    K = f * f * k
    n, m = r2.shape
    eye = torch.eye(n, m, dtype=K.dtype, device=K.device) if same else \
        torch.zeros((n, m), dtype=K.dtype, device=K.device)
    if same:
        K = K + mus[:, None, None] * eye + torch.diag_embed(mu2.T)
    if not grad:
        return K
    dK = torch.stack([2.0 * f * k, f * f * dk_dl, eye.expand_as(k)], dim=1)
    return K, dK


def fixed_noise_kernel(kind, f, l, mu, mu2, X, Y=None, grad=False):  # noqa: E741
    """K = f^2 k(r; l) + mu I + diag(mu2); mu2 (n,) only on same-set diagonals."""
    f, l, mu = (torch.as_tensor(v, dtype=X.dtype, device=X.device).reshape(1) for v in (f, l, mu))
    out = _class_kernels(kind, f, l, mu, mu2[:, None], X, Y, grad)
    return (out[0][0], out[1][0]) if grad else out[0]


class ClassGPLossResult(NamedTuple):
    loss: torch.Tensor
    grad: torch.Tensor      # (3C,) ordered [f_1..f_C, l_1..l_C, mu_1..mu_C]
    per_class: torch.Tensor


def _class_params(transform, raw, C):
    return [transform_forward(transform, raw[i * C:(i + 1) * C]) for i in range(3)]


def exact_class_gp_loss(raw, X, Ys, mu2, *, kind="gaussian", transform="softplus", masks=None):
    """raw: (3C,) [fs; ls; mus] untransformed; Ys, mu2: (n, C)."""
    n, C = Ys.shape
    (fs, dfs), (ls, dls), (mus, dmus) = _class_params(transform, raw, C)
    K, dK = _class_kernels(kind, fs, ls, mus, mu2, X, grad=True)
    L = torch.linalg.cholesky(K)
    Y = Ys.T
    iKY = torch.cholesky_solve(Y[:, :, None], L)[:, :, 0]                  # (C, n)
    L1 = torch.sum(Y * iKY, dim=1)
    L2 = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=1)
    iKdK = torch.cholesky_solve(dK, L[:, None])                           # (C, 3, n, n)
    L1_grad = torch.einsum("cn,cknm,cm->ck", iKY, dK, iKY)
    L2_grad = torch.diagonal(iKdK, dim1=2, dim2=3).sum(dim=2)
    losses = 0.5 * (L1 + L2 + n * LOG_2PI) / n
    grads = 0.5 * (-L1_grad + L2_grad) / n * torch.stack([dfs, dls, dmus], dim=1)
    if masks is not None:
        grads = grads * torch.as_tensor(masks, dtype=grads.dtype, device=grads.device)[None, :]
    return ClassGPLossResult(loss=torch.sum(losses), grad=grads.T.reshape(-1), per_class=losses)


class ClassGPPredictResult(NamedTuple):
    labels: torch.Tensor      # (n2,) argmax class indices
    means: torch.Tensor       # (n2, C)
    std: Optional[torch.Tensor]


def exact_class_gp_predict(raw, X1, Ys, mu2, X2, *, kind="gaussian", transform="softplus",
                           with_std=False):
    """One-vs-all prediction: argmax_c of the per-class posterior means
    (exact_class_gp_prediction.m:25-72)."""
    C = Ys.shape[1]
    (fs, _), (ls, _), (mus, _) = _class_params(transform, raw, C)
    K11 = _class_kernels(kind, fs, ls, mus, mu2, X1)
    K12 = _class_kernels(kind, fs, ls, mus, mu2, X1, X2)                  # (C, n1, n2)
    L = torch.linalg.cholesky(K11)
    iKY = torch.cholesky_solve(Ys.T[:, :, None], L)[:, :, 0]
    means = torch.einsum("cnm,cn->mc", K12, iKY)
    std = None
    if with_std:
        # the test-block diagonal carries only the learnable noise (mu2 is a
        # train-point property, exact_class_gp_prediction.m:31-32)
        iK_K12 = torch.cholesky_solve(K12, L)
        var = (fs * fs + mus)[:, None] - torch.sum(K12 * iK_K12, dim=1)
        std = torch.sqrt(torch.abs(var)).T
    return ClassGPPredictResult(labels=torch.argmax(means, dim=1), means=means, std=std)
