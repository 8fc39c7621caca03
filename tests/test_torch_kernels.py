"""Port parity: kernel matrices, gradients and additive kernels vs the JAX
package (ops/kernels.py), float64 on CPU.

Tolerance: rtol 1e-12 with atol 1e-12 -- the same formulas in float64; the
distance GEMM sums in another order, which moves entries by a few ulp
(absolute, so near-zero dK/dl entries on the diagonal need the atol).
One exception: matern12 on the same points.  Its sqrt(r2) turns the ~1e-16
rounding residue of a diagonal r2 (xx + yy - 2 xy) into ~1e-7, so its
diagonal is held at atol 1e-6 and everything off the diagonal at 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import kernels as jk
from nfft4gp_tpu.ops.distances import sq_distance as j_sq_distance
from nfft4gp_torch.ops import kernels as tk
from nfft4gp_torch.ops.distances import sq_distance as t_sq_distance

RTOL = ATOL = 1e-12
WINDOWS = [[0, 2], [1], [3, 4]]


def _close(t, j, sqrt_diag=False):
    t, j = t.numpy(), np.asarray(j)
    if sqrt_diag:
        diag = np.eye(t.shape[-2], t.shape[-1], dtype=bool)
        np.testing.assert_allclose(t[..., diag], j[..., diag], rtol=0, atol=1e-6)
        t, j = t[..., ~diag], j[..., ~diag]
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(11)
    return rng.uniform(size=(60, 5)), rng.uniform(size=(23, 5))


def _params(f=1.3, l=0.7, mu=0.05):  # noqa: E741
    return tk.KernelParams.make(f, l, mu, dtype=torch.float64), jk.KernelParams.make(f, l, mu)


def test_sq_distance(pts):
    X, Y = pts
    _close(t_sq_distance(torch.tensor(X), torch.tensor(Y)), j_sq_distance(jnp.asarray(X), jnp.asarray(Y)))
    _close(t_sq_distance(torch.tensor(X)), j_sq_distance(jnp.asarray(X)))


def test_make_windows():
    np.testing.assert_array_equal(tk.make_windows(WINDOWS).numpy(), np.asarray(jk.make_windows(WINDOWS)))


@pytest.mark.parametrize("kind", ["gaussian", "matern32", "matern12"])
@pytest.mark.parametrize("cross", [False, True])
def test_kernel_matrix_with_grad(pts, kind, cross):
    X, Y = pts
    tp, jp = _params()
    tY, jY = (torch.tensor(Y), jnp.asarray(Y)) if cross else (None, None)
    K, dK = tk.kernel_matrix_with_grad(kind, tp, torch.tensor(X), tY)
    jK, jdK = jk.kernel_matrix_with_grad(kind, jp, jnp.asarray(X), jY)
    sd = kind == "matern12" and not cross
    _close(K, jK, sd)
    _close(dK, jdK, sd)
    _close(tk.kernel_matrix(kind, tp, torch.tensor(X), tY),
           jk.kernel_matrix(kind, jp, jnp.asarray(X), jY), sd)


@pytest.mark.parametrize("kind", ["gaussian", "matern32", "matern12"])
@pytest.mark.parametrize("cross", [False, True])
def test_additive_kernel_matrix_with_grad(pts, kind, cross):
    X, Y = pts
    tp, jp = _params(0.9, 0.4, 0.02)
    tY, jY = (torch.tensor(Y), jnp.asarray(Y)) if cross else (None, None)
    tw, jw = tk.make_windows(WINDOWS), jk.make_windows(WINDOWS)
    K, dK = tk.additive_kernel_matrix_with_grad(kind, tp, torch.tensor(X), tw, tY)
    jK, jdK = jk.additive_kernel_matrix_with_grad(kind, jp, jnp.asarray(X), jw, jY)
    _close(K, jK)
    _close(dK, jdK)
    _close(tk.additive_kernel_matrix(kind, tp, torch.tensor(X), tw, tY),
           jk.additive_kernel_matrix(kind, jp, jnp.asarray(X), jw, jY))
