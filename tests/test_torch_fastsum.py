"""Port parity: fastsum geometry, coefficients and the additive table-engine
matvecs vs ops/fastsum.py, float64 on CPU.

Tolerance: 1e-10 relative to the largest entry.  Same formulas in float64;
the coefficient FFT (pocketfft vs XLA's) and the table GEMMs sum in other
orders, and the folded apply sums ~n * N^2 terms.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_torch.ops import fastsum as tfs
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows

RTOL = 1e-10
WINDOWS = [[0, 1], [2], [3, 4]]


def _close(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * np.abs(j).max())


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    return rng.uniform(size=(150, 5)), rng.normal(size=150)


def _plans(X, kind, N, l=0.4):  # noqa: E741
    tp, jp = TParams.make(1.1, l, 0.05, dtype=torch.float64), JParams.make(1.1, l, 0.05)
    t = tfs.additive_fastsum_build(kind, tp, torch.tensor(X), t_windows(WINDOWS), N=N)
    j = jfs.additive_fastsum_build(kind, jp, jnp.asarray(X), j_windows(WINDOWS), N=N,
                                   nearfield_lfil=0)
    return t, j


@pytest.mark.parametrize("N", [16, 32])
def test_geometry_and_coeffs(data, N):
    X, _ = data
    t, j = _plans(X, "gaussian", N)
    assert [(dw, order) for dw, order, _ in t.groups] == [(dw, order) for dw, order, _ in j.groups]
    for (_, _, tplans), (_, _, jplans) in zip(t.groups, j.groups):
        for k, tpl in enumerate(tplans):
            _close(tpl.geom.x, jplans.geom.x[k])
            _close(tpl.geom.scale.reshape(1), np.asarray(jplans.geom.scale[k]).reshape(1))
            _close(tpl.geom.Tcs, jplans.geom.Tcs[k])
            for name in ("b", "db_l", "w", "dw_l"):
                _close(getattr(tpl, name), getattr(jplans, name)[k])


@pytest.mark.parametrize("kind", ["gaussian", "matern32"])
def test_additive_table_matvec(data, kind):
    X, x = data
    t, j = _plans(X, kind, 32)
    _close(tfs.additive_fastsum_matvec(t, torch.tensor(x)), jfs.additive_fastsum_matvec(j, jnp.asarray(x)))
    _close(tfs.additive_fastsum_grad_matvec(t, torch.tensor(x)),
           jfs.additive_fastsum_grad_matvec(j, jnp.asarray(x)))


def test_unported_options_raise(data):
    X, _ = data
    p = TParams.make(1.0, 0.5, 0.1, dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        tfs.additive_fastsum_geometry(torch.tensor(X), t_windows([[0, 1, 2]]))
    with pytest.raises(NotImplementedError):
        tfs.additive_fastsum_build("matern12", p, torch.tensor(X), t_windows(WINDOWS), nearfield_lfil=16)
    plan = tfs.additive_fastsum_build("gaussian", p, torch.tensor(X), t_windows(WINDOWS))
    with pytest.raises(NotImplementedError):
        tfs.additive_fastsum_matvec(plan, torch.tensor(X[:, 0]), compensated=True)
