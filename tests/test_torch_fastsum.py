"""Port parity: fastsum geometry, coefficients, the additive
table-engine matvecs, the full (non-additive) matvecs and the compensated
adjoint vs ops/fastsum.py, float64 on CPU.

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
    """Windows, and full fastsum problems, of more than three features raise
    ValueError, as in the JAX package."""
    X, _ = data
    with pytest.raises(ValueError):
        tfs.additive_fastsum_geometry(torch.tensor(X), t_windows([[0, 1, 2, 3]]))
    with pytest.raises(ValueError):
        tfs.fastsum_geometry(torch.tensor(X[:, :4]))


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("kind", ["gaussian", "matern32", "matern12"])
def test_full_fastsum_matvec(data, d, kind):
    """The non-additive operator, matern12 with its default KNN near-field
    (lower-triangular form), one vector and a batch of rows."""
    X, x = data
    tp, jp = TParams.make(1.1, 0.4, 0.05, dtype=torch.float64), JParams.make(1.1, 0.4, 0.05)
    t = tfs.fastsum_build(kind, tp, torch.tensor(X[:, :d]), N=16)
    j = jfs.fastsum_build(kind, jp, jnp.asarray(X[:, :d]), N=16)
    assert (t.nf_val is None) == (j.nf_val is None) == (kind != "matern12")
    V = np.stack([x, np.cos(7 * x)])
    _close(tfs.fastsum_matvec(t, torch.tensor(x)), jfs.fastsum_matvec(j, jnp.asarray(x)))
    _close(tfs.fastsum_grad_matvec(t, torch.tensor(x)), jfs.fastsum_grad_matvec(j, jnp.asarray(x)))
    _close(tfs.fastsum_matvec(t, torch.tensor(V)), np.stack([jfs.fastsum_matvec(j, jnp.asarray(v)) for v in V]))
    _close(tfs.fastsum_grad_matvec(t, torch.tensor(V)),
           np.stack([jfs.fastsum_grad_matvec(j, jnp.asarray(v)) for v in V]))
    _close(tfs.fastsum_base_apply(t, t.db_l, torch.tensor(x)), jfs.fastsum_base_apply(j, j.db_l, jnp.asarray(x)))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_compensated_adjoint(data, d):
    """The chunked TwoSum adjoint with a chunk small enough that its scan runs
    (150 points in chunks of 32), and the compensated matvecs."""
    X, x = data
    t = tfs.fastsum_geometry(torch.tensor(X[:, :d]), 16)
    j = jfs.fastsum_geometry(jnp.asarray(X[:, :d]), 16)
    _close(tfs._folded_adjoint_comp(t.Tcs, torch.tensor(x), chunk=32),
           jfs._folded_adjoint_comp(j.Tcs, jnp.asarray(x), chunk=32))
    _close(tfs._folded_adjoint_comp(t.Tcs, torch.tensor(x), chunk=32), tfs._folded_adjoint(t.Tcs, torch.tensor(x)))
    tpl, jpl = _plans(X, "gaussian", 16)
    _close(tfs.additive_fastsum_grad_matvec(tpl, torch.tensor(x), compensated=True),
           jfs.additive_fastsum_grad_matvec(jpl, jnp.asarray(x), compensated=True))
