"""Port parity: the Nystrom preconditioner vs preconds/nystrom.py.

float64 on CPU with the same landmark indices in both packages.  Tolerance:
1e-9 relative to the largest entry.  The solve divides by eta = mu f^2
(1/eta ~ 40 here) and the SVD and Cholesky run in other LAPACK orders, so
ulp-level differences grow by ~1e3 but stay far below 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_tpu.preconds.nystrom import nystrom_setup as j_setup
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows
from nfft4gp_torch.preconds.nystrom import nystrom_setup as t_setup

RTOL = 1e-9


def _close(t, j):
    t, j = np.asarray(t), np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * np.abs(j).max())


@pytest.fixture(scope="module", params=[None, [[0, 1], [2]]], ids=["full", "additive"])
def pair(request):
    rng = np.random.default_rng(31)
    n, k = 120, 20
    X = rng.uniform(size=(n, 3))
    perm = rng.permutation(n)
    win = request.param
    t = t_setup("gaussian", TParams.make(1.1, 0.6, 0.02, dtype=torch.float64), torch.tensor(X),
                torch.tensor(perm), k, require_grad=True,
                windows=None if win is None else t_windows(win))
    j = j_setup("gaussian", JParams.make(1.1, 0.6, 0.02), jnp.asarray(X), jnp.asarray(perm), k,
                require_grad=True, windows=None if win is None else j_windows(win))
    return t, j, rng.normal(size=(4, n))


def test_solve(pair):
    t, j, R = pair
    _close(t.solve(torch.tensor(R[0])).numpy(), j.solve(jnp.asarray(R[0])))
    batch = t.solve(torch.tensor(R)).numpy()
    for r in range(R.shape[0]):
        _close(batch[r], j.solve(jnp.asarray(R[r])))


def test_logdet_and_trace(pair):
    t, j, _ = pair
    _close([float(t.logdet())], [float(j.logdet())])
    _close(t.trace().numpy(), j.trace())


def test_dvp(pair):
    t, j, R = pair
    _close(t.dvp(torch.tensor(R[1])).numpy(), j.dvp(jnp.asarray(R[1])))
    batch = t.dvp(torch.tensor(R)).numpy()
    assert batch.shape == (R.shape[0], 3, R.shape[1])
    for r in range(R.shape[0]):
        _close(batch[r], j.dvp(jnp.asarray(R[r])))
