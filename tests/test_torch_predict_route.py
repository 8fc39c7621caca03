"""Prediction's operator engines (models/gp.py gp_predict_fastsum through
GPProblem.predict), float64 on the CPU.

With additive windows the regenerating route (fastsum_fused=True: the
fused engine's plain versions here, the phase-regenerating kernels on the
card, all N modes kept) computes the same operator as the table engine
(fastsum_engine='table'), so the mean and std agree to float64 roundoff:
rtol 1e-10, each also relative to the largest entry (measured, as the
largest difference over the largest entry: 7.3e-15 to 8.2e-15 on the
mean, 1.1e-14 to 4.8e-14 on the std over these layouts).  The layouts:
2-D windows alone, 2-D with a 1-D window, a 3-D window (the table path's
`rest` beside the kernels' windows), and matern12 with its KNN
near-field.  On CPU tensors the
default stays on the table engine, which the JAX parity tests of
tests/test_torch_predict.py hold.
"""

import numpy as np
import pytest
import torch

from nfft4gp_torch.models import gp as tgp
from nfft4gp_torch.models.problem import GPProblem
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.ops import fastsum as fs
from nfft4gp_torch.ops.kernels import make_windows

RTOL = 1e-10
RAW = transform_inverse("softplus", torch.tensor([1.2, 0.4, 0.05], dtype=torch.float64))
LAYOUTS = {
    "2d": ("gaussian", [[0, 1], [2, 3]]),
    "2d_1d": ("gaussian", [[0, 1], [2, 3], [4]]),
    "3d": ("gaussian", [[0, 1, 2], [3, 4], [5]]),
    "matern12_knn": ("matern12", [[0, 1], [2, 3], [4]]),
}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    n, n_test = 240, 9
    X = torch.from_numpy(rng.uniform(size=(n, 6)))
    y = torch.sin(3 * X[:, 0]) + torch.cos(2 * X[:, 3]) + 0.1 * torch.from_numpy(rng.normal(size=n))
    return X, y, torch.from_numpy(rng.uniform(size=(n_test, 6)))


def _problem(kind, windows, **kw):
    return GPProblem(kernel=kind, windows=windows, operator="fastsum", predict_operator="fastsum", rank=16,
                     maxits=6, tol=1e-8, fastsum_N=16, fastsum_nearfield_lfil=8 if kind == "matern12" else 0,
                     raw_params_=RAW, seed=3, **kw)


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=RTOL * float(b.abs().max()))


class _Calls:
    """Counts the calls of the two engines' matvecs, passing them through."""

    def __init__(self, monkeypatch):
        self.table = self.fused = 0
        table, fused = fs.additive_fastsum_matvec, fs.additive_fastsum_matvec_fused_batch

        def count_table(*a, **k):
            self.table += 1
            return table(*a, **k)

        def count_fused(*a, **k):
            self.fused += 1
            return fused(*a, **k)

        monkeypatch.setattr(fs, "additive_fastsum_matvec", count_table)
        monkeypatch.setattr(fs, "additive_fastsum_matvec_fused_batch", count_fused)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_regen_route_matches_table_engine(data, layout, monkeypatch):
    """fastsum_fused=True against fastsum_engine='table': mean and std (in
    chunks of the default 16, one batched joint matvec) to 1e-10, each
    engine alone on its path."""
    X, y, Xt = data
    kind, windows = LAYOUTS[layout]
    calls = _Calls(monkeypatch)
    tm, ts = _problem(kind, windows, fastsum_engine="table").predict(X, y, Xt, with_std=True)
    assert calls.table > 0 and calls.fused == 0
    calls.table = 0
    fm, fsd = _problem(kind, windows, fastsum_fused=True).predict(X, y, Xt, with_std=True)
    assert calls.fused > 0 and calls.table == 0
    assert bool((fsd > 0).all())
    _close(fm, tm)
    _close(fsd, ts)


def test_cpu_default_stays_on_table_engine(data, monkeypatch):
    """On CPU tensors the default (fastsum_engine='auto', fused None) is
    the table engine, through GPProblem and gp_predict_fastsum alike, and
    matches fastsum_engine='table' exactly."""
    X, y, Xt = data
    kind, windows = LAYOUTS["2d_1d"]
    calls = _Calls(monkeypatch)
    mean = _problem(kind, windows).predict(X, y, Xt)
    res = tgp.gp_predict_fastsum(RAW, X, y, Xt, tgp.GPConfig(kind=kind, maxits=6, tol=1e-8),
                                 windows=make_windows(windows), fastsum_N=16, maxits=40)
    assert calls.table > 0 and calls.fused == 0
    assert torch.equal(mean, _problem(kind, windows, fastsum_engine="table").predict(X, y, Xt))
    assert res.mean.shape == (Xt.shape[0],)
