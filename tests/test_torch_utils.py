"""Port parity: utils/ (timers, debug dumps, config, datasets) and the small
ops helpers (distance, base_kernel, ell_diag) against the JAX package.

The counterparts of tests/test_utils.py::test_stage_timers,
::test_timed_block and ::test_debug_dumps; the dumps must be byte-equal to
the JAX package's on the same arrays, and generate_grid2d equal to JAX's
element for element.  distance, base_kernel and ell_diag: float64, 1e-12
relative against the JAX functions on the same numpy inputs; so are the
dense triangular solves when they take a block's columns in slices
(ops/matops.TRI_COLS).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops.distances import distance as j_distance
from nfft4gp_tpu.ops.kernels import base_kernel as j_base_kernel
from nfft4gp_tpu.ops.matops import ell_diag as j_ell_diag
from nfft4gp_tpu.utils import debug as j_debug
from nfft4gp_tpu.utils.config import default_complex_dtype as j_complex_dtype
from nfft4gp_tpu.utils.config import x64_enabled as j_x64_enabled
from nfft4gp_tpu.utils.datasets import generate_grid2d as j_grid2d

from nfft4gp_torch.ops.distances import distance
from nfft4gp_torch.ops.kernels import base_kernel
from nfft4gp_torch.ops.matops import ell_diag
from nfft4gp_torch.utils import debug, generate_grid2d, generate_uniform
from nfft4gp_torch.utils.config import default_complex_dtype, x64_enabled
from nfft4gp_torch.utils.timers import StageTimers, timed_block_until_ready, trace

RTOL = 1e-12


def test_stage_timers():
    t = StageTimers()
    with t("setup"):
        x = torch.ones(10) * 2
    with t("setup", sync=(x, [x + 1])):
        x + 1
    assert t.counts["setup"] == 2
    assert t.totals["setup"] >= 0.0
    assert "setup" in t.summary()
    t.reset()
    assert not t.totals and not t.counts


def test_timed_block():
    out, dt = timed_block_until_ready(lambda v: v * 2, torch.ones(5))
    assert dt >= 0 and float(out[0]) == 2.0
    outs, _ = timed_block_until_ready(lambda v: (v, [v * 3]), torch.ones(2))
    assert float(outs[1][0][0]) == 3.0


def test_trace_cpu_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    assert "traceEvents" in json.loads(path.read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_trace_rejects_unknown_device(tmp_path):
    with pytest.raises(ValueError):
        with trace(str(tmp_path), device="tpu"):
            pass


def _dump_all(mod, d, X, y, idx, mask):
    mod.dump_points(d / "pts.txt", X, y)
    mod.dump_points(d / "pts1.txt", X[:, 0])
    mod.dump_ell_pattern(d / "pat.txt", idx, mask)
    return [(d / f).read_bytes() for f in ("pts.txt", "pts1.txt", "pat.txt")]


@pytest.mark.parametrize("as_tensor", [False, True])
def test_debug_dumps_match_jax(tmp_path, capsys, as_tensor):
    rng = np.random.default_rng(3)
    X, y = rng.uniform(size=(5, 2)), rng.uniform(size=5)
    idx = np.asarray([[0, 0, 2], [0, 1, 1], [2, 1, 0]])
    mask = np.asarray([[False, True, True], [True, True, False], [True, False, True]])
    A = rng.normal(size=(12, 13))
    conv = torch.from_numpy if as_tensor else (lambda a: a)

    j_debug.print_matrix(A, "A")
    j_debug.print_matrix(np.eye(3), "I")
    j_debug.print_matrix(A[0])
    want_out = capsys.readouterr().out
    debug.print_matrix(conv(A), "A")
    debug.print_matrix(conv(np.eye(3)), "I")
    debug.print_matrix(conv(A[0]))
    got_out = capsys.readouterr().out
    assert "I (3 x 3)" in got_out
    assert got_out == want_out

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _dump_all(j_debug, tmp_path / "jax", X, y, idx, mask)
    got = _dump_all(debug, tmp_path / "port", conv(X), conv(y), conv(idx), conv(mask))
    assert got == want
    assert len(got[2].decode().splitlines()) == int(mask.sum())


def test_config_counterparts():
    # the suite runs JAX with x64; torch's default dtype plays its part
    assert j_x64_enabled() and j_complex_dtype() == jnp.complex128
    prev = torch.get_default_dtype()
    try:
        torch.set_default_dtype(torch.float32)
        assert not x64_enabled() and default_complex_dtype() == torch.complex64
        torch.set_default_dtype(torch.float64)
        assert x64_enabled() and default_complex_dtype() == torch.complex128
    finally:
        torch.set_default_dtype(prev)


@pytest.mark.parametrize("nx,ny", [(1, 4), (2, 1), (7, 5), (33, 17), (100, 3), (999, 6)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_generate_grid2d_equals_jax(nx, ny, dtype):
    want = np.asarray(j_grid2d(nx, ny, getattr(jnp, dtype)))
    got = generate_grid2d(nx, ny, getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype and got.shape == (nx * ny, 2)
    np.testing.assert_array_equal(got, want)


def test_generate_uniform_shape_range_repeatable():
    a = generate_uniform(torch.Generator().manual_seed(5), 1000, 3, -2.0, 0.5, dtype=torch.float64)
    b = generate_uniform(torch.Generator().manual_seed(5), 1000, 3, -2.0, 0.5, dtype=torch.float64)
    c = generate_uniform(torch.Generator().manual_seed(6), 1000, 3, -2.0, 0.5, dtype=torch.float64)
    assert a.shape == (1000, 3) and a.dtype == torch.float64
    assert float(a.min()) >= -2.0 and float(a.max()) < 0.5
    assert float(a.min()) < -1.9 and float(a.max()) > 0.4
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert generate_uniform(torch.Generator().manual_seed(0), 4, 2).dtype == torch.get_default_dtype()


def test_distance_matches_jax():
    rng = np.random.default_rng(11)
    X, Y = rng.uniform(size=(40, 3)), rng.uniform(size=(25, 3))
    for args in ((X, Y), (X,)):
        want = np.asarray(j_distance(*(jnp.asarray(a) for a in args)))
        got = distance(*(torch.from_numpy(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name", ["gaussian", "matern32", "matern12"])
def test_base_kernel_matches_jax(name):
    r2 = np.random.default_rng(2).uniform(0.0, 2.0, size=(30, 20))
    for k_j, k_t in zip(j_base_kernel(name)(jnp.asarray(r2), 0.4),
                        base_kernel(name)(torch.from_numpy(r2), torch.tensor(0.4, dtype=torch.float64))):
        np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=RTOL, atol=0.0)


def test_ell_diag_matches_jax():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 50, size=(50, 6))
    val = rng.normal(size=(50, 6))
    slot = rng.integers(0, 6, size=50)
    want = np.asarray(j_ell_diag(jnp.asarray(idx), jnp.asarray(val), jnp.asarray(slot)))
    got = ell_diag(torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(slot)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("upper", [False, True])
def test_triangular_solves_in_column_slices_match_jax(monkeypatch, upper):
    """tril_solve / triu_solve with more right-hand sides than TRI_COLS (set
    to 7 here) solve them in slices: equal to the JAX package's solves on
    the whole block (float64, 1e-12), a vector right-hand side too."""
    from nfft4gp_tpu.ops import matops as jm
    from nfft4gp_torch.ops import matops as tm

    monkeypatch.setattr(tm, "TRI_COLS", 7)
    rng = np.random.default_rng(6)
    A = rng.normal(size=(9, 9))
    L = np.linalg.cholesky(A @ A.T + 9.0 * np.eye(9))
    for b in (rng.normal(size=(9, 30)), rng.normal(size=(9, 7)), rng.normal(size=9)):
        got = (tm.triu_solve if upper else tm.tril_solve)(torch.from_numpy(L), torch.from_numpy(b)).numpy()
        want = np.asarray((jm.triu_solve if upper else jm.tril_solve)(jnp.asarray(L), jnp.asarray(b)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-14)
