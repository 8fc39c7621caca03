"""Port parity: GPProblem (loss, Adam fit, stream engine, saved state) vs the
JAX package's models/problem.py, with the JAX-drawn probes and Nystrom
landmarks injected into the port.

Tolerances:
- dense + Nystrom loss, gradient, 3-step loss history and raw_params_:
  rtol 1e-9 (float64; FGMRES and SLQ in both, see test_torch_solvers.py).
- fastsum stream engine, loss 1e-6 and gradient 1e-5 relative to its largest
  entry: JAX's table_f32 kernels store the table and round alpha to float32
  (measured agreement 3.0e-7 on the loss and 2.6e-7 on the gradient), which
  the Krylov steps carry into the estimate.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.models.problem import GPProblem as JProblem
from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm
from nfft4gp_torch.models.problem import GPProblem as TProblem
from nfft4gp_torch.models.problem import state_from_numpy
from nfft4gp_torch.models.transforms import transform_inverse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(61)
    n = 96
    X = rng.uniform(size=(n, 4))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)
    return X, y


def _injected(kw, n):
    """The probes and landmarks the JAX GPProblem draws, as port tensors."""
    probes = j_probes(jax.random.PRNGKey(kw["seed"] + 1), kw["nvecs"], n, dtype=jnp.float64)
    perm = j_rand_perm(jax.random.PRNGKey(kw["seed"]), n, min(kw["rank"], n))
    return state_from_numpy("cpu", landmarks=np.asarray(perm), probes=np.asarray(probes))


DENSE = dict(kernel="gaussian", windows=[[0, 1], [2, 3]], operator="dense", precond="nystrom",
             rank=16, maxits=8, nvecs=5, seed=4)


def test_dense_nystrom_loss_and_fit(synth):
    X, y = synth
    inj = _injected(DENSE, X.shape[0])
    raw = np.asarray(transform_inverse("softplus", torch.tensor([1.0, 0.6, 0.1], dtype=torch.float64)))
    jl, jg = JProblem(**DENSE).make_loss(jnp.asarray(X), jnp.asarray(y))(jnp.asarray(raw))
    tl, tg = TProblem(**DENSE).make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes,
                                         landmarks=inj.landmarks)(torch.tensor(raw))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-9, atol=1e-12)

    jp = JProblem(**DENSE).fit(jnp.asarray(X), jnp.asarray(y), adam_maxits=3, adam_alpha=0.05)
    tp = TProblem(**DENSE).fit(torch.tensor(X), torch.tensor(y), adam_maxits=3, adam_alpha=0.05,
                               probes=inj.probes, landmarks=inj.landmarks)
    np.testing.assert_allclose(tp.loss_history_, jp.loss_history_, rtol=1e-9)
    np.testing.assert_allclose(tp.raw_params_.numpy(), np.asarray(jp.raw_params_), rtol=1e-9)


def test_fastsum_stream_engine(synth):
    X, y = synth
    kw = dict(kernel="gaussian", windows=[[0, 1], [2, 3]], operator="fastsum", precond="nystrom",
              rank=16, maxits=6, nvecs=4, fastsum_N=16, fastsum_table_dtype=None, seed=3,
              fastsum_engine="stream")
    inj = _injected(kw, X.shape[0])
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1], dtype=torch.float64))
    jl, jg = JProblem(**kw).make_loss(jnp.asarray(X), jnp.asarray(y))(jnp.asarray(raw.numpy()))
    tl, tg = TProblem(**kw).make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes,
                                      landmarks=inj.landmarks)(raw)
    assert np.isfinite(float(tl))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_load_jax_saved_problem(synth, tmp_path):
    X, y = synth
    jp = JProblem(**DENSE).fit(jnp.asarray(X), jnp.asarray(y), adam_maxits=2, adam_alpha=0.05)
    path = tmp_path / "problem.npz"
    jp.save(str(path))
    tp = TProblem.load(str(path))
    assert tp.windows == DENSE["windows"] and tp.rank == DENSE["rank"] and tp.seed == DENSE["seed"]
    np.testing.assert_allclose(tp.loss_history_, jp.loss_history_, rtol=0)
    inj = _injected(DENSE, X.shape[0])
    jl, _ = jp.make_loss(jnp.asarray(X), jnp.asarray(y))(jp.raw_params_)
    tl, _ = tp.make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes,
                         landmarks=inj.landmarks)(tp.raw_params_)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-9)
    # and the port's own save round-trips
    tp.save(str(tmp_path / "again.npz"))
    again = TProblem.load(str(tmp_path / "again.npz"))
    np.testing.assert_array_equal(again.raw_params_.numpy(), tp.raw_params_.numpy())


def test_port_imports_no_jax():
    code = ("import sys, chip_smoke, nfft4gp_torch\n"
            "import nfft4gp_torch.models.problem, nfft4gp_torch.ops._cuda_build\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_paths_raise(synth):
    X, y = synth
    with pytest.raises(NotImplementedError):
        TProblem(precond="afn").make_loss(torch.tensor(X), torch.tensor(y))
    with pytest.raises(NotImplementedError):
        TProblem(operator="fastsum", kernel="matern12", windows=[[0, 1]]).make_loss(
            torch.tensor(X), torch.tensor(y))
