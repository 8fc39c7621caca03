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
            "import nfft4gp_torch.models.gp, nfft4gp_torch.ops.cellgrid, nfft4gp_torch.ops.fastsum\n"
            "import nfft4gp_torch.models.multiclass, nfft4gp_torch.solvers.fused_pcg\n"
            "import nfft4gp_torch.preconds.afn, nfft4gp_torch.preconds.fsai, nfft4gp_torch.ops.fps\n"
            "import nfft4gp_torch.ops.rankest, nfft4gp_torch.io, nfft4gp_torch.cli\n"
            "import nfft4gp_torch.parallel, nfft4gp_torch.parallel.mesh, nfft4gp_torch.parallel.sharded\n"
            "import nfft4gp_torch.parallel.training, nfft4gp_torch.parallel.dryrun\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_paths_raise(synth):
    """fused + stream conflict (ValueError, as in JAX)."""
    X, y = synth
    with pytest.raises(ValueError):
        TProblem(operator="fastsum", kernel="matern12", windows=[[0, 1]], fastsum_fused=True,
                 fastsum_engine="stream").make_loss(torch.tensor(X), torch.tensor(y))


@pytest.mark.parametrize("kernel", ["gaussian", "matern12"])
def test_full_fastsum_problem(synth, kernel):
    """windows=None: one fastsum plan over three features, matern12 with
    its symmetrized KNN near-field; loss and gradient against the JAX
    GPProblem, float64: rtol 1e-9 for gaussian; 1e-7 for matern12, whose
    operators agree to 5e-16 while its losses, through the 12-step FGMRES
    and the SLQ estimate, measured 2.8e-9 apart."""
    X, y = synth
    X = X[:, :3]
    kw = dict(kernel=kernel, operator="fastsum", precond="nystrom", rank=16, maxits=6, nvecs=4,
              fastsum_N=16, seed=2)
    inj = _injected(kw, X.shape[0])
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1], dtype=torch.float64))
    jl, jg = JProblem(**kw).make_loss(jnp.asarray(X), jnp.asarray(y))(jnp.asarray(raw.numpy()))
    prob = TProblem(**kw)
    tl, tg = prob.make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes, landmarks=inj.landmarks)(raw)
    assert (prob.nf_patterns_ is None) == (kernel == "gaussian") and prob.nf_stencils_ is None
    rtol = 1e-9 if kernel == "gaussian" else 1e-7
    np.testing.assert_allclose(float(tl), float(jl), rtol=rtol)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=rtol, atol=rtol * np.abs(np.asarray(jg)).max())


def test_numpy_inputs(synth, monkeypatch):
    """make_loss, fit and predict take numpy arrays, as the JAX API does:
    with device="cpu" they run on the CPU with the same numbers as tensors;
    with the default device and no card they raise."""
    X, y = synth
    inj = _injected(DENSE, X.shape[0])
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.6, 0.1], dtype=torch.float64))
    want = TProblem(**DENSE).make_loss(torch.tensor(X), torch.tensor(y), probes=inj.probes,
                                       landmarks=inj.landmarks)(raw)
    got = TProblem(**DENSE, device="cpu").make_loss(X, y, probes=inj.probes, landmarks=inj.landmarks)(raw)
    assert float(got[0]) == float(want[0]) and torch.equal(got[1], want[1])
    prob = TProblem(**DENSE, device="cpu").fit(X, y, adam_maxits=2, probes=inj.probes,
                                               landmarks=inj.landmarks)
    assert prob.raw_params_.device.type == "cpu" and len(prob.loss_history_) == 2
    mean = prob.predict(X, y, X[:5], landmarks=inj.landmarks)
    assert mean.shape == (5,) and mean.dtype == torch.float64
    # a tensor X keeps its device; numpy y and X_test follow it
    assert torch.equal(TProblem(**DENSE, raw_params_=prob.raw_params_).predict(
        torch.tensor(X), y, X[:5], landmarks=inj.landmarks), mean)
    # numpy arrays beside X take its dtype; on the CPU a numpy X keeps its own
    Xt, yt = TProblem(**DENSE, device="cpu")._tensors(X.astype(np.float32), y)
    assert Xt.dtype == yt.dtype == torch.float32 and Xt.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda p: p.make_loss(X, y), lambda p: p.fit(X, y, adam_maxits=1),
                 lambda p: p.predict(X, y, X[:5])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(TProblem(**DENSE, raw_params_=prob.raw_params_))
    # the device is not saved: the .npz keeps the JAX package's format
    assert "device" not in str(np.load(_saved(prob))["config"][0])


def _saved(prob):
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "p.npz")
    prob.save(path)
    return path
