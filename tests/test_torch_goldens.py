"""The port held to the JAX package's self-golden (tests/goldens/gp_train_small.json,
written by tests/test_goldens.py): 10 Adam steps of the dense gaussian GP
with a Nystrom preconditioner, then prediction with std, all in float64 on
the CPU.

The data come from numpy as in tests/test_goldens.py::_run_case; the probes
(rademacher_probes(PRNGKey(222), 8, 64)) and the landmark permutation
(expand_perm(rand_perm(PRNGKey(807), 64, 20), 64)) are drawn with jax.random
here and handed over as numpy arrays.  Losses, final raw parameters,
prediction mean and std must match at rtol 1e-8, atol 1e-10: ten times the
JAX package's own golden limit, for the port's other summation orders
(torch's GEMMs and reductions against XLA's).  The test never writes the
golden file.
"""

import json
import os

import jax
import numpy as np
import torch

from nfft4gp_tpu.solvers.lanczos import rademacher_probes as j_probes
from nfft4gp_tpu.utils.datasets import expand_perm as j_expand_perm
from nfft4gp_tpu.utils.datasets import rand_perm as j_rand_perm

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "gp_train_small.json")
RTOL, ATOL = 1e-8, 1e-10


def _port_case():
    from nfft4gp_torch.models.adam import adam_run
    from nfft4gp_torch.models.gp import GPConfig, gp_loss, gp_predict, make_dense_ops
    from nfft4gp_torch.models.transforms import transform_inverse
    from nfft4gp_torch.preconds.nystrom import nystrom_setup

    rng = np.random.default_rng(906)
    n, n_test = 64, 16
    X = torch.from_numpy(np.sort(rng.uniform(size=(n, 1)), axis=0))
    Xt = torch.from_numpy(rng.uniform(size=(n_test, 1)))
    y = torch.from_numpy(np.sin(7 * X[:, 0].numpy()) + 0.05 * rng.normal(size=n))

    cfg = GPConfig(kind="gaussian", maxits=15, nvecs=8, tol=1e-12)
    probes = torch.from_numpy(np.array(j_probes(jax.random.PRNGKey(222), 8, n), dtype=np.float64))
    perm = torch.from_numpy(np.array(j_expand_perm(j_rand_perm(jax.random.PRNGKey(807), n, 20), n)))
    build = make_dense_ops("gaussian", X)

    def psetup(params):
        return nystrom_setup("gaussian", params, X, perm, 20, require_grad=True)

    def loss_fn(raw):
        r = gp_loss(raw, y, build, probes, cfg, psetup)
        return r.loss, r.grad

    x0 = transform_inverse("softplus", torch.tensor([1.0, 0.3, 0.1], dtype=torch.float64))
    _, losses, xs, _ = adam_run(loss_fn, x0, maxits=10, alpha=0.05)
    pred = gp_predict(xs[-1], X, y, Xt, cfg, maxits=64, with_std=True)
    return {
        "losses": [float(v) for v in losses],
        "final_raw": [float(v) for v in xs[-1]],
        "pred_mean": [float(v) for v in pred.mean],
        "pred_std": [float(v) for v in pred.std],
    }


def test_port_matches_training_golden():
    with open(GOLDEN) as f:
        want = json.load(f)
    got = _port_case()
    assert len(got["losses"]) == len(want["losses"]) == 10
    for key in ("losses", "final_raw", "pred_mean", "pred_std"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=f"port vs golden: {key}")
