"""Port parity: the readers and the CLI vs the JAX package's io/readers.py
and cli.py, on small synthetic files in the reference's text formats.

Tolerances:
- readers: exact equality (the same tokenizer source, or the same numpy
  fallback);
- CLI, each --precond on the dense operator at --x64: prediction RMSE within
  10% of the JAX CLI's on the same files (the rank estimate of AFN draws
  other subsamples in each package; the other preconditioners also draw
  their probes and landmarks from different generators).
"""

import os

import numpy as np
import pytest

from nfft4gp_tpu import cli as jcli
from nfft4gp_tpu.io import readers as jread
from nfft4gp_torch import cli as tcli
from nfft4gp_torch.io import readers as tread


def _write(path, header, values):
    with open(path, "w") as f:
        f.write(" ".join(str(h) for h in header) + "\n")
        f.write("\n".join(repr(float(v)) if isinstance(v, float) else str(v) for v in values) + "\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Train/test features and labels and a 'g' window file: 3 features,
    windows [[0, 1], [2]]."""
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(17)
    for part, n in (("train", 150), ("test", 40)):
        X = rng.uniform(size=(n, 3))
        y = np.sin(4 * X[:, 0]) + np.cos(3 * X[:, 1]) * X[:, 2] + 0.05 * rng.normal(size=n)
        _write(root / f"syn.{part}.feature", (n, 3), list(X.T.reshape(-1)))
        _write(root / f"syn.{part}.label", (n,), list(y))
    _write(root / "syn.g.window", (2, 2), [0, 2, 1, -1])
    return str(root)


def test_readers_equal(data):
    for name in ("syn.train.feature", "syn.test.feature"):
        a, b = tread.read_features(os.path.join(data, name)), jread.read_features(os.path.join(data, name))
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tread.read_labels(os.path.join(data, "syn.train.label")),
                                  jread.read_labels(os.path.join(data, "syn.train.label")))
    w = tread.read_windows(os.path.join(data, "syn.g.window"))
    np.testing.assert_array_equal(w, jread.read_windows(os.path.join(data, "syn.g.window")))
    np.testing.assert_array_equal(w, [[0, 1], [2, -1]])
    # the numpy fallback reads the same arrays
    tokens = tread._py_tokens(os.path.join(data, "syn.train.feature"))
    assert int(tokens[0]) == 150 and len(tokens) == 2 + 150 * 3


@pytest.mark.parametrize("precond", ["none", "chol", "nystrom", "fsai", "afn"])
def test_cli_each_precond(data, tmp_path, precond, capsys):
    argv = ["--data-dir", data, "--name", "syn", "--kernel", "gaussian", "--window", "g",
            "--operator", "dense", "--precond", precond, "--adam-maxits", "2", "--learn-maxits", "6",
            "--learn-nvecs", "4", "--rank", "20", "--lfil", "6", "--l", "0.5", "--x64",
            "--platform", "cpu"]
    j = jcli.main(argv)
    t = tcli.main(argv + ["--out-prefix", str(tmp_path / "port")])
    out = capsys.readouterr().out
    assert np.isfinite(t) and "prediction RMSE" in out
    np.testing.assert_allclose(t, j, rtol=0.1)
    pred = np.loadtxt(tmp_path / "port_pred.txt", skiprows=1)
    assert pred.shape == (40, 2) and np.isfinite(pred).all()
    assert np.loadtxt(tmp_path / "port_loss.txt").shape == (2,)
