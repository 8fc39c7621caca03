"""Calls with more windows than one kernel launch takes (ops/packed_ndft.py
`window_groups`, `grouped_adjoint`, `grouped_forward`).

A CUDA launch takes at most MAX_PAIRS = 32 2-D and MAX_SINGLES = 64 1-D
windows; the wrappers run a larger call in groups of launches.  Here the
grouping runs with the plain versions as its launch, on CPU float64, at 33
pairs and 65 singles (one window past each limit), against the unsplit
plain call: the adjoint's per-window outputs concatenate, so they are equal
bit for bit; the forward's groups add in another order than the unsplit
call's running sum, so they agree to float64 rounding (1e-13 of the largest
entry).  And the grouped plain adjoint at 33 pairs against the JAX Pallas
kernel in interpret mode (jitted, n = 200, tolerance of a float64 table as
in test_torch_wide.py's regenerating cases).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import pallas_ndft as jpn
from nfft4gp_torch.ops import packed_ndft as tpn

N, P = 200, 8
PAIRS = tuple((2 * w, 2 * w + 1) for w in range(33))
SINGLES = tuple(range(65))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(33)
    xT = rng.uniform(-0.25, 0.25, size=(66, N))
    return torch.tensor(xT), rng


@pytest.mark.parametrize("npairs,nsingles,want", [
    (1, 0, [((0, 1), (0, 0))]),
    (32, 64, [((0, 32), (0, 64))]),
    (33, 65, [((0, 32), (0, 64)), ((32, 33), (64, 65))]),
    (0, 129, [((0, 0), (0, 64)), ((0, 0), (64, 128)), ((0, 0), (128, 129))]),
    (70, 3, [((0, 32), (0, 3)), ((32, 64), (3, 3)), ((64, 70), (3, 3))]),
])
def test_window_groups(npairs, nsingles, want):
    """Groups in window order, each within one launch's limits, every
    window once, no empty group."""
    groups = tpn.window_groups(npairs, nsingles)
    assert [((p.start, p.stop), (s.start, s.stop)) for p, s in groups] == want
    for p, s in groups:
        assert 0 < (p.stop - p.start) + (s.stop - s.start)
        assert p.stop - p.start <= tpn.MAX_PAIRS and s.stop - s.start <= tpn.MAX_SINGLES


@pytest.mark.parametrize("source", ["table", "doubling"])
def test_grouped_adjoint_equals_unsplit(data, source):
    """33 pairs and 65 singles in two launches of the plain versions: the
    same outputs, bit for bit, as one unsplit plain call."""
    x, rng = data
    alpha = torch.tensor(rng.normal(size=(3, N)))
    calls = []

    if source == "table":
        Tp = tpn.pack_phase_table(x, P)

        def launch(pr, sg):
            calls.append((len(pr), len(sg)))
            return tpn.packed_adjoint_plain(Tp, alpha, pr, sg)

        want = tpn.packed_adjoint_plain(Tp, alpha, PAIRS, SINGLES)
    else:
        def launch(pr, sg):
            calls.append((len(pr), len(sg)))
            return tpn.packed_adjoint_regen_plain(x, alpha, P, pr, sg)

        want = tpn.packed_adjoint_regen_plain(x, alpha, P, PAIRS, SINGLES)
    A2, A1 = tpn.grouped_adjoint(launch, PAIRS, SINGLES)
    assert calls == [(32, 64), (1, 1)]
    assert torch.equal(A2, want[0]) and torch.equal(A1, want[1])


@pytest.mark.parametrize("source", ["table", "doubling"])
def test_grouped_forward_equals_unsplit(data, source):
    """33 pairs and 65 singles in two launches of the plain versions, the
    groups' sums added in launch order: the unsplit plain call's result to
    float64 rounding, and a second grouped call bit for bit."""
    x, rng = data
    nsets = 4
    G2 = torch.tensor(rng.normal(size=(nsets, len(PAIRS), 2 * P, 2 * P)))
    G1 = torch.tensor(rng.normal(size=(nsets, len(SINGLES), 2 * P)))
    calls = []

    if source == "table":
        Tp = tpn.pack_phase_table(x, P)

        def launch(g2, g1, pr, sg):
            calls.append((tuple(g2.shape), tuple(g1.shape)))
            return tpn.packed_forward_plain(Tp, g2, g1, pr, sg)

        want = tpn.packed_forward_plain(Tp, G2, G1, PAIRS, SINGLES)
    else:
        def launch(g2, g1, pr, sg):
            calls.append((tuple(g2.shape), tuple(g1.shape)))
            return tpn.packed_forward_regen_plain(x, g2, g1, P, pr, sg)

        want = tpn.packed_forward_regen_plain(x, G2, G1, P, PAIRS, SINGLES)
    y = tpn.grouped_forward(launch, G2, G1, PAIRS, SINGLES)
    assert calls == [((nsets, 32, 16, 16), (nsets, 64, 16)), ((nsets, 1, 16, 16), (nsets, 1, 16))]
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=0, atol=1e-13 * float(want.abs().max()))
    assert torch.equal(tpn.grouped_forward(launch, G2, G1, PAIRS, SINGLES), y)


def test_grouped_adjoint_matches_jax_at_33_pairs(data):
    """The grouped plain adjoint (two launches) at 33 pairs against the JAX
    kernel (one pallas_call, its own window tiles) in interpret mode."""
    x, rng = data
    alpha = rng.normal(size=(2, N))
    A2, _ = tpn.grouped_adjoint(
        lambda pr, sg: tpn.packed_adjoint_regen_plain(x, torch.tensor(alpha), P, pr, sg), PAIRS, ())
    jA2, _ = jpn.packed_adjoint(jnp.asarray(x.numpy()), jnp.asarray(alpha), P=P, pairs=PAIRS, block=128,
                                interpret=True)
    assert A2.shape == (2, 33, 2 * P, 2 * P) and len(jA2) == 33
    j = np.stack([np.asarray(a) for a in jA2], axis=1)
    np.testing.assert_allclose(A2.numpy(), j, rtol=2e-6, atol=2e-6 * np.abs(j).max())
