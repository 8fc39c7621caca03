"""Port parity: the plain versions of the packed NDFT kernels, and the
streamed-engine matvecs built on them, vs the JAX Pallas kernels run in
interpret mode with phase_gen="table_f32" (ops/pallas_ndft.py).

Inputs are float64.  Tolerance: 2e-5 relative to the largest entry -- the
JAX table (pack_phase_table) is stored in float32 and alpha is rounded to it
in table_f32 mode, while the port keeps the data dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import fastsum as jfs
from nfft4gp_tpu.ops import pallas_ndft as jpn
from nfft4gp_tpu.ops.kernels import KernelParams as JParams
from nfft4gp_tpu.ops.kernels import make_windows as j_windows
from nfft4gp_torch.ops import fastsum as tfs
from nfft4gp_torch.ops import packed_ndft as tpn
from nfft4gp_torch.ops.kernels import KernelParams as TParams
from nfft4gp_torch.ops.kernels import make_windows as t_windows

RTOL = 2e-5
BLOCK = 128
PAIRS = ((0, 1), (2, 3))
SINGLES = (4,)
JKW = dict(block=BLOCK, interpret=True, prec="highest", phase_gen="table_f32")


def _close(t, j):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=RTOL * np.abs(j).max())


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(53)
    return rng.uniform(-0.25, 0.25, size=(5, 300)), rng


@pytest.mark.parametrize("P", [16, 9])
@pytest.mark.parametrize("nv", [None, 3])
def test_packed_adjoint(rows, P, nv):
    xT, rng = rows
    alpha = rng.normal(size=(xT.shape[1],) if nv is None else (nv, xT.shape[1]))
    tA2, tA1 = tpn.packed_adjoint(tpn.pack_phase_table(torch.tensor(xT), P), torch.tensor(alpha),
                                  pairs=PAIRS, singles=SINGLES)
    jA2, jA1 = jpn.packed_adjoint(jpn.pack_phase_table(jnp.asarray(xT), P, block=BLOCK),
                                  jnp.asarray(alpha), P=P, pairs=PAIRS, singles=SINGLES, **JKW)
    for t, j in zip(tA2 + tA1, jA2 + jA1):
        assert t.shape == j.shape
        _close(t, j)


@pytest.mark.parametrize("P", [16, 9])
@pytest.mark.parametrize("nsets", [1, 4])
def test_packed_forward(rows, P, nsets):
    xT, rng = rows
    G2 = [rng.normal(size=(nsets, 2 * P, 2 * P)) for _ in PAIRS]
    G1 = [rng.normal(size=(nsets, 2 * P)) for _ in SINGLES]
    ty = tpn.packed_forward(tpn.pack_phase_table(torch.tensor(xT), P), [torch.tensor(g) for g in G2],
                            [torch.tensor(g) for g in G1], pairs=PAIRS, singles=SINGLES)
    jy = jpn.packed_forward(jpn.pack_phase_table(jnp.asarray(xT), P, block=BLOCK),
                            [jnp.asarray(g) for g in G2], [jnp.asarray(g) for g in G1], P=P,
                            pairs=PAIRS, singles=SINGLES, n_out=xT.shape[1], **JKW)
    assert len(ty) == len(jy) == nsets
    for t, j in zip(ty, jy):
        _close(t, j)


@pytest.fixture(scope="module")
def plans():
    rng = np.random.default_rng(59)
    n = 256
    X = rng.uniform(size=(n, 5))
    windows = [[0, 1], [2, 3], [4]]
    tplan = tfs.additive_fastsum_build("gaussian", TParams.make(0.9, 0.5, 0.04, dtype=torch.float64),
                                       torch.tensor(X), t_windows(windows), N=32)
    jplan = jfs.additive_fastsum_build("gaussian", JParams.make(0.9, 0.5, 0.04), jnp.asarray(X),
                                       j_windows(windows), N=32, nearfield_lfil=0)
    return tfs.packed_ndft_plan(tplan), jfs.packed_ndft_plan(jplan, block=BLOCK), rng.normal(size=(3, n))


def test_packed_ndft_matvecs(plans):
    tp, jp, V = plans
    kw = dict(interpret=True, upcast=True, prec="highest")
    _close(tfs.packed_ndft_matvec(tp, torch.tensor(V[0])), jfs.packed_ndft_matvec(jp, jnp.asarray(V[0]), **kw))
    _close(tfs.packed_ndft_grad_matvec(tp, torch.tensor(V[0])),
           jfs.packed_ndft_grad_matvec(jp, jnp.asarray(V[0]), **kw))
    tb = tfs.packed_ndft_matvec_batch(tp, torch.tensor(V))
    assert tb.shape == V.shape
    _close(tb, jfs.packed_ndft_matvec_batch(jp, jnp.asarray(V), **kw))
    tg = tfs.packed_ndft_grad_matvec_batch(tp, torch.tensor(V))
    assert tg.shape == (V.shape[0], 3, V.shape[1])
    _close(tg, jfs.packed_ndft_grad_matvec_batch(jp, jnp.asarray(V), **kw))


def test_wrapper_rules(rows):
    xT, _ = rows
    Tp = tpn.pack_phase_table(torch.tensor(xT), 16)
    before = (tpn.packed_adjoint.launches, tpn.packed_forward.launches)
    tpn.packed_adjoint(Tp, torch.ones(xT.shape[1], dtype=torch.float64), pairs=PAIRS)
    assert (tpn.packed_adjoint.launches, tpn.packed_forward.launches) == before  # CPU: no kernel
    with pytest.raises(ValueError):
        tpn.packed_adjoint(Tp, torch.ones(xT.shape[1] + 1, dtype=torch.float64), pairs=PAIRS)
    with pytest.raises(ValueError):
        tpn.packed_adjoint(Tp, torch.ones(xT.shape[1], dtype=torch.float64), pairs=((0, 7),))
