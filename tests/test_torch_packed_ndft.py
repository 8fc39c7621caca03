"""Port parity: the plain versions of the packed NDFT kernels, and the
streamed-engine matvecs built on them, vs the JAX Pallas kernels run in
interpret mode with phase_gen="table_f32" (ops/pallas_ndft.py).

Inputs are float64.  Tolerance: 2e-5 relative to the largest entry -- the
JAX table (pack_phase_table) is stored in float32 and alpha is rounded to it
in table_f32 mode, while the port keeps the data dtype.

Also, on the CPU, the numerics and layout the tensor-core kernels of bf16
tables rely on: the three-term bf16 split of a float32 operand is exact,
and the phase table's storage is padded to 64 points.
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


# --- the tensor-core kernels' numerics and table layout, checked on the CPU ---------

def _top8(x):
    """x truncated to its top 8 significand bits (a bf16 value), float32."""
    return (x.view(torch.int32) & -65536).view(torch.float32)


def _split3(u, split):
    """Three bf16 terms hi + mid + lo of float32 u: "truncate" is the split
    csrc/packed_ndft_tc.cu (`split3`) feeds to the tensor cores, "round" the
    same with round-to-nearest terms."""
    top = _top8 if split == "truncate" else (lambda x: x.to(torch.bfloat16).float())
    r = u - top(u)
    lo = r - top(r)
    assert torch.equal(lo.to(torch.bfloat16).float(), lo)      # lo needs at most 8 bits
    return top(u).to(torch.bfloat16), top(r).to(torch.bfloat16), lo.to(torch.bfloat16)


@pytest.mark.parametrize("split", ["truncate", "round"])
@pytest.mark.parametrize("operand", ["alpha_l0", "weights"])
def test_three_term_split_keeps_float32_products(operand, split):
    """The split is exact, so the three bf16 x bf16 products (exact in
    float32 on the tensor cores) add up to the float32 product within 1 ulp;
    one bf16 term alone misses the kernels' 1e-4 limit on sums of 2e5
    points.  Operands: alpha * L0 of the adjoint (float32 product of a
    float32 alpha and a bf16 table row), and combined weights G of the
    forward (float32, spread over orders of magnitude like fold
    coefficients)."""
    rng = np.random.default_rng(61)
    n, W = 200_000, 32
    T = torch.from_numpy(np.cos(rng.uniform(0, 2 * np.pi, size=(W, n))).astype(np.float32)).to(torch.bfloat16)
    if operand == "alpha_l0":
        alpha = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32))
        L0 = torch.from_numpy(np.sin(rng.uniform(0, 2 * np.pi, size=(3, n))).astype(np.float32))
        u = alpha * L0.to(torch.bfloat16).float()
    else:
        u = torch.from_numpy((rng.normal(size=(3, n)) * np.exp(-rng.uniform(0, 12, size=(3, n))))
                             .astype(np.float32))
    hi, mid, lo = _split3(u, split)
    assert torch.equal(hi.double() + mid.double() + lo.double(), u.double())

    m = 20_000
    Td = T[:, :m].double()
    three = hi[:, None, :m].double() * Td + mid[:, None, :m].double() * Td + lo[:, None, :m].double() * Td
    p32 = u[:, None, :m] * T[:, :m].float()
    ulp = torch.nextafter(p32.abs(), torch.tensor(float("inf"))) - p32.abs()
    assert bool(((three - p32.double()).abs() <= ulp.double()).all())

    exact = u.double() @ T.double().T                          # (3, W) sums over 2e5 points
    single = hi.double() @ T.double().T
    rel = float(torch.linalg.norm(single - exact) / torch.linalg.norm(exact))
    assert rel > 1e-4
    split = hi.double() @ T.double().T + mid.double() @ T.double().T + lo.double() @ T.double().T
    assert float(torch.linalg.norm(split - exact) / torch.linalg.norm(exact)) <= 1e-12


@pytest.mark.parametrize("n", [37, 64, 65])
def test_phase_table_storage_is_padded(rows, n):
    """pack_phase_table returns the first n columns of zero-padded storage
    (64-point rows); the values are those of the unpadded table."""
    xT, _ = rows
    x = torch.tensor(xT[:, :n], dtype=torch.float32)
    Tp = tpn.pack_phase_table(x, 8, table_dtype=torch.bfloat16)
    assert tuple(Tp.shape) == (5, 16, n) and Tp.stride() == (16 * Tp.stride(1), Tp.stride(1), 1)
    assert Tp.stride(1) % tpn.TABLE_PAD == 0 and Tp.stride(1) - n < tpn.TABLE_PAD
    ph = 2.0 * np.pi * xT[:, None, :n] * np.arange(8)[None, :, None]
    want = torch.tensor(np.concatenate([np.cos(ph), np.sin(ph)], axis=1), dtype=torch.float32)
    assert torch.equal(Tp, want.to(torch.bfloat16))
    store = torch.as_strided(Tp, (5, 16, Tp.stride(1)), Tp.stride())
    assert not store[:, :, n:].any()


def test_unaligned_table_copied_to_padded_rows(rows):
    """A contiguous bf16 or float32 table whose rows do not start on 16
    bytes goes to the tensor-core kernels and the wide adjoint as a padded
    copy with the same values; a padded table goes as it is."""
    xT, _ = rows
    for dtype in (torch.bfloat16, torch.float32):
        T = tpn.pack_phase_table(torch.tensor(xT[:, :37], dtype=torch.float32), 8, table_dtype=dtype).contiguous()
        assert T.stride(1) == 37
        Tc = tpn._aligned_table(T)
        assert Tc.stride(1) * Tc.element_size() % 16 == 0 and torch.equal(Tc, T)
        padded = tpn.pack_phase_table(torch.tensor(xT, dtype=torch.float32), 8, table_dtype=dtype)
        assert tpn._aligned_table(padded) is padded


def test_launches_by_shape_reset():
    tpn.packed_adjoint.launches_by_shape["nv=3"] = 2
    tpn.reset_launch_counts()
    assert all(fn.launches_by_shape == {} for fn in tpn.KERNEL_WRAPPERS)
    assert tpn.packed_adjoint.launches == 0
