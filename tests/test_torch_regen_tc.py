"""The numerics of the regenerating adjoint's tensor-core kernel, on the CPU.

csrc/packed_ndft_regen.cu `adjoint_regen_tc_kernel` computes the 2-D windows
C[(r, a), b] = sum_i (alpha_r[i] L0[a, i]) L1[b, i] in 3xTF32: each float32
operand u (the float32 product alpha * L0, and L1) is split as
big = tf32(u), small = tf32(u - big) -- tf32 rounding to nearest, ties away
from zero (cvt.rna), i.e. 11 significant bits -- and each product is
big*big + big*small + small*big, exact in float32 on the tensor cores.  The
CUDA kernel cannot run here, so these tests emulate that arithmetic on
float32 bit patterns in torch, on float32 phases (the port's `phase_slab` in
float64, rounded once) and float32 alpha, at 2P = 18 and 34 and both phase
sources, and hold it:
- against the float64 adjoint of the same float32 phases and alpha:
  relative Frobenius error <= 2e-6 (about 3 * 2^-22 per product, summed
  over a few hundred points);
- against the JAX package's regenerating `packed_adjoint` (Pallas, interpret
  mode, on the same coordinates; its dots return float32 at
  prec="highest"): <= 2e-6;
- with one tf32 product (big * big) instead of three: at least 100x the
  three-term error (tf32 keeps 11 bits: about 2^-11 per product), so the
  comparison above can see a missing term.
The launch configuration's cover of every M tile is checked too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nfft4gp_tpu.ops import pallas_ndft as jpn
from nfft4gp_torch.ops import _cuda_build
from nfft4gp_torch.ops import packed_ndft as tpn

PAIRS = ((0, 1), (2, 3))
SINGLES = (4,)
N, NV = 300, 3
RTOL = 2e-6


def tf32_rna(u):
    """float32 u rounded to tf32 (10 explicit significand bits), to nearest
    with ties away from zero, on its bit pattern (finite u): add half a tf32
    unit to the magnitude bits, clear the low 13."""
    bits = u.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(u):
    big = tf32_rna(u)
    return big, tf32_rna(u - big)


def _reference_rna(u):
    """The same rounding from the definition, in float64: the nearest
    multiple of 2^(e - 11) for |u| in [2^(e-1), 2^e), ties away from zero."""
    d = u.double().numpy()
    m, e = np.frexp(np.abs(d))
    q = np.floor(m * 2.0 ** 11 + 0.5)
    return np.sign(d) * np.ldexp(q, e - 11)


def test_tf32_rounding():
    rng = np.random.default_rng(97)
    u = rng.normal(size=20000) * np.exp(rng.uniform(-20, 20, size=20000))
    base = np.float32(1.0 + 2.0 ** -10)                     # a tf32 value
    ties = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), float(base) + 2.0 ** -11,   # halfway: away from zero
            2.0 - 2.0 ** -23, -(2.0 - 2.0 ** -23),          # rounds up into the next binade
            1.0 + 2.0 ** -11 - 2.0 ** -23, 0.0, -0.0, 0.5, -0.5, 1e-30]
    u = torch.tensor(np.concatenate([u, ties]), dtype=torch.float32)
    big = tf32_rna(u)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    np.testing.assert_array_equal(big.double().numpy(), _reference_rna(u))
    assert float(tf32_rna(torch.tensor([1.0 + 2.0 ** -11]))) == 1.0 + 2.0 ** -10
    assert float(tf32_rna(torch.tensor([2.0 - 2.0 ** -23]))) == 2.0
    # big + small recovers u to 2^-22 |u|; u - big is exact
    b, s = split_tf32(u)
    assert torch.equal((u.double() - b.double()).float().double(), u.double() - b.double())
    err = (b.double() + s.double() - u.double()).abs()
    assert bool((err <= 2.0 ** -22 * u.double().abs()).all())


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xT = rng.uniform(-0.5, 0.5, size=(5, N))
    xT[:, :3] = [0.0, 0.5, -0.5]
    alpha = rng.normal(size=(NV, N)).astype(np.float32)
    return xT, alpha


def _emulated(L, alpha, terms):
    """A2 (nv, npairs, WR, WR) in float64 from the kernel's split operands:
    terms 3 (3xTF32) or 1 (big * big)."""
    out = []
    for ja, jb in PAIRS:
        A = alpha[:, None, :] * L[ja][None]                  # float32 products, as the kernel forms them
        Ab, As = split_tf32(A)
        Bb, Bs = split_tf32(L[jb])
        prods = [(Ab, Bb)] if terms == 1 else [(As, Bb), (Ab, Bs), (Ab, Bb)]
        out.append(sum(a.double() @ b.double().T for a, b in prods))
    return torch.stack(out, dim=1)


def _rel(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("P", [9, 17])
@pytest.mark.parametrize("phase_gen", ["doubling", "direct"])
def test_3xtf32_adjoint(P, phase_gen):
    xT, alpha = _inputs(101 + P)
    L = tpn.phase_slab(torch.from_numpy(xT), P, phase_gen).float()
    a = torch.from_numpy(alpha)
    exact = torch.stack([(a.double()[:, None, :] * L[ja].double()[None]) @ L[jb].double().T
                         for ja, jb in PAIRS], dim=1)
    three = _emulated(L, a, 3)
    rel3 = _rel(three, exact)
    assert rel3 <= RTOL

    jA2, _ = jpn.packed_adjoint(jnp.asarray(xT), jnp.asarray(alpha, dtype=jnp.float64), P=P, pairs=PAIRS,
                                singles=SINGLES, block=128, interpret=True, phase_gen=phase_gen)
    jax_out = torch.from_numpy(np.stack([np.asarray(j) for j in jA2], axis=1)).double()
    assert _rel(three, jax_out) <= RTOL

    one = _emulated(L, a, 1)
    assert _rel(one, exact) >= 100 * rel3


@pytest.mark.parametrize("WR", [16, 18, 32, 34])
def test_launch_configuration_covers_every_m_tile(WR):
    """(nw, wk, mpw) of `adjoint_tc_split`: nw / wk warps along M with mpw
    tiles each cover the ceil(rows / 16) M tiles of the largest block, for
    every nv; a block holds at most 512 rows (512 // WR right-hand sides),
    and wk splits a tile's 8-point k-steps evenly."""
    for nv in range(1, 40):
        nw, wk, mpw = _cuda_build.adjoint_tc_split(WR, nv)
        rows = min(nv, 512 // WR) * WR
        assert rows <= 512 and (nw // wk) * mpw >= -(-rows // 16)
        assert nw * 32 > 2 * 64 and 8 % wk == 0 and nw % wk == 0
