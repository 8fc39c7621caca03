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

The forward, `forward_regen_tc_kernel`, computes Z[i, (s, a)] = sum_b
L1[b, i] G_s[a, b] for b < 2P - 2 in the same 3xTF32 (L1 and G split), the
last two rows b (the Nyquist mode) as float32 FMAs, then y_s[i] =
sum_w sum_a L0[a, i] Z[i, (s, a)] plus the 1-D windows on the CUDA cores.
Its emulation is held to the same three limits against the float64 forward
of the same float32 phases and weights and the JAX package's regenerating
`packed_forward`; its passes must cover every weight set.
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


NSETS = 5


def _forward_emulated(L, G2, G1, terms):
    """y (nsets, n) in float64 from the forward kernel's split operands:
    terms 3 (3xTF32) or 1 (big * big) on b < 2P - 2, the last two b and the
    1-D windows exact."""
    WR = L.shape[1]
    y = torch.zeros((G2.shape[0], L.shape[2]), dtype=torch.float64)
    for w, (ja, jb) in enumerate(PAIRS):
        Lb, Ls = split_tf32(L[jb, :WR - 2])
        Gb, Gs = split_tf32(G2[:, w, :, :WR - 2].contiguous())
        prods = [(Gb, Lb)] if terms == 1 else [(Gs, Lb), (Gb, Ls), (Gb, Lb)]
        Z = sum(g.double() @ l.double() for g, l in prods)           # (nsets, WR, n)
        Z = Z + G2[:, w, :, WR - 2:].double() @ L[jb, WR - 2:].double()
        y += (L[ja].double()[None] * Z).sum(1)
    for k, j in enumerate(SINGLES):
        y += G1[:, k].double() @ L[j].double()
    return y


@pytest.mark.parametrize("P", [9, 17])
@pytest.mark.parametrize("phase_gen", ["doubling", "direct"])
def test_3xtf32_forward(P, phase_gen):
    xT, _ = _inputs(211 + P)
    rng = np.random.default_rng(7 + P)
    G2 = rng.normal(size=(NSETS, len(PAIRS), 2 * P, 2 * P)).astype(np.float32)
    G1 = rng.normal(size=(NSETS, len(SINGLES), 2 * P)).astype(np.float32)
    L = tpn.phase_slab(torch.from_numpy(xT), P, phase_gen).float()
    g2, g1 = torch.from_numpy(G2), torch.from_numpy(G1)
    exact = tpn.packed_forward_plain(L.double(), g2.double(), g1.double(), PAIRS, SINGLES)
    three = _forward_emulated(L, g2, g1, 3)
    rel3 = _rel(three, exact)
    assert rel3 <= RTOL

    jy = jpn.packed_forward(jnp.asarray(xT), [jnp.asarray(G2[:, w]) for w in range(len(PAIRS))],
                            [jnp.asarray(G1[:, k]) for k in range(len(SINGLES))], P=P, pairs=PAIRS,
                            singles=SINGLES, block=128, interpret=True, phase_gen=phase_gen)
    jax_out = torch.from_numpy(np.stack([np.asarray(v) for v in jy])).double()
    assert _rel(three, jax_out) <= RTOL

    one = _forward_emulated(L, g2, g1, 1)
    assert _rel(one, exact) >= 100 * rel3


@pytest.mark.parametrize("WR", [18, 34])
def test_forward_launch_configuration_covers_every_set_and_point_tile(WR):
    """`forward_regen_split`: the passes cover every weight set once, in
    order, at most max_sets each, for pass limits below, at and above the
    library's 32; and the plain forward run pass by pass, each pass on the
    slices of the weight stacks that the launcher hands the library (the
    leading sets), equals the forward of every set at once.  The point
    tiles are the library's 256-point blocks, held on the card at n = 1,
    37, 256 and 4099 (tests/test_torch_cuda.py)."""
    for max_sets in (1, 3, 4, 32, 40):
        for nsets in list(range(1, 70)) + [200]:
            passes = _cuda_build.forward_regen_split(nsets, max_sets)
            assert [s for s0, ns in passes for s in range(s0, s0 + ns)] == list(range(nsets))
            assert all(1 <= ns <= max_sets for _, ns in passes)
    nsets, rng = 7, np.random.default_rng(WR)
    xT = torch.from_numpy(_inputs(WR)[0]).float()
    G2 = torch.from_numpy(rng.normal(size=(nsets, len(PAIRS), WR, WR)).astype(np.float32))
    G1 = torch.from_numpy(rng.normal(size=(nsets, len(SINGLES), WR)).astype(np.float32))
    whole = tpn.packed_forward_regen_plain(xT, G2, G1, WR // 2, PAIRS, SINGLES)
    parts = torch.cat([tpn.packed_forward_regen_plain(xT, G2[s0:s0 + ns], G1[s0:s0 + ns], WR // 2, PAIRS, SINGLES)
                       for s0, ns in _cuda_build.forward_regen_split(nsets, 3)])
    assert parts.shape == whole.shape == (nsets, N)
    assert _rel(parts, whole) <= 1e-6
