"""Card-only checks of the port's CUDA kernels (marker `cuda`).

They need an NVIDIA GPU and nvcc, and skip without a CUDA device.  On a GPU
machine (this file imports no jax; --noconftest keeps tests/conftest.py,
which configures JAX, out of the run):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain torch version on the same CUDA
tensors, at small shapes that reach the edge cases the training shapes of
chip_smoke.py do not: both compiled widths of each kernel (2P = 16, 32 for
the table kernels, 18, 34 for the regenerating ones), f32 and bf16 tables,
both phase sources ("doubling", "direct"), a ragged last tile, fewer points
than one tile, weight-set counts that straddle the forward's set tiles,
layouts with only 2-D or only 1-D windows, the 32-pair / 64-single
limits of one launch, and calls one window past them (33 pairs and 65
singles: two launches, on every route).

The regenerating adjoint (tensor cores, 3xTF32, csrc/packed_ndft_regen.cu)
is held over 1, 3 and 32 pairs with and without 1-D windows, n = 1, 7, 63,
64, 65, 2047, 20001, nv = 1 to 33 (every launch configuration and more
right-hand sides than one 512-row block holds), coordinates at 0 and
+-0.5, with a bitwise-equal second launch.  The regenerating forward
(tensor cores, 3xTF32, its 1-D windows in the same launch) is held at
n = 1, 37, 256 (one 256-point block), 4099, nsets = 1, 2, 3, 7, 8, 10, 17,
20 and 33 (set groups of 4, two passes of at most 32 sets), pairs and singles
together and alone, and at the 32-pair / 64-single limits, with a
bitwise-equal second launch.

The tensor-core kernels of bf16 tables (csrc/packed_ndft_tc.cu) are held
at their own edges: n = 1, 63, 64, 65 (one 64-point tile and its
neighbours), 37, 4099 and 2e4; nv = 1, 2, 3, 10, 16, 20 (the k-split and
the M tiles per warp change at 2, 4, 8, 16 and 24 tiles of 16 rows; at
2P = 32 the grid tiles more than 16 right-hand sides); nsets = 1, 2, 8,
9, 10, 20, 21 (set groups of 4, 8-column N tiles at 2P = 32) and 33 (two
passes of at most 32 sets); 2P = 16 and 32, with and without 1-D windows; a
table view of padded storage whose pad holds NaN; and a second launch
bitwise equal to the first.

The wide pair (csrc/packed_ndft_wide.cu: every even 2P the narrow kernels
are not built for) is held at 2P = 2, 8, 48, 64, 130, 256, 258, 600, 1026
(below, at and past the forward's 64-wide tiles, the regenerating widths
8k + 2, the old 1026 cap), every phase source (float32 and bf16 tables,
"doubling", "direct"), only 2-D, only 1-D and both window kinds, nv = 1,
3, 10, 17 and nsets = 1, 2, 20, 33 (two 32-set blocks) at n = 997, ragged
n = 1 to 20001, a bf16 table with unpadded rows, a bitwise-equal second
launch; the regenerating sources' phase slab cut into point ranges; the
wrappers' routes by width (2P = 1028 to the wide pair: no width cap); and
[afn-pcg-256]'s shape.  Its adjoint's 2-D windows (wgmma, 3xTF32; two
products on bf16 tables) are held at 2P = 2 to 2050 (every compiled N-tile
width, 64, 72, 128, 136 and 144, one tile or several, one or two runs of
L0 rows a block), nv = 1 to 17 and n = 1 to 100003,
every phase source, at 1e-4 against the plain versions.  Its forward's 2-D
windows (wgmma, 3xTF32, the points as M; two products on bf16 tables) are
held at the same widths (N tiles of 64, 72, 128 and 136), nsets = 1 to 33
(two 32-set blocks) and n = 1 to 100003, every phase source, at 1e-4; a
table at an unpadded stride reaches it through a padded copy, strided
weights at 2P = 130 through its weight split (bitwise the plain split),
and its C entry point refuses misaligned pointers and strides.
Its regenerating sources are held against the
plain versions in float64 with 1e-4: a float32 coordinate's phase
2 pi p x errs by about p |x| 2^-22 (3e-5 at p = 512).

The cooperative dense Krylov kernels (solvers/fused_pcg.py, csrc/fused_pcg.cu)
are held against their plain versions at n = 1, 31, 33, 1000 (not a
multiple of a warp or a panel) and at the n <= 16384 limit, nv = 1 to the
16-probe limit, maxits = 1 to the 64-step limit, b = 0, breakdowns (K = 0,
a rank-3 K, a zero probe), and a second launch bitwise equal to the first;
under their launch plans at the card's resident capacity (every row or
column panel of K in shared memory) and one past it, at n = 4096 (part of K
streamed every step; Lanczos at nv = 16, maxits = 64) and below the SM
count, under hand-made plans that stream all of K or give a block several
panels; the C entry points refuse inconsistent plans; the plans' constants
are the C side's; the timed barrier probe runs one block an SM.

Tolerances:
- dense Krylov kernels, on K = I + S, S symmetric with a spectrum in
  about [-0.3, 0.3] (cond ~2, so float32 rounding is not amplified): CG
  niter within 1, x within 1e-5 of max|x|, relres at maxits rtol 1e-3 /
  atol 1e-6 (n = 1 converges in one step to a rounding-level residual); Lanczos alpha, beta within 1e-4 of max|alpha|, V within 1e-4
  relative Frobenius, beta0 rtol 1e-6 -- float32 sums in other orders;
- a precond="chol" dense loss step (float32) on the card against CPU
  tensors: loss rtol 1e-4, gradient rtol 1e-3 / atol 1e-4 -- float32
  Cholesky factors of a K with condition ~1e3 from two libraries; the
  multiclass loss in float64: rtol 1e-10;
- kernels: relative Frobenius error 1e-5 -- the same products summed in
  another order in float32, about sqrt(n) eps for n of a few thousand; the
  regenerated phases differ from torch's cos/sin by about 1e-6; the 3xTF32
  products of the regenerating adjoint by about 3 * 2^-22;
- a whole loss step on the card against the same step on CPU tensors (plain
  versions), float32: for the stream engine loss rtol 1e-4, gradient rtol
  1e-3 / atol 1e-4 -- the kernels' float32 rounding carried through the
  FGMRES solve and the SLQ estimate; for the fused matern12 engine, at
  mu = 1 where its FGMRES converges, loss rtol 1e-3, gradient rtol 1e-2 /
  atol 1e-3 -- at mu = 0.1 the 20-step FGMRES stops unconverged and float32
  rounding alone moved the loss by 5e-3 between card and CPU;
- the stream engine's radius near-field (float32 on the card against CPU
  float64 copies of the points): relative Frobenius error 5e-5 of its K and
  dK/dl products (float32 against float64 on the CPU: 1.7e-5 at n = 2e4,
  2.6e-6 at n = 2000; the values are small differences of O(1) terms); a
  matern12 stream loss step at mu = 1 with float32 tables against CPU
  float64, as the fused one;
- prediction on the card (float32) against CPU float64: mean 1e-4, std 1e-5
  relative L2 (float32 against float64 on the CPU: 1.2e-5 / 1.3e-6 for the
  fastsum predictor, 6.6e-6 / 2.4e-6 for the dense one).

float64 numpy inputs with the default device run fit and predict on the
card in float32: finite values, the table kernels launched.

The AFN and FSAI preconditioners (plain torch) at n = 4096, float32 on the
card against CPU float64 on the same plan or pattern: relative Frobenius
5e-3 for AFN's factors, solve, dvp, logdet and trace, 2e-4 for FSAI's
(float32 against float64 on the CPU: up to 5.1e-4 and 2.0e-5; AFN's
landmark Cholesky has condition ~1e3); the FSAI row repair through
cholesky_ex on the card equal to the CPU's (float64, 1e-12); and the
float32-table kernels (csrc/packed_ndft.cu) at chip_smoke's [afn-pcg]
shape, n = 1e5, one 2-D window, 2P = 32, nv = 1 and nsets = 1: relative
Frobenius 1e-4 against the plain versions (sqrt(n) eps for 1e5-term
sums), a second launch bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nfft4gp_torch.models.problem import GPProblem
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.models import multiclass as mc
from nfft4gp_torch.ops import _cuda_build
from nfft4gp_torch.ops import packed_ndft as pk
from nfft4gp_torch.solvers import fused_pcg as fp

pytestmark = pytest.mark.cuda

KERNEL_RTOL = 1e-5
LAYOUTS = {
    "mixed": (((0, 1), (2, 3)), (4,)),
    "pairs": (((0, 1), (2, 3), (1, 4)), ()),
    "singles": ((), (0, 2, 4)),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _table(dev, n, P, dtype, seed=0):
    rng = np.random.default_rng(seed)
    xT = torch.from_numpy(rng.uniform(-0.25, 0.25, size=(5, n)).astype(np.float32)).to(dev)
    return pk.pack_phase_table(xT, P, table_dtype=dtype), rng


def _rel(got, want):
    return float(torch.linalg.norm((got - want).double()) / torch.linalg.norm(want.double()))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [37, 4099])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nv", [1, 9])
def test_adjoint_matches_plain(dev, layout, n, P, dtype, nv):
    pairs, singles = LAYOUTS[layout]
    Tp, rng = _table(dev, n, P, dtype)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    A2, A1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
    torch.cuda.synchronize()
    W2, W1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    got = torch.cat([torch.stack(A2, 1).reshape(-1) if A2 else alpha.new_zeros(0),
                     torch.stack(A1, 1).reshape(-1) if A1 else alpha.new_zeros(0)])
    assert _rel(got, torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [37, 4099])
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("nsets", [1, 9, 17])
def test_forward_matches_plain(dev, layout, n, P, dtype, nsets):
    pairs, singles = LAYOUTS[layout]
    Tp, rng = _table(dev, n, P, dtype)

    def weights(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    G2 = [weights(nsets, 2 * P, 2 * P) for _ in pairs]
    G1 = [weights(nsets, 2 * P) for _ in singles]
    ys = pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles)
    torch.cuda.synchronize()
    want = pk.packed_forward_plain(Tp, torch.stack(G2, 1) if pairs else None,
                                   torch.stack(G1, 1) if singles else None, pairs, singles)
    assert len(ys) == nsets
    assert _rel(torch.stack(ys), want) <= KERNEL_RTOL


TC_LAYOUTS = {"pairs": LAYOUTS["pairs"], "mixed": LAYOUTS["mixed"]}
TC_NS = [1, 63, 64, 65, 37, 4099, 20000]


def _tc_inputs(dev, n, P, nan_pad=False):
    """A bf16 table for the tensor-core kernels; with nan_pad, a view of
    storage 128 points wider than n whose pad columns hold NaN."""
    Tp, rng = _table(dev, n, P, torch.bfloat16)
    if nan_pad:
        store = torch.full((*Tp.shape[:2], Tp.stride(1) + 128), float("nan"), dtype=torch.bfloat16, device=dev)
        store[:, :, :n] = Tp
        Tp = store[:, :, :n]
    return Tp, rng


@pytest.mark.parametrize("layout", sorted(TC_LAYOUTS))
@pytest.mark.parametrize("n", TC_NS)
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("nv", [1, 2, 3, 10, 16, 20])
def test_tc_adjoint_matches_plain(dev, layout, n, P, nv):
    pairs, singles = TC_LAYOUTS[layout]
    Tp, rng = _tc_inputs(dev, n, P)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    before = pk.packed_adjoint.launches_by_shape.get(f"nv={nv}", 0)
    A2, A1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
    B2, B1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
    torch.cuda.synchronize()
    assert pk.packed_adjoint.launches_by_shape[f"nv={nv}"] == before + 2
    got = torch.cat([torch.stack(A2, 1).reshape(-1), torch.stack(A1, 1).reshape(-1) if A1 else alpha.new_zeros(0)])
    again = torch.cat([torch.stack(B2, 1).reshape(-1), torch.stack(B1, 1).reshape(-1) if B1 else alpha.new_zeros(0)])
    assert torch.equal(got, again)
    W2, W1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    assert _rel(got, torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL


@pytest.mark.parametrize("layout", sorted(TC_LAYOUTS))
@pytest.mark.parametrize("n", TC_NS)
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("nsets", [1, 2, 8, 9, 10, 20, 21, 33])
def test_tc_forward_matches_plain(dev, layout, n, P, nsets):
    pairs, singles = TC_LAYOUTS[layout]
    Tp, rng = _tc_inputs(dev, n, P)

    def weights(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    G2 = [weights(nsets, 2 * P, 2 * P) for _ in pairs]
    G1 = [weights(nsets, 2 * P) for _ in singles]
    before = pk.packed_forward.launches_by_shape.get(f"nsets={nsets}", 0)
    ys = torch.stack(pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles))
    again = torch.stack(pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles))
    torch.cuda.synchronize()
    assert pk.packed_forward.launches_by_shape[f"nsets={nsets}"] == before + 2
    assert torch.equal(ys, again)
    want = pk.packed_forward_plain(Tp, torch.stack(G2, 1), torch.stack(G1, 1) if singles else None,
                                   pairs, singles)
    assert tuple(ys.shape) == (nsets, n)
    assert _rel(ys, want) <= KERNEL_RTOL


@pytest.mark.parametrize("n", [37, 4099])
@pytest.mark.parametrize("kind", ["adjoint", "forward", "unaligned"])
def test_tc_padded_and_unaligned_tables(dev, n, kind):
    """A view of padded storage whose pad holds NaN: the kernels read no
    point past n.  A contiguous table with rows off 16-byte boundaries
    (copied to padded storage by the wrapper) gives the same results."""
    pairs, singles = LAYOUTS["mixed"]
    Tp, rng = _tc_inputs(dev, n, 16, nan_pad=kind != "unaligned")
    if kind == "unaligned":
        Tp = Tp.contiguous()
        assert Tp.stride(1) == n
    alpha = torch.from_numpy(rng.normal(size=(10, n)).astype(np.float32)).to(dev)
    if kind != "forward":
        A2, A1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
        W2, W1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
        assert _rel(torch.cat([torch.stack(A2, 1).reshape(-1), torch.stack(A1, 1).reshape(-1)]),
                    torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL
    if kind != "adjoint":
        G2 = [torch.from_numpy(rng.normal(size=(20, 32, 32)).astype(np.float32)).to(dev) for _ in pairs]
        G1 = [torch.from_numpy(rng.normal(size=(20, 32)).astype(np.float32)).to(dev) for _ in singles]
        ys = torch.stack(pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles))
        want = pk.packed_forward_plain(Tp, torch.stack(G2, 1), torch.stack(G1, 1), pairs, singles)
        assert bool(torch.isfinite(ys).all()) and _rel(ys, want) <= KERNEL_RTOL


def test_wrappers_count_and_refuse(dev):
    Tp, rng = _table(dev, 300, 16, torch.bfloat16)
    alpha = torch.ones((2, 300), device=dev)
    G2 = [torch.ones((3, 32, 32), device=dev)]
    before = (pk.packed_adjoint.launches, pk.packed_forward.launches)
    pk.packed_adjoint(Tp, alpha, pairs=((0, 1),))
    pk.packed_forward(Tp, G2, pairs=((0, 1),))
    assert (pk.packed_adjoint.launches, pk.packed_forward.launches) == (before[0] + 1, before[1] + 1)

    wide, _ = _table(dev, 300, 24, torch.bfloat16)          # 2P = 48: the wide pair, counted there
    wide_before = pk.WIDE_ADJOINT.launches_by_shape.get("2P=48 nv=2", 0)
    pk.packed_adjoint(wide, alpha, pairs=((0, 1),))
    assert pk.WIDE_ADJOINT.launches_by_shape["2P=48 nv=2"] == wide_before + 1
    past_cap, _ = _table(dev, 300, 514, torch.bfloat16)     # 2P = 1028: the wide pair too (no width cap)
    pk.packed_adjoint(past_cap, alpha, pairs=((0, 1),))
    assert pk.WIDE_ADJOINT.launches_by_shape["2P=1028 nv=2"] >= 1
    with pytest.raises(ValueError):                          # float64 alpha
        pk.packed_adjoint(Tp, alpha.double(), pairs=((0, 1),))
    with pytest.raises(ValueError):                          # alpha on the CPU
        pk.packed_adjoint(Tp, alpha.cpu(), pairs=((0, 1),))
    with pytest.raises(ValueError):                          # float64 weights
        pk.packed_forward(Tp, [G2[0].double()], pairs=((0, 1),))
    assert (pk.packed_adjoint.launches, pk.packed_forward.launches) == (before[0] + 1, before[1] + 1)


def _coords(dev, n, rows=5, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.25, 0.25, size=(rows, n)).astype(np.float32)).to(dev), rng


_WIDE = tuple((2 * w, 2 * w + 1) for w in range(32))
REGEN_LAYOUTS = {
    "one": (((0, 1),), ()),
    "one+single": (((0, 1),), (64,)),
    "pairs": (((0, 1), (2, 3), (1, 4)), ()),
    "pairs+single": (((0, 1), (2, 3), (1, 4)), (65,)),
    "wide": (_WIDE, ()),
    "wide+singles": (_WIDE, (64, 65)),
    "singles": ((), (0, 2, 4)),
}


@pytest.mark.parametrize("layout", sorted(REGEN_LAYOUTS))
@pytest.mark.parametrize("n", [1, 7, 63, 64, 65, 2047, 20001])
@pytest.mark.parametrize("P", [9, 17])
@pytest.mark.parametrize("phase_gen", pk.PHASE_GENS)
@pytest.mark.parametrize("nv", [1, 2, 3, 4, 8, 10, 15, 16, 20, 33])
def test_adjoint_regen_matches_plain(dev, layout, n, P, phase_gen, nv):
    """The tensor-core 2-D windows (3xTF32) and the CUDA-core 1-D windows:
    1, 3 and 32 pairs with and without 1-D windows; n around the 64-point
    tile; nv across the M-tile counts of the launch configurations (2, 4, 8,
    16, 24, 32 tiles) and past the 512-row block (28 rhs at 2P = 18, 15 at
    34); coordinates at 0 and +-0.5 among uniform ones in [-0.5, 0.5).  A
    second launch is bitwise equal and both are counted."""
    pairs, singles = REGEN_LAYOUTS[layout]
    rng = np.random.default_rng(n + nv)
    x = rng.uniform(-0.5, 0.5, size=(66, n)).astype(np.float32)
    x[:, :3] = np.array([0.0, 0.5, -0.5], dtype=np.float32)[:min(3, n)]
    xT = torch.from_numpy(x).to(dev)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    before = pk.packed_adjoint_regen.launches_by_shape.get(f"nv={nv}", 0)
    runs = [pk.packed_adjoint_regen(xT, alpha, P=P, pairs=pairs, singles=singles, phase_gen=phase_gen)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert pk.packed_adjoint_regen.launches_by_shape[f"nv={nv}"] == before + 2
    got, again = (torch.cat([torch.stack(A2, 1).reshape(-1) if A2 else alpha.new_zeros(0),
                             torch.stack(A1, 1).reshape(-1) if A1 else alpha.new_zeros(0)]) for A2, A1 in runs)
    assert torch.equal(got, again)
    W2, W1 = pk.packed_adjoint_regen_plain(xT, alpha, P, pairs, singles, phase_gen)
    assert _rel(got, torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [1, 37, 256, 4099])
@pytest.mark.parametrize("P", [9, 17])
@pytest.mark.parametrize("phase_gen", pk.PHASE_GENS)
@pytest.mark.parametrize("nsets", [1, 2, 3, 7, 8, 10, 17, 20, 33])
def test_forward_regen_matches_plain(dev, layout, n, P, phase_gen, nsets):
    """The tensor-core forward (3xTF32) with its 1-D windows in the same
    launch: pairs and singles together or alone; n below one 256-point
    block, one block exactly and not a multiple of it; nsets within one
    set group, across groups of 4 and past a pass's 32 sets (two passes).
    A second launch is bitwise equal and both are counted.  The reference
    is the plain version in float64 on the same float32 inputs: at n = 1
    the float32 plain version's own phase rounding (2 pi p x formed in
    float32) moves its one output by about 1e-5 relative."""
    pairs, singles = LAYOUTS[layout]
    xT, rng = _coords(dev, n)

    def weights(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    G2 = [weights(nsets, 2 * P, 2 * P) for _ in pairs]
    G1 = [weights(nsets, 2 * P) for _ in singles]
    before = pk.packed_forward_regen.launches_by_shape.get(f"nsets={nsets}", 0)
    ys, again = (torch.stack(pk.packed_forward_regen(xT, G2, G1, P=P, pairs=pairs, singles=singles,
                                                     phase_gen=phase_gen)) for _ in range(2))
    torch.cuda.synchronize()
    assert pk.packed_forward_regen.launches_by_shape[f"nsets={nsets}"] == before + 2
    assert torch.equal(ys, again)
    want = pk.packed_forward_regen_plain(xT.double(), torch.stack(G2, 1).double() if pairs else None,
                                         torch.stack(G1, 1).double() if singles else None, P, pairs, singles,
                                         phase_gen)
    assert tuple(ys.shape) == (nsets, n)
    assert _rel(ys, want) <= KERNEL_RTOL


@pytest.mark.parametrize("nsets", [1, 2, 3, 10, 20, 33])
@pytest.mark.parametrize("kind", ["pairs", "singles"])
def test_regen_window_limits(dev, kind, nsets):
    """32 pairs / 64 singles run in one launch, the forward at every set
    count; one window more runs in two launches (the grouping of
    `window_groups`) and matches the plain version; 2P = 1028 runs on the
    wide pair; float64 coordinates raise before any launch."""
    n, P = 300, 17
    xT, rng = _coords(dev, n, rows=66)
    if kind == "pairs":
        full, over = tuple((2 * w, 2 * w + 1) for w in range(32)), {"pairs": tuple((2 * w, 2 * w + 1)
                                                                                  for w in range(33))}
        kw = {"pairs": full}
    else:
        full, over = tuple(range(64)), {"pairs": (), "singles": tuple(range(65))}
        kw = {"pairs": (), "singles": full}
    alpha = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    before = (pk.packed_adjoint_regen.launches, pk.packed_forward_regen.launches)
    A2, A1 = pk.packed_adjoint_regen(xT, alpha, P=P, **kw)
    torch.cuda.synchronize()
    W2, W1 = pk.packed_adjoint_regen_plain(xT, alpha, P, kw["pairs"], kw.get("singles", ()))
    got = torch.stack(A2, 1) if A2 else torch.stack(A1, 1)
    assert _rel(got, W2 if A2 else W1) <= KERNEL_RTOL
    G = [torch.from_numpy(rng.normal(size=(nsets, 2 * P, 2 * P) if A2 else (nsets, 2 * P)).astype(np.float32))
         .to(dev) for _ in range(len(full) + 1)]
    ys = pk.packed_forward_regen(xT, G[:-1] if A2 else (), () if A2 else G[:-1], P=P, **kw)
    torch.cuda.synchronize()
    want = pk.packed_forward_regen_plain(xT, torch.stack(G[:-1], 1) if A2 else None,
                                         None if A2 else torch.stack(G[:-1], 1), P, kw["pairs"],
                                         kw.get("singles", ()))
    assert _rel(torch.stack(ys), want) <= KERNEL_RTOL
    assert (pk.packed_adjoint_regen.launches, pk.packed_forward_regen.launches) == (before[0] + 1, before[1] + 1)
    # one window more: two launches each, the same values as the plain versions
    O2, O1 = pk.packed_adjoint_regen(xT, alpha, P=P, **over)
    V2, V1 = pk.packed_adjoint_regen_plain(xT, alpha, P, over["pairs"], over.get("singles", ()))
    assert _rel(torch.stack(O2, 1) if A2 else torch.stack(O1, 1), V2 if A2 else V1) <= KERNEL_RTOL
    yo = pk.packed_forward_regen(xT, G if A2 else (), () if A2 else G, P=P, **over)
    wo = pk.packed_forward_regen_plain(xT, torch.stack(G, 1) if A2 else None, None if A2 else torch.stack(G, 1), P,
                                       over["pairs"], over.get("singles", ()))
    assert _rel(torch.stack(yo), wo) <= KERNEL_RTOL
    assert (pk.packed_adjoint_regen.launches, pk.packed_forward_regen.launches) == (before[0] + 3, before[1] + 3)
    wide_before = (pk.WIDE_ADJOINT.launches, pk.WIDE_FORWARD.launches)
    pk.packed_adjoint_regen(xT, alpha, P=514, **kw)              # 2P = 1028: the wide pair
    G1028 = [torch.zeros((1, 1028, 1028) if A2 else (1, 1028), device=dev)] * len(full)
    pk.packed_forward_regen(xT, G1028 if A2 else (), () if A2 else G1028, P=514, **kw)
    torch.cuda.synchronize()
    assert (pk.WIDE_ADJOINT.launches, pk.WIDE_FORWARD.launches) == (wide_before[0] + 1, wide_before[1] + 1)
    with pytest.raises(ValueError):                        # float64 coordinates
        pk.packed_adjoint_regen(xT.double(), alpha, P=P, **kw)
    with pytest.raises(ValueError):
        pk.packed_forward_regen(xT.double(), G[:-1] if A2 else (), () if A2 else G[:-1], P=P, **kw)
    assert (pk.packed_adjoint_regen.launches, pk.packed_forward_regen.launches) == (before[0] + 3, before[1] + 3)


def test_loss_step_on_card_matches_cpu(dev):
    rng = np.random.default_rng(7)
    n = 3000
    X = rng.uniform(size=(n, 5)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    kw = dict(kernel="gaussian", windows=[[0, 1], [2, 3], [4]], operator="fastsum",
              precond="nystrom", rank=30, maxits=8, nvecs=4, fastsum_N=32, fastsum_engine="stream")
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4, n)).astype(np.float32))
    landmarks = torch.from_numpy(rng.permutation(n)[:30])
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1]))

    def step(device):
        loss_fn = GPProblem(**kw).make_loss(torch.from_numpy(X).to(device), torch.from_numpy(y).to(device),
                                            probes=probes, landmarks=landmarks)
        return loss_fn(raw.to(device))

    before = pk.packed_forward.launches
    loss_c, grad_c = step(dev)
    assert pk.packed_forward.launches > before
    loss_h, grad_h = step(torch.device("cpu"))
    assert np.isfinite(float(loss_c))
    np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-4)
    np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=1e-3, atol=1e-4)


def test_fused_matern12_step_on_card_matches_cpu(dev):
    """One fused-engine matern12 loss step (KNN near-field, a 3-feature
    window on the table path) on the card against the same step on CPU
    tensors, with the same near-field patterns."""
    rng = np.random.default_rng(11)
    n = 3000
    X = rng.uniform(size=(n, 6)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 3]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    kw = dict(kernel="matern12", windows=[[0, 1, 2], [3, 4], [5]], operator="fastsum",
              precond="nystrom", rank=30, maxits=8, nvecs=4, fastsum_N=32, fastsum_fused=True)
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4, n)).astype(np.float32))
    landmarks = torch.from_numpy(rng.permutation(n)[:30])
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0]))
    before = (pk.packed_adjoint_regen.launches, pk.packed_forward_regen.launches)
    prob = GPProblem(**kw)
    loss_c, grad_c = prob.make_loss(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev),
                                    probes=probes, landmarks=landmarks)(raw.to(dev))
    assert pk.packed_adjoint_regen.launches > before[0]
    assert pk.packed_forward_regen.launches > before[1]
    pats = tuple(None if p is None else (p[0].cpu(), p[1].cpu(), p[2]) for p in prob.nf_patterns_)
    loss_h, grad_h = GPProblem(**kw).make_loss(torch.from_numpy(X), torch.from_numpy(y), probes=probes,
                                               landmarks=landmarks, nf_patterns=pats)(raw)
    assert np.isfinite(float(loss_c))
    np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-3)
    np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=1e-2, atol=1e-3)


def _m12_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 6)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 3]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y, rng


def test_radius_nearfield_on_card_matches_cpu(dev):
    """The radius near-field's K and dK/dl products of a 2-D and a 1-D
    window on the card against the same calls on CPU float64 points."""
    from nfft4gp_torch.ops import fastsum as fs
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows

    X, _, rng = _m12_data(3000, 17)
    V = torch.from_numpy(rng.normal(size=(4, 3000)))
    outs = []
    for Xs, Vs in ((torch.from_numpy(X).to(dev), V.float().to(dev)), (torch.from_numpy(X).double(), V)):
        geom = fs.additive_fastsum_geometry(Xs, make_windows([[0, 1], [2]]), N=32)
        stens = fs.additive_nearfield_stencil_direct(geom, "matern12", 16)
        assert stens is not None
        plan = fs.additive_fastsum_coeffs("matern12", KernelParams.make(1.0, 0.5, 1.0, dtype=Xs.dtype,
                                                                        device=Xs.device), geom, nearfield_lfil=0)
        nf = fs._packed_layout(plan, stens).nf
        assert len(nf) == 2
        outs.append([sum(fs._nf_trip_apply_batch(False, e, Vs, w) for e in nf).cpu().double() for w in "kl"])
    for got, want in zip(*outs):
        assert _rel(got, want) <= 5e-5


def test_matern12_stream_step_on_card_matches_cpu(dev):
    """One matern12 loss step on the stream engine (radius near-field on the
    2-D and 1-D windows, KNN on the 3-feature one, float32 tables) on the
    card against CPU float64, with the same probes, landmarks and KNN
    pattern."""
    X, y, rng = _m12_data(3000, 19)
    kw = dict(kernel="matern12", windows=[[0, 1, 2], [3, 4], [5]], operator="fastsum", precond="nystrom",
              rank=30, maxits=8, nvecs=4, fastsum_N=32, fastsum_table_dtype="float32", fastsum_engine="stream")
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4, 3000)))
    landmarks = torch.from_numpy(rng.permutation(3000)[:30])
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 1.0], dtype=torch.float64))
    before = (pk.packed_adjoint.launches, pk.packed_forward.launches)
    card = GPProblem(**kw)
    loss_c, grad_c = card.make_loss(torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev), probes=probes,
                                    landmarks=landmarks)(raw.float().to(dev))
    assert pk.packed_adjoint.launches > before[0] and pk.packed_forward.launches > before[1]
    assert [s is not None for s in card.nf_stencils_] == [True, True, False]
    pats = tuple(None if p is None else (p[0].cpu(), p[1].cpu(), p[2]) for p in card.nf_patterns_)
    loss_h, grad_h = GPProblem(**kw).make_loss(torch.from_numpy(X).double(), torch.from_numpy(y).double(),
                                               probes=probes, landmarks=landmarks, nf_patterns=pats)(raw)
    assert np.isfinite(float(loss_c))
    np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-3)
    np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=1e-2, atol=1e-3)


def test_numpy_float64_fit_on_card(dev):
    """float64 numpy inputs with the default device: float32 on the card (as
    jnp.asarray gives them under JAX's default), the stream engine's
    kernels launched by fit and predict."""
    rng = np.random.default_rng(23)
    n = 2000
    X = rng.uniform(size=(n, 5))
    y = np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)
    prob = GPProblem(kernel="gaussian", windows=[[0, 1], [2, 3], [4]], operator="fastsum", precond="nystrom",
                     rank=30, maxits=8, nvecs=4, fastsum_N=32, predict_operator="dense")
    before = (pk.packed_adjoint.launches, pk.packed_forward.launches)
    prob.fit(X, y, adam_maxits=2)
    assert pk.packed_adjoint.launches > before[0] and pk.packed_forward.launches > before[1]
    assert prob.raw_params_.is_cuda and prob.raw_params_.dtype == torch.float32
    assert len(prob.loss_history_) == 2 and np.isfinite(prob.loss_history_).all()
    mean = prob.predict(X, y, X[:50])
    assert mean.is_cuda and mean.dtype == torch.float32 and bool(torch.isfinite(mean).all())


@pytest.mark.parametrize("op", ["fastsum", "dense"])
def test_predict_on_card_matches_cpu(dev, op):
    rng = np.random.default_rng(13)
    n = 3000
    X = rng.uniform(size=(n, 5)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    Xt = rng.uniform(size=(200, 5)).astype(np.float32)
    landmarks = torch.from_numpy(rng.permutation(n)[:30])
    out = []
    for device, dtype in ((dev, torch.float32), (torch.device("cpu"), torch.float64)):
        p = GPProblem(kernel="gaussian", windows=[[0, 1], [2, 3], [4]], operator="fastsum", rank=30, maxits=8,
                      predict_operator=op, raw_params_=transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1])))
        t = [torch.from_numpy(a).to(device, dtype) for a in (X, y, Xt)]
        mean = p.predict(*t, landmarks=landmarks)
        _, std = p.predict(t[0], t[1], t[2][:8], with_std=True, landmarks=landmarks)
        assert mean.device.type == device.type
        out.append((mean.cpu().double(), std.cpu().double()))
    assert _rel(out[0][0], out[1][0]) <= 1e-4
    assert _rel(out[0][1], out[1][1]) <= 1e-5


# --- the cooperative dense Krylov kernels ------------------------------------------

def _spd(dev, n, seed=0):
    """K = I + S, S symmetric Gaussian with spectrum about [-0.3, 0.3]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    R = torch.randn((n, n), generator=g, device=dev) * (0.15 / n ** 0.5)
    return (torch.eye(n, device=dev) + R + R.T).contiguous(), g


def test_grid_sync_probe(dev):
    blocks, total = _cuda_build.grid_sync_probe(dev)
    assert blocks >= 132 and total == blocks * (blocks + 1) // 2


@pytest.mark.parametrize("n", [1, 31, 33, 1000, fp.MAX_N])
@pytest.mark.parametrize("maxits", [1, 100])
def test_fused_pcg_matches_plain(dev, n, maxits):
    K, g = _spd(dev, n)
    b = torch.randn(n, generator=g, device=dev)
    before = fp.fused_pcg_dense.launches
    x, rr, it = fp.fused_pcg_dense(K, b, maxits=maxits, tol=1e-5)
    again = fp.fused_pcg_dense(K, b, maxits=maxits, tol=1e-5)
    torch.cuda.synchronize()
    assert fp.fused_pcg_dense.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip((x, rr, it), again))
    xp, rp, itp = fp.fused_pcg_dense_plain(K, b, maxits=maxits, tol=1e-5)
    assert x.dtype == torch.float32 and it.dtype == torch.int32
    assert abs(int(it) - int(itp)) <= 1
    assert float((x - xp).abs().max()) <= 1e-5 * float(xp.abs().max())
    if int(itp) < maxits:
        assert float(rr) <= 1e-5
    else:
        np.testing.assert_allclose(float(rr), float(rp), rtol=1e-3, atol=1e-6)


def test_fused_pcg_grid_kept_across_sizes(dev):
    """The launch grid is asked once per (kernel, n, card) and kept: a
    launch at the limit after a smaller one above 48 KB of shared memory
    still gets its opt-in, and each agrees with its plain version."""
    hits = _cuda_build._grid.cache_info().hits
    for n in (fp.MAX_N, 13000, fp.MAX_N):
        K, g = _spd(dev, n, seed=n)
        b = torch.randn(n, generator=g, device=dev)
        x, _, it = fp.fused_pcg_dense(K, b, maxits=5, tol=1e-12)
        xp, _, itp = fp.fused_pcg_dense_plain(K, b, maxits=5, tol=1e-12)
        assert int(it) == int(itp) == 5
        assert float((x - xp).abs().max()) <= 1e-5 * float(xp.abs().max())
    assert _cuda_build._grid.cache_info().hits >= hits + 1


@pytest.mark.parametrize("case", ["zero_rhs", "breakdown", "tol_ge_1", "float64_b"])
def test_fused_pcg_edges(dev, case):
    n = 300
    K, g = _spd(dev, n)
    b = torch.randn(n, generator=g, device=dev)
    kw = dict(maxits=50, tol=1e-5)
    if case == "zero_rhs":
        b = torch.zeros_like(b)
    elif case == "breakdown":
        K = torch.zeros_like(K)
    elif case == "tol_ge_1":
        kw["tol"] = 2.0
    else:
        b = b.double()
    x, rr, it = fp.fused_pcg_dense(K, b, **kw)
    xp, rp, itp = fp.fused_pcg_dense_plain(K, b, **kw)
    assert x.dtype == b.dtype
    if case == "float64_b":
        assert abs(int(it) - int(itp)) <= 1 and float((x - xp).abs().max()) <= 1e-5 * float(xp.abs().max())
        return
    expect = {"zero_rhs": (0, 0.0), "breakdown": (1, 1.0), "tol_ge_1": (0, 1.0)}[case]
    assert (int(it), float(rr)) == (int(itp), float(rp)) == expect
    assert not x.any()


def _lanczos_close(out, ref, exact_pad=False):
    a, b, V, b0 = out
    ap, bp, Vp, b0p = ref
    scale = float(ap.abs().max())
    assert float((a - ap).abs().max()) <= 1e-4 * scale
    if b.numel():
        assert float((b - bp).abs().max()) <= 1e-4 * scale
    np.testing.assert_allclose(b0.cpu().numpy(), b0p.cpu().numpy(), rtol=1e-6)
    nrm = float(torch.linalg.norm(Vp))
    assert float(torch.linalg.norm(V - Vp)) <= 1e-4 * max(nrm, 1e-30)


# maxits stays below n: past n steps the Krylov space is exhausted and the
# next direction is rounding noise (||w|| ~ sqrt(n) eps, above the eps break)
LANCZOS_CASES = [(n, nv, m) for n in (1, 31, 33, 1000)
                 for nv, m in ((1, 1), (1, 10), (10, 10), (fp.MAX_NV, 5))] + [(1000, 3, fp.MAX_ITS)]


@pytest.mark.parametrize("n,nv,maxits", LANCZOS_CASES)
def test_fused_lanczos_matches_plain(dev, n, nv, maxits):
    K, g = _spd(dev, n)
    Z = (torch.randint(0, 2, (nv, n), generator=g, device=dev) * 2 - 1).float()
    before = fp.fused_lanczos_dense.launches
    out = fp.fused_lanczos_dense(K, Z, maxits=maxits)
    again = fp.fused_lanczos_dense(K, Z, maxits=maxits)
    torch.cuda.synchronize()
    assert fp.fused_lanczos_dense.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    assert tuple(out[0].shape) == (nv, maxits) and tuple(out[1].shape) == (nv, maxits - 1)
    assert tuple(out[2].shape) == (nv, maxits + 1, n)
    _lanczos_close(out, fp.fused_lanczos_dense_plain(K, Z, maxits=maxits))


def test_fused_lanczos_at_limit(dev):
    n = fp.MAX_N
    K, g = _spd(dev, n)
    Z = (torch.randint(0, 2, (2, n), generator=g, device=dev) * 2 - 1).float()
    out = fp.fused_lanczos_dense(K, Z, maxits=3)
    _lanczos_close(out, fp.fused_lanczos_dense_plain(K, Z, maxits=3))


def test_fused_lanczos_breakdowns(dev):
    """Rank-3 K: three live steps, then alpha pads with 1, beta with 0, V
    with zero rows; a zero probe breaks at once; K = 0 breaks every probe
    at its first step and the launch leaves its loop."""
    n = 257
    g = torch.Generator(device=dev).manual_seed(3)
    U, _ = torch.linalg.qr(torch.randn((n, 3), generator=g, device=dev))
    K = ((U * torch.tensor([1e-2, 5e-3, 2e-3], device=dev)) @ U.T).contiguous()
    Z = (torch.randint(0, 2, (3, n), generator=g, device=dev) * 2 - 1).float()
    Z[2] = 0.0
    a, b, V, b0 = out = fp.fused_lanczos_dense(K, Z, maxits=8)
    torch.cuda.synchronize()
    assert bool((a[:2, 3:] == 1).all()) and not b[:2, 2:].any() and not V[:2, 4:].any()
    assert bool((a[2] == 1).all()) and not b[2].any() and not V[2].any() and float(b0[2]) == 0.0
    _lanczos_close(out, fp.fused_lanczos_dense_plain(K, Z, maxits=8))
    a, b, V, _ = fp.fused_lanczos_dense(torch.zeros_like(K), Z, maxits=8)
    assert bool((a == 1).all()) and not b.any() and not V[:, 1:].any()


def test_fused_wrappers_refuse(dev):
    K, _ = _spd(dev, 64)
    before = (fp.fused_pcg_dense.launches, fp.fused_lanczos_dense.launches)
    big = torch.empty((fp.MAX_N + 1, fp.MAX_N + 1), device=dev)
    with pytest.raises(ValueError):
        fp.fused_pcg_dense(big, torch.ones(fp.MAX_N + 1, device=dev))
    with pytest.raises(ValueError):
        fp.fused_pcg_dense(K, torch.ones(64))                          # b on the CPU
    with pytest.raises(ValueError):
        fp.fused_lanczos_dense(K, torch.ones((fp.MAX_NV + 1, 64), device=dev))
    with pytest.raises(ValueError):
        fp.fused_lanczos_dense(K, torch.ones((2, 64), device=dev), maxits=fp.MAX_ITS + 1)
    assert (fp.fused_pcg_dense.launches, fp.fused_lanczos_dense.launches) == before


def _cg_check(K, b, maxits, plan=None):
    """The CG kernel (under `plan`, else the card's own) against the plain CG,
    with test_fused_pcg_matches_plain's limits and a bitwise second launch."""
    run = (lambda: fp.fused_pcg_dense(K, b, maxits=maxits, tol=1e-5)) if plan is None else (
        lambda: _cuda_build.fused_pcg(K, b, maxits, 1e-5, plan=plan))
    x, rr, it = run()
    again = run()
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip((x, rr, it), again))
    xp, rp, itp = fp.fused_pcg_dense_plain(K, b, maxits=maxits, tol=1e-5)
    assert abs(int(it) - int(itp)) <= 1
    assert float((x - xp).abs().max()) <= 1e-5 * float(xp.abs().max())
    if int(itp) < maxits:
        assert float(rr) <= 1e-5
    else:
        np.testing.assert_allclose(float(rr), float(rp), rtol=1e-3, atol=1e-6)


def _capacity(kind, dev, nv=1, maxits=10):
    """The largest n whose plan keeps all of K resident on this card."""
    sms, smem = _cuda_build.device_limits(dev)
    plan = (lambda n: fp.cg_plan(n, sms, smem)) if kind == "pcg" else (
        lambda n: fp.lanczos_plan(n, nv, sms, smem, maxits))
    n = 1
    while plan(n + 1).streamed_bytes == 0:
        n += 1
    return n


@pytest.mark.parametrize("where", ["1", "31", "capacity", "capacity+1", "4096", "max"])
def test_fused_pcg_plan_shapes(dev, where):
    """CG around the card's resident capacity (all rows of K in shared
    memory; one row past it streams), n = 4096 (partly streamed), the
    n = 16384 limit (all streamed) and n below the SM count."""
    n = {"1": 1, "31": 31, "4096": 4096, "max": fp.MAX_N}.get(where) or (
        _capacity("pcg", dev) + (1 if where == "capacity+1" else 0))
    plan = _cuda_build._grid("pcg", n, dev)[0]
    assert (plan.streamed_bytes > 0) == (where in ("capacity+1", "4096", "max"))
    K, g = _spd(dev, n, seed=n)
    b = torch.randn(n, generator=g, device=dev)
    _cg_check(K, b, 30 if n == fp.MAX_N else 100)


@pytest.mark.parametrize("where", ["1", "31", "capacity", "capacity+1", "4096", "max"])
def test_fused_lanczos_plan_shapes(dev, where):
    """Lanczos at nv = 16, maxits = 64 around the resident capacity of K's
    column panels and at n = 4096 (part of every panel streamed), at the
    limit, and below the SM count at nv = 16 with maxits well below n (as
    LANCZOS_CASES: near n steps the next direction is rounding noise)."""
    n = {"1": 1, "31": 31, "4096": 4096, "max": fp.MAX_N}.get(where) or (
        _capacity("lanczos", dev, fp.MAX_NV, fp.MAX_ITS) + (1 if where == "capacity+1" else 0))
    nv, maxits = fp.MAX_NV, fp.MAX_ITS if n > 1000 else min(10, max(1, n - 1))
    if n == fp.MAX_N:
        nv, maxits = 2, 3
    plan = _cuda_build._grid("lanczos", n, dev, nv, maxits)[0]
    assert (plan.streamed_bytes > 0) == (where in ("capacity+1", "4096", "max"))
    K, g = _spd(dev, n, seed=n)
    Z = (torch.randint(0, 2, (nv, n), generator=g, device=dev) * 2 - 1).float()
    out = fp.fused_lanczos_dense(K, Z, maxits=maxits)
    again = fp.fused_lanczos_dense(K, Z, maxits=maxits)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    _lanczos_close(out, fp.fused_lanczos_dense_plain(K, Z, maxits=maxits))


def test_fused_plans_forced_to_stream(dev):
    """Hand-made plans the card's own would not choose: every row of K (CG)
    and every chunk of every panel (Lanczos) streamed through two stages,
    blocks of several panels, their own columns of w and V in shared and
    in global memory; the results are the plain versions'."""
    sms, smem = _cuda_build.device_limits(dev)
    n = 1000
    K, g = _spd(dev, n, seed=5)
    b = torch.randn(n, generator=g, device=dev)
    own = fp.cg_plan(n, sms, smem)
    plan = dataclasses.replace(own, resident=(0,) * own.blocks, stages=2,
                               smem=fp.SMEM_SLACK + fp.CG_FIXED + 4 * fp._ld(n) * (1 + 2))
    _cg_check(K, b, 100, plan)
    Z = (torch.randint(0, 2, (10, n), generator=g, device=dev) * 2 - 1).float()
    for own in (True, False):  # the blocks' own columns of w and V in shared or global memory
        lz = fp.lanczos_plan(n, 10, 7, smem)  # seven blocks of several panels
        lz = dataclasses.replace(lz, resident=(0,) * lz.blocks, stages=2, own=own, smem=0)
        lz = dataclasses.replace(lz, smem=fp.SMEM_SLACK + fp.LZ_FIXED + lz.own_bytes + 2 * lz.stage_bytes)
        assert lz.blocks == 7 and max(lz.pstarts[b + 1] - lz.pstarts[b] for b in range(7)) > 1
        out = _cuda_build.fused_lanczos(K, Z, 10, plan=lz)
        _lanczos_close(out, fp.fused_lanczos_dense_plain(K, Z, maxits=10))


def test_fused_entry_points_refuse_inconsistent_plans(dev):
    """The C entry points refuse a plan that leaves a row or panel out,
    covers one twice, leaves a block without work, keeps more resident than
    a block owns, asks for less shared memory than its layout needs, or runs
    more blocks than SMs -- and launch nothing."""
    sms, smem = _cuda_build.device_limits(dev)
    n = 1000
    K, g = _spd(dev, n)
    b = torch.randn(n, generator=g, device=dev)
    Z = torch.ones((4, n), device=dev)
    cg, lz = fp.dense_plan(n, 4, sms, smem)
    s = list(cg.starts)
    bad_cg = [dataclasses.replace(cg, starts=tuple(s[:-1] + [n - 1])),            # a row left out
              dataclasses.replace(cg, starts=tuple([0, 0] + s[2:])),               # a block without rows
              dataclasses.replace(cg, resident=(cg.resident[0] + 1,) + cg.resident[1:]),
              dataclasses.replace(cg, smem=cg.smem - 16),
              fp.cg_plan(n, sms + 1, smem)]                                        # more blocks than SMs
    for plan in bad_cg:
        with pytest.raises(RuntimeError, match="fused_pcg"):
            _cuda_build.fused_pcg(K, b, 10, 1e-5, plan=plan)
    p = list(lz.pstarts)
    bad_lz = [dataclasses.replace(lz, pstarts=tuple(p[:-1] + [p[-1] + 1])),       # a panel past n
              dataclasses.replace(lz, pstarts=tuple([0, 0] + p[2:])),
              dataclasses.replace(lz, resident=(lz.chunks + 1,) + lz.resident[1:]),
              dataclasses.replace(lz, chunk_rows=lz.chunk_rows + 1),                # not whole row groups
              dataclasses.replace(lz, stages=1),                                   # no ring
              dataclasses.replace(lz, smem=lz.smem - 16),
              fp.lanczos_plan(n, 4, 2 * sms, smem)]                                  # 250 blocks
    for plan in bad_lz:
        with pytest.raises(RuntimeError, match="fused_lanczos"):
            _cuda_build.fused_lanczos(K, Z, lz.maxits, plan=plan)


def test_fused_constants_match_the_plans(dev):
    c = _cuda_build.fused_constants()
    assert c == {"MAX_BLOCKS": fp.MAX_BLOCKS, "SMEM_SLACK": fp.SMEM_SLACK, "CG_CONS": fp.CG_CONS,
                 "CG_FIXED": fp.CG_FIXED, "LZ_CONS": fp.LZ_CONS, "LZ_FIXED": fp.LZ_FIXED,
                 "LZ_MAX_C": fp.LZ_WIDTHS[-1], "MAX_STAGES": fp.MAX_STAGES}
    assert fp.LZ_STAGES <= fp.LZ_MAX_STAGES <= fp.MAX_STAGES


@pytest.mark.parametrize("kind", [0, 1], ids=["grid_sync", "counter"])
def test_timed_barrier_probe(dev, kind):
    """The timed barrier probe: one block an SM (its shared memory keeps a
    second off), a positive time a barrier, and the barrier held (block 0
    reads every block's index + 1, written before the last barrier)."""
    sms, _ = _cuda_build.device_limits(dev)
    us, blocks, per_sm = _cuda_build.barrier_us(dev, kind, iters=50, reps=3)
    assert blocks == sms and per_sm == 1 and us > 0
    blocks, _, total = _cuda_build.barrier_probe(dev, kind, iters=3)
    assert total == blocks * (blocks + 1) // 2


@pytest.mark.parametrize("kind", [0, 1], ids=["grid_sync", "counter"])
def test_timed_barrier_probe_at_a_plans_grid(dev, kind):
    """The probe at the grid and shared memory of the card's Lanczos plan at
    n = 4096 (fewer blocks than SMs) and at one block; more blocks than
    SMs are refused."""
    sms, smem = _cuda_build.device_limits(dev)
    lz = fp.lanczos_plan(4096, 10, sms, smem)
    us, blocks, per_sm = _cuda_build.barrier_us(dev, kind, iters=50, reps=3, threads=fp.LZ_CONS + 32,
                                                smem=lz.smem, blocks=lz.blocks)
    assert blocks == lz.blocks <= sms and per_sm == 1 and us > 0
    for g in (1, lz.blocks):
        assert _cuda_build.barrier_probe(dev, kind, iters=3, blocks=g)[2] == g * (g + 1) // 2
    with pytest.raises(RuntimeError, match="barrier_probe"):
        _cuda_build.barrier_probe(dev, kind, iters=1, blocks=sms + 1)


def test_dense_chol_step_on_card_matches_cpu(dev):
    rng = np.random.default_rng(5)
    n = 400
    X = rng.uniform(size=(n, 5)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + np.cos(2 * X[:, 2]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    kw = dict(kernel="gaussian", windows=[[0, 1], [2, 3], [4]], operator="dense", precond="chol",
              maxits=8, nvecs=4)
    probes = torch.from_numpy(rng.choice([-1.0, 1.0], size=(4, n)).astype(np.float32))
    raw = transform_inverse("softplus", torch.tensor([1.0, 0.5, 0.1]))

    def step(device):
        return GPProblem(**kw).make_loss(torch.from_numpy(X).to(device), torch.from_numpy(y).to(device),
                                         probes=probes)(raw.to(device))

    loss_c, grad_c = step(dev)
    loss_h, grad_h = step(torch.device("cpu"))
    assert np.isfinite(float(loss_c))
    np.testing.assert_allclose(float(loss_c), float(loss_h), rtol=1e-4)
    np.testing.assert_allclose(grad_c.cpu().numpy(), grad_h.numpy(), rtol=1e-3, atol=1e-4)


def test_multiclass_on_card_matches_cpu(dev):
    rng = np.random.default_rng(91)
    n, C = 200, 4
    labels = rng.integers(0, C, size=n)
    X = torch.from_numpy(rng.normal(size=(C, 3))[labels] + 0.4 * rng.normal(size=(n, 3)))
    Ys = torch.from_numpy(np.eye(C)[labels] * 2.0 - 1.0)
    mu2 = torch.from_numpy(0.01 + 0.02 * rng.uniform(size=(n, C)))
    raw = torch.from_numpy(np.linspace(0.2, 0.8, 3 * C))
    X2 = torch.from_numpy(rng.normal(size=(50, 3)))
    got = mc.exact_class_gp_loss(*(t.to(dev) for t in (raw, X, Ys, mu2)))
    want = mc.exact_class_gp_loss(raw, X, Ys, mu2)
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=1e-10)
    np.testing.assert_allclose(got.grad.cpu().numpy(), want.grad.numpy(), rtol=1e-10, atol=1e-13)
    pg = mc.exact_class_gp_predict(*(t.to(dev) for t in (raw, X, Ys, mu2, X2)), with_std=True)
    pw = mc.exact_class_gp_predict(raw, X, Ys, mu2, X2, with_std=True)
    assert torch.equal(pg.labels.cpu(), pw.labels)
    np.testing.assert_allclose(pg.means.cpu().numpy(), pw.means.numpy(), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(pg.std.cpu().numpy(), pw.std.numpy(), rtol=1e-10, atol=1e-13)


def _afn_fsai(which, X, Z, dtype, device, plan_or_pattern):
    from nfft4gp_torch.ops.kernels import KernelParams, make_windows
    from nfft4gp_torch.preconds import afn as ta
    from nfft4gp_torch.preconds import fsai as tf

    Xs = torch.from_numpy(X).to(device=device, dtype=dtype)
    Zs = torch.from_numpy(Z).to(device=device, dtype=dtype)
    p = KernelParams.make(1.0, 0.3, 0.1, dtype=dtype, device=device)
    W = make_windows([[0, 1], [2, 3]])
    if which == "afn":
        plan = plan_or_pattern
        plan = plan._replace(perm=plan.perm.to(device), pattern=tuple(t.to(device) for t in plan.pattern),
                             pattern_t=tuple(t.to(device) for t in plan.pattern_t))
        pre = ta.afn_setup_from_plan("gaussian", p, Xs, plan, require_grad=True, windows=W)
        factors = [pre.L11, pre.gs.val, pre.gs.dval]
    else:
        pre = tf.fsai_setup("gaussian", p, Xs, 16, require_grad=True, windows=W,
                            pattern=tuple(t.to(device) for t in plan_or_pattern))
        factors = [pre.val, pre.dval]
    return [t.cpu().double() for t in factors + [pre.solve(Zs), pre.dvp(Zs), pre.logdet().reshape(1),
                                                 pre.trace()]]


@pytest.mark.parametrize("which", ["afn", "fsai"])
def test_afn_fsai_on_card_match_cpu(dev, which):
    """Set-up, solve and dvp of AFN and FSAI at n = 4096 on CUDA tensors
    (float32) against CPU float64, the same plan or pattern on both."""
    from nfft4gp_torch.ops.kernels import KernelParams
    from nfft4gp_torch.ops.knn import knn_pattern
    from nfft4gp_torch.preconds.afn import afn_plan

    rng = np.random.default_rng(41)
    n = 4096
    X = rng.uniform(size=(n, 4))
    Z = rng.choice([-1.0, 1.0], size=(4, n))
    if which == "afn":
        shared = afn_plan("gaussian", KernelParams.make(1.0, 0.3, 0.1, dtype=torch.float64), torch.from_numpy(X),
                          maxrank=200, lfil=16, rank=200, force_afn=True)
    else:
        shared = knn_pattern(torch.from_numpy(X), 16)
    card = _afn_fsai(which, X, Z, torch.float32, dev, shared)
    host = _afn_fsai(which, X, Z, torch.float64, torch.device("cpu"), shared)
    limit = 5e-3 if which == "afn" else 2e-4
    for got, want in zip(card, host):
        assert torch.isfinite(got).all()
        assert _rel(got, want) <= limit


def test_fsai_breakdown_repair_on_card(dev):
    """Singular and indefinite row blocks: cholesky_ex on the card flags and
    repairs the same rows as on the CPU, with the same values."""
    from nfft4gp_torch.preconds.fsai import fsai_rows_from_blocks

    rng = np.random.default_rng(3)
    n, lfil = 12, 5
    A = rng.normal(size=(n, lfil, lfil))
    blocks = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(lfil)
    blocks[4] = np.ones((lfil, lfil))
    blocks[7] = -np.eye(lfil)
    mask = np.ones((n, lfil), bool)
    dblocks = rng.normal(size=(n, 3, lfil, lfil))
    dblocks = 0.5 * (dblocks + np.swapaxes(dblocks, 2, 3))
    args = [torch.from_numpy(a) for a in (blocks, dblocks, mask)]
    want = fsai_rows_from_blocks(*args)
    got = fsai_rows_from_blocks(*[a.to(dev) for a in args])
    assert int(got[2]) == int(want[2]) == 2
    for g, w in zip(got[:2], want[:2]):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0, atol=1e-12 * float(w.abs().max()))


def test_f32_table_kernels_at_afn_pcg_shape(dev):
    """The float32-table adjoint and forward at chip_smoke's [afn-pcg]
    shape against their plain versions; second launches bitwise equal."""
    n, P = 100_000, 16
    Tp, rng = _table(dev, n, P, torch.float32)
    pairs, singles = ((0, 1),), ()
    alpha = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).to(dev)
    A2 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)[0]
    again = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)[0]
    assert torch.equal(A2[0], again[0])
    W2, _ = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    assert _rel(A2[0], W2[:, 0]) <= 1e-4
    G2 = [torch.from_numpy(rng.normal(size=(1, 2 * P, 2 * P)).astype(np.float32)).to(dev)]
    y = pk.packed_forward(Tp, G2, pairs=pairs, singles=singles)[0]
    assert torch.equal(y, pk.packed_forward(Tp, G2, pairs=pairs, singles=singles)[0])
    want = pk.packed_forward_plain(Tp, torch.stack(G2, 1), None, pairs, singles)[0]
    assert _rel(y, want) <= 1e-4


# --- the float32-table kernels at 2P = 16, 32 (csrc/packed_ndft.cu) ---------------------------------

F32_NS = [1, 63, 64, 65, 4099, 20000]


def _f32_pair(dev, n, P, nv, nsets, layout="mixed", seed=0):
    """A float32 table of pack_phase_table, alpha (nv, n) and weight stacks
    G2 (nsets, npairs, 2P, 2P), G1 (nsets, nsingles, 2P) from one seed."""
    pairs, singles = LAYOUTS[layout]
    Tp, rng = _table(dev, n, P, torch.float32, seed)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    G2 = torch.from_numpy(rng.normal(size=(nsets, len(pairs), 2 * P, 2 * P)).astype(np.float32)).to(dev)
    G1 = torch.from_numpy(rng.normal(size=(nsets, len(singles), 2 * P)).astype(np.float32)).to(dev)
    return Tp, alpha, G2, G1, pairs, singles


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", F32_NS)
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("nv", [1, 2, 10])
def test_f32_adjoint_kernel(dev, layout, n, P, nv):
    """The float32-table adjoint (its launcher called directly, whatever
    the route picks) at ragged n around its 128- and 256-point stages, every
    right-hand-side group (1, 2, 4 a block): against the plain version, a
    second launch bitwise equal."""
    Tp, alpha, _, _, pairs, singles = _f32_pair(dev, n, P, nv, 1, layout)
    got = [torch.cat([a.reshape(-1) for a in _cuda_build.adjoint(Tp, alpha, pairs, singles)]) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    W2, W1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    assert _rel(got[0], torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", F32_NS)
@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("nsets", [1, 2, 17, 32])
def test_f32_forward_kernel(dev, layout, n, P, nsets):
    """The float32-table forward (its launcher called directly, whatever
    the route picks) at ragged n, one pass and several (at most 16 weight
    sets a pass at 2P = 16, one at 32): against the plain version, a second
    launch bitwise equal."""
    Tp, _, G2, G1, pairs, singles = _f32_pair(dev, n, P, 1, nsets, layout)
    ys = [_cuda_build.forward(Tp, G2, G1, pairs, singles) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ys[0], ys[1]) and tuple(ys[0].shape) == (nsets, n)
    want = pk.packed_forward_plain(Tp, G2 if pairs else None, G1 if singles else None, pairs, singles)
    assert _rel(ys[0], want) <= KERNEL_RTOL


@pytest.mark.parametrize("W2", [16, 32])
def test_f32_library_limits(dev, W2):
    """The forward's limits in C (sets a pass, points a block), which the
    launcher reads, are those the CPU planner tests take: 16 sets at 2P =
    16 and one at 32 (several go to the wide pair), whole stages a block;
    the chunk the planner gives at them stays within the block."""
    lib = _cuda_build.library("packed_ndft")
    sets, cap = lib.forward_max_sets(W2), lib.forward_max_chunk(W2)
    assert (sets, cap) == {16: (16, 1024), 32: (1, 2048)}[W2] and cap % _cuda_build.f32_stage_points(W2) == 0
    assert _cuda_build.f32_forward_chunk(W2, 10 ** 6, _cuda_build._sm_count(dev), cap) <= cap


@pytest.mark.parametrize("case", ["stride", "pointer"])
@pytest.mark.parametrize("n", [63, 4099])
def test_f32_unaligned_tables(dev, case, n):
    """The TMA copies read 16-byte rows: a table whose row stride is not a
    multiple of 4 floats ("stride": a contiguous table at odd n), or whose
    rows start off 16 bytes ("pointer"), reaches the kernels through the
    wrappers' padded copy, with the plain version's results; the C entry
    points refuse it (cudaErrorInvalidValue, 1)."""
    Tp, alpha, G2, G1, pairs, singles = _f32_pair(dev, n, 16, 2, 3)
    if case == "stride":
        Tp = Tp.contiguous()
        assert Tp.stride(1) % 4 != 0
    else:
        store = torch.zeros((Tp.shape[0], 32, 4 * (-(-(n + 1) // 4) + 1)), device=dev)
        store[:, :, 1:n + 1] = Tp
        Tp = store[:, :, 1:n + 1]
        assert Tp.data_ptr() % 16 != 0 and Tp.stride(1) % 4 == 0
    A2, A1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
    W2, W1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    assert _rel(torch.cat([torch.stack(A2, 1).reshape(-1), torch.stack(A1, 1).reshape(-1)]),
                torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL
    ys = torch.stack(pk.packed_forward(Tp, list(torch.unbind(G2, 1)), list(torch.unbind(G1, 1)), pairs=pairs,
                                       singles=singles))
    assert _rel(ys, pk.packed_forward_plain(Tp, G2, G1, pairs, singles)) <= KERNEL_RTOL
    lib = _cuda_build.library("packed_ndft")
    pr, sg = _cuda_build._ints(v for p in pairs for v in p), _cuda_build._ints(singles)
    part, out, y = (torch.empty(k, device=dev) for k in (10 ** 6, 10 ** 5, (3, n)))
    code = lib.adjoint_launch(Tp.data_ptr(), Tp.stride(1), alpha.data_ptr(), 32, n, 2, pr, len(pairs), sg,
                              len(singles), 2, part.data_ptr(), 1, 4096 * -(-n // 4096), out.data_ptr(),
                              _cuda_build._stream(alpha))
    assert code == 1
    code = lib.forward_launch(Tp.data_ptr(), Tp.stride(1), 32, n, pr, len(pairs), G2.data_ptr(), sg, len(singles),
                              G1.data_ptr(), 3, 128, y.data_ptr(), _cuda_build._stream(y))
    assert code == 1
    with pytest.raises(RuntimeError, match="packed_forward launch failed"):
        _cuda_build._check(lib, code, "packed_forward")


def test_f32_forward_refuses_unaligned_weights(dev):
    """The forward copies the weights in 16-byte pieces: its C entry point
    refuses G2 off 16 bytes; the wrappers' stacks are aligned (a clone)."""
    n = 997
    Tp, _, G2, G1, pairs, singles = _f32_pair(dev, n, 16, 1, 2)
    off = torch.empty(G2.numel() + 1, device=dev)[1:].view(G2.shape)
    off.copy_(G2)
    lib = _cuda_build.library("packed_ndft")
    y = torch.empty((2, n), device=dev)
    code = lib.forward_launch(Tp.data_ptr(), Tp.stride(1), 32, n, _cuda_build._ints(v for p in pairs for v in p),
                              len(pairs), off.data_ptr(), _cuda_build._ints(singles), len(singles), G1.data_ptr(), 2,
                              128, y.data_ptr(), _cuda_build._stream(y))
    assert code == 1
    G2c, _ = pk._dense_stacks(off, G1, 32, dev)
    assert G2c.data_ptr() % 16 == 0 and torch.equal(G2c, G2)


@pytest.mark.parametrize("P", [8, 16])
@pytest.mark.parametrize("op", ["adjoint", "forward"])
def test_f32_route_at_its_cut_over(dev, P, op):
    """Through the wrappers, a float32 table at its width's cut-over count
    (nv or nsets = F32_MAX_NV / F32_MAX_NSETS) launches csrc/packed_ndft.cu
    (packed_adjoint / packed_forward counted by shape) and one more takes
    the wide pair (counted by "2P=.. nv=.."); at a width without a cut-over,
    20 still launches csrc/packed_ndft.cu; each against the plain versions."""
    name = "nv" if op == "adjoint" else "nsets"
    cut = (pk.F32_MAX_NV if op == "adjoint" else pk.F32_MAX_NSETS)[2 * P]
    narrow = pk.packed_adjoint if op == "adjoint" else pk.packed_forward
    wide = pk.WIDE_ADJOINT if op == "adjoint" else pk.WIDE_FORWARD
    sides = ([(20, narrow, f"{name}=20")] if cut is None else
             [(cut, narrow, f"{name}={cut}"), (cut + 1, wide, f"2P={2 * P} {name}={cut + 1}")])
    for count, counter, key in sides:
        assert pk.table_route(2 * P, torch.float32, op, count) == ("f32" if counter is narrow else "wide")
        Tp, alpha, G2, G1, pairs, singles = _f32_pair(dev, 4099, P, count, count)
        before = counter.launches_by_shape.get(key, 0)
        if op == "adjoint":
            A2, A1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
            W2, W1 = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
            err = _rel(torch.cat([torch.stack(A2, 1).reshape(-1), torch.stack(A1, 1).reshape(-1)]),
                       torch.cat([W2.reshape(-1), W1.reshape(-1)]))
        else:
            ys = torch.stack(pk.packed_forward(Tp, list(torch.unbind(G2, 1)), list(torch.unbind(G1, 1)),
                                               pairs=pairs, singles=singles))
            err = _rel(ys, pk.packed_forward_plain(Tp, G2, G1, pairs, singles))
        assert counter.launches_by_shape[key] == before + 1 and err <= KERNEL_RTOL


@pytest.mark.parametrize("P", [8, 16])
def test_f32_many_windows(dev, P):
    """33 pairs and 65 singles in one call on the float32-table kernels (nv
    and nsets 1): two launches each, outputs against the plain versions, a
    second call bitwise equal."""
    n = 4099
    rng = np.random.default_rng(P)
    x = torch.from_numpy(rng.uniform(-0.25, 0.25, size=(66, n)).astype(np.float32)).to(dev)
    Tp = pk.pack_phase_table(x, P, table_dtype=torch.float32)
    alpha = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).to(dev)
    G2 = [torch.from_numpy(rng.normal(size=(1, 2 * P, 2 * P)).astype(np.float32)).to(dev) for _ in MANY_PAIRS]
    G1 = [torch.from_numpy(rng.normal(size=(1, 2 * P)).astype(np.float32)).to(dev) for _ in MANY_SINGLES]
    before = (pk.packed_adjoint.launches, pk.packed_forward.launches)
    runs = [_flat(*pk.packed_adjoint(Tp, alpha, pairs=MANY_PAIRS, singles=MANY_SINGLES), alpha) for _ in range(2)]
    ys = [torch.stack(pk.packed_forward(Tp, G2, G1, pairs=MANY_PAIRS, singles=MANY_SINGLES)) for _ in range(2)]
    torch.cuda.synchronize()
    assert (pk.packed_adjoint.launches, pk.packed_forward.launches) == (before[0] + 4, before[1] + 4)
    assert torch.equal(runs[0], runs[1]) and torch.equal(ys[0], ys[1])
    W2, W1 = pk.packed_adjoint_plain(Tp, alpha, MANY_PAIRS, MANY_SINGLES)
    assert _rel(runs[0], torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL
    want = pk.packed_forward_plain(Tp, torch.stack(G2, 1), torch.stack(G1, 1), MANY_PAIRS, MANY_SINGLES)
    assert _rel(ys[0], want) <= KERNEL_RTOL


# --- the wide pair (csrc/packed_ndft_wide.cu): every even 2P the narrow kernels lack ---------

WIDE_WIDTHS = [2, 8, 48, 64, 130, 256, 258, 600, 1026]
WIDE_SOURCES = ["f32", "bf16", "doubling", "direct"]
# the regenerating sources against float64: a float32 coordinate's phase
# 2 pi p x is off by about p |x| 2^-22 (3e-5 at p = 512), in the kernel's
# phases and in those of a float32 plain version alike
WIDE_RTOL = {"f32": KERNEL_RTOL, "bf16": KERNEL_RTOL, "doubling": 1e-4, "direct": 1e-4}


def _wide_src(dev, n, W2, source, seed=0):
    """(phase source, P, "table" or the phase_gen, rng): a float32 or bf16
    table of pack_phase_table, or float32 coordinates."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.uniform(-0.25, 0.25, size=(5, n)).astype(np.float32)).to(dev)
    P = W2 // 2
    if source in ("f32", "bf16"):
        return pk.pack_phase_table(x, P, table_dtype=torch.float32 if source == "f32" else torch.bfloat16), P, \
            "table", rng
    return x, P, source, rng


def _wide_adjoint(src, alpha, pairs, singles, source, P):
    """The wrapper of the source at a width only the wide pair serves."""
    if source == "table":
        return pk.packed_adjoint(src, alpha, pairs=pairs, singles=singles)
    return pk.packed_adjoint_regen(src, alpha, P=P, pairs=pairs, singles=singles, phase_gen=source)


def _wide_forward(src, G2, G1, pairs, singles, source, P):
    if source == "table":
        return pk.packed_forward(src, G2, G1, pairs=pairs, singles=singles)
    return pk.packed_forward_regen(src, G2, G1, P=P, pairs=pairs, singles=singles, phase_gen=source)


def _wide_adjoint_want(src, alpha, P, pairs, singles, source):
    if source == "table":
        return pk.packed_adjoint_plain(src, alpha, pairs, singles)
    return pk.packed_adjoint_regen_plain(src.double(), alpha.double(), P, pairs, singles, source)


def _wide_forward_want(src, G2, G1, P, pairs, singles, source):
    G2s = torch.stack(G2, 1) if pairs else None
    G1s = torch.stack(G1, 1) if singles else None
    if source == "table":
        return pk.packed_forward_plain(src, G2s, G1s, pairs, singles)
    return pk.packed_forward_regen_plain(src.double(), None if G2s is None else G2s.double(),
                                         None if G1s is None else G1s.double(), P, pairs, singles, source)


def _flat(A2, A1, like):
    return torch.cat([torch.stack(A2, 1).reshape(-1) if A2 else like.new_zeros(0),
                      torch.stack(A1, 1).reshape(-1) if A1 else like.new_zeros(0)])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("W2", WIDE_WIDTHS)
@pytest.mark.parametrize("source", WIDE_SOURCES)
@pytest.mark.parametrize("nv", [1, 3, 10, 17])
def test_wide_adjoint_matches_plain(dev, layout, W2, source, nv):
    """The wide adjoint at every width class (below, between, at and above
    the 64 x 64 output tile; 2P = 8k + 2 regenerating widths; the 1026
    limit), every phase source, only 2-D, only 1-D and both window kinds,
    nv across the flattened M tiles, n = 997 (no multiple of the 32-point
    step or a chunk); a second launch bitwise equal, both counted."""
    pairs, singles = LAYOUTS[layout]
    n = 997
    src, P, name, rng = _wide_src(dev, n, W2, source)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    key = f"2P={W2} nv={nv}"
    before = pk.WIDE_ADJOINT.launches_by_shape.get(key, 0)
    runs = [_wide_adjoint(src, alpha, pairs, singles, name, P) for _ in range(2)]
    torch.cuda.synchronize()
    assert pk.WIDE_ADJOINT.launches_by_shape[key] == before + 2
    got, again = (_flat(A2, A1, alpha) for A2, A1 in runs)
    assert torch.equal(got, again)
    W2w, W1w = _wide_adjoint_want(src, alpha, P, pairs, singles, name)
    assert _rel(got, torch.cat([W2w.reshape(-1), W1w.reshape(-1)])) <= WIDE_RTOL[source]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("W2", WIDE_WIDTHS)
@pytest.mark.parametrize("source", WIDE_SOURCES)
@pytest.mark.parametrize("nsets", [1, 2, 20, 33])
def test_wide_forward_matches_plain(dev, layout, W2, source, nsets):
    """The wide forward as the adjoint above, nsets within one 32-set block
    and past it (two set blocks at 33); a second launch bitwise equal."""
    pairs, singles = LAYOUTS[layout]
    n = 997
    src, P, name, rng = _wide_src(dev, n, W2, source)

    def weights(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    G2 = [weights(nsets, W2, W2) for _ in pairs]
    G1 = [weights(nsets, W2) for _ in singles]
    key = f"2P={W2} nsets={nsets}"
    before = pk.WIDE_FORWARD.launches_by_shape.get(key, 0)
    ys, again = (torch.stack(_wide_forward(src, G2, G1, pairs, singles, name, P)) for _ in range(2))
    torch.cuda.synchronize()
    assert pk.WIDE_FORWARD.launches_by_shape[key] == before + 2
    assert torch.equal(ys, again) and tuple(ys.shape) == (nsets, n)
    assert _rel(ys, _wide_forward_want(src, G2, G1, P, pairs, singles, name)) <= WIDE_RTOL[source]


@pytest.mark.parametrize("n", [1, 31, 129, 4099, 20001])
@pytest.mark.parametrize("W2", [130, 256])
@pytest.mark.parametrize("source", WIDE_SOURCES)
def test_wide_ragged_n(dev, n, W2, source):
    """Ragged point counts (one point, below one 32-point step, one past a
    128-point forward block, several adjoint chunks), mixed windows."""
    pairs, singles = LAYOUTS["mixed"]
    src, P, name, rng = _wide_src(dev, n, W2, source, seed=n)
    alpha = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    A2, A1 = _wide_adjoint(src, alpha, pairs, singles, name, P)
    W2w, W1w = _wide_adjoint_want(src, alpha, P, pairs, singles, name)
    assert _rel(_flat(A2, A1, alpha), torch.cat([W2w.reshape(-1), W1w.reshape(-1)])) <= WIDE_RTOL[source]
    G2 = [torch.from_numpy(rng.normal(size=(3, W2, W2)).astype(np.float32)).to(dev) for _ in pairs]
    G1 = [torch.from_numpy(rng.normal(size=(3, W2)).astype(np.float32)).to(dev) for _ in singles]
    ys = torch.stack(_wide_forward(src, G2, G1, pairs, singles, name, P))
    assert _rel(ys, _wide_forward_want(src, G2, G1, P, pairs, singles, name)) <= WIDE_RTOL[source]


@pytest.mark.parametrize("W2", [64, 130])
def test_wide_bf16_table_unpadded_stride(dev, W2):
    """A contiguous bf16 table whose row stride is n (no 64-point padding,
    rows off 16-byte boundaries): the wide kernels read it in place."""
    n = 997
    Tp, P, _, rng = _wide_src(dev, n, W2, "bf16")
    Tp = Tp.contiguous()
    assert Tp.stride(1) == n
    pairs, singles = LAYOUTS["mixed"]
    alpha = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    A2, A1 = pk.packed_adjoint(Tp, alpha, pairs=pairs, singles=singles)
    W2w, W1w = pk.packed_adjoint_plain(Tp, alpha, pairs, singles)
    assert _rel(_flat(A2, A1, alpha), torch.cat([W2w.reshape(-1), W1w.reshape(-1)])) <= KERNEL_RTOL
    G2 = [torch.from_numpy(rng.normal(size=(2, W2, W2)).astype(np.float32)).to(dev) for _ in pairs]
    G1 = [torch.from_numpy(rng.normal(size=(2, W2)).astype(np.float32)).to(dev) for _ in singles]
    ys = torch.stack(pk.packed_forward(Tp, G2, G1, pairs=pairs, singles=singles))
    assert _rel(ys, pk.packed_forward_plain(Tp, torch.stack(G2, 1), torch.stack(G1, 1), pairs, singles)) \
        <= KERNEL_RTOL


@pytest.mark.parametrize("source", ["doubling", "direct"])
def test_wide_regen_point_ranges(dev, monkeypatch, source):
    """A phase slab larger than SLAB_BYTES runs in point ranges (here four
    of 5 x 130 x 256 float32, the last ragged): the adjoint's ranges summed
    in order and the forward's written side by side equal the plain
    versions, one launch counted per range, a second call bitwise equal."""
    n, W2 = 997, 130
    src, P, _, rng = _wide_src(dev, n, W2, source)
    monkeypatch.setattr(pk, "SLAB_BYTES", 5 * W2 * 256 * 4)
    assert pk._point_ranges(src, W2) == [(0, 256), (256, 512), (512, 768), (768, 997)]
    pairs, singles = LAYOUTS["mixed"]
    alpha = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    pk.reset_launch_counts()
    runs = [_flat(*_wide_adjoint(src, alpha, pairs, singles, source, P), alpha) for _ in range(2)]
    W2w, W1w = _wide_adjoint_want(src, alpha, P, pairs, singles, source)
    assert torch.equal(runs[0], runs[1])
    assert _rel(runs[0], torch.cat([W2w.reshape(-1), W1w.reshape(-1)])) <= WIDE_RTOL[source]
    G2 = [torch.from_numpy(rng.normal(size=(2, W2, W2)).astype(np.float32)).to(dev) for _ in pairs]
    G1 = [torch.from_numpy(rng.normal(size=(2, W2)).astype(np.float32)).to(dev) for _ in singles]
    ys = torch.stack(_wide_forward(src, G2, G1, pairs, singles, source, P))
    assert _rel(ys, _wide_forward_want(src, G2, G1, P, pairs, singles, source)) <= WIDE_RTOL[source]
    assert pk.WIDE_ADJOINT.launches_by_shape == {"2P=130 nv=3": 8}
    assert pk.WIDE_FORWARD.launches_by_shape == {"2P=130 nsets=2": 4}


def test_wide_routes_and_refusals(dev):
    """The wrappers send the narrow kernels' widths to them and every other
    even width to the wide pair (counted there only), 2P = 1028 too (the
    wide pair has no width cap); float64 operands at a wide width raise
    before any launch."""
    pairs = ((0, 1),)
    x, _ = _coords(dev, 300)
    alpha = torch.ones((2, 300), device=dev)
    pk.reset_launch_counts()
    pk.packed_adjoint(pk.pack_phase_table(x, 16), alpha, pairs=pairs)            # narrow f32
    pk.packed_adjoint(pk.pack_phase_table(x, 32), alpha, pairs=pairs)            # wide f32
    pk.packed_adjoint_regen(x, alpha, P=17, pairs=pairs)                          # narrow regen
    pk.packed_adjoint_regen(x, alpha, P=16, pairs=pairs)                          # wide regen (2P = 32)
    pk.packed_forward_regen(x, [torch.ones((1, 130, 130), device=dev)], P=65, pairs=pairs)
    torch.cuda.synchronize()
    assert (pk.packed_adjoint.launches, pk.packed_adjoint_regen.launches) == (1, 1)
    assert pk.WIDE_ADJOINT.launches_by_shape == {"2P=64 nv=2": 1, "2P=32 nv=2": 1}
    assert pk.WIDE_FORWARD.launches_by_shape == {"2P=130 nsets=1": 1}
    pk.packed_adjoint(pk.pack_phase_table(x, 514), alpha, pairs=pairs)
    pk.packed_adjoint_regen(x, alpha, P=514, pairs=pairs)
    pk.packed_adjoint_regen(x, alpha, P=514, pairs=pairs, phase_gen="direct")
    torch.cuda.synchronize()
    assert pk.WIDE_ADJOINT.launches_by_shape["2P=1028 nv=2"] == 3
    with pytest.raises(ValueError):                                              # float64 alpha
        pk.packed_adjoint_regen(x, alpha.double(), P=65, pairs=pairs)
    with pytest.raises(ValueError):                                              # float64 table
        pk.packed_adjoint(pk.pack_phase_table(x.double(), 32), alpha, pairs=pairs)
    assert pk.WIDE_ADJOINT.launches == 5 and pk.WIDE_FORWARD.launches == 1


def test_wide_kernels_at_afn_pcg_256_shape(dev):
    """The wide pair at chip_smoke's [afn-pcg-256] shape (n = 1e5, one 2-D
    window, a float32 table at 2P = 256, nv = nsets = 1): relative
    Frobenius 1e-4 (sqrt(n) eps for 1e5-term sums), bitwise repeats."""
    n = 100_000
    Tp, P, _, rng = _wide_src(dev, n, 256, "f32")
    pairs = ((0, 1),)
    alpha = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).to(dev)
    A2 = pk.packed_adjoint(Tp, alpha, pairs=pairs)[0][0]
    assert torch.equal(A2, pk.packed_adjoint(Tp, alpha, pairs=pairs)[0][0])
    assert _rel(A2, pk.packed_adjoint_plain(Tp, alpha, pairs, ())[0][:, 0]) <= 1e-4
    G2 = [torch.from_numpy(rng.normal(size=(1, 256, 256)).astype(np.float32)).to(dev)]
    y = pk.packed_forward(Tp, G2, pairs=pairs)[0]
    assert torch.equal(y, pk.packed_forward(Tp, G2, pairs=pairs)[0])
    assert _rel(y, pk.packed_forward_plain(Tp, torch.stack(G2, 1), None, pairs, ())[0]) <= 1e-4


# --- the wide adjoint's 2-D windows on wgmma (3xTF32), and calls past one launch's windows ---

WG_WIDTHS = [2, 8, 16, 30, 32, 64, 66, 72, 128, 130, 136, 144, 146, 256, 258, 1026, 1028, 1030, 2050]
# (nv, n): every nv and every n at least once; n = 1, below and above one
# 32-point stage, past a chunk's 64-point tiles, [afn-pcg-256]'s size
WG_NV_N = [(1, 1), (3, 31), (10, 33), (16, 4097), (17, 100_003), (1, 100_003), (10, 4097)]
WG_RTOL = 1e-4


@pytest.mark.parametrize("nv,n", WG_NV_N)
@pytest.mark.parametrize("W2", WG_WIDTHS)
@pytest.mark.parametrize("source", WIDE_SOURCES)
def test_wide_adjoint_wgmma_matches_plain(dev, source, W2, nv, n):
    """The wide adjoint (its 2-D windows on wgmma in 3xTF32, two products on
    bf16 tables; its 1-D window on the CUDA cores) at every width class of
    its N tiles (2P = 2 to 2050: one tile of each compiled width, 64, 72,
    128, 136 and 144, rounded up from the width, and several past 144; the
    rows of a 128-row block in one or two runs of a), every phase source, nv across the 64-row M tiles, n = 1 to
    100003: relative Frobenius 1e-4 against the plain version (the
    regenerating sources against it in float64), a second launch bitwise
    equal, every launch counted (the table kernels' own widths 16 and 32
    through the wide entry)."""
    pairs, singles = LAYOUTS["mixed"]
    src, P, name, rng = _wide_src(dev, n, W2, source, seed=W2 + n)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    direct = name == "table" and W2 in pk.KERNEL_WIDTHS

    def call():
        if direct:
            return pk._adjoint_outputs(*pk._adjoint_wide(src, alpha, pairs, singles), True, len(pairs), len(singles))
        return _wide_adjoint(src, alpha, pairs, singles, name, P)

    key = f"2P={W2} nv={nv}"
    before = pk.WIDE_ADJOINT.launches_by_shape.get(key, 0)
    runs = [call() for _ in range(2)]
    torch.cuda.synchronize()
    ranges = 1 if name == "table" else len(pk._point_ranges(src, W2))
    assert pk.WIDE_ADJOINT.launches_by_shape[key] == before + 2 * ranges
    got, again = (_flat(A2, A1, alpha) for A2, A1 in runs)
    assert torch.equal(got, again)
    W2w, W1w = _wide_adjoint_want(src, alpha, P, pairs, singles, name)
    assert _rel(got, torch.cat([W2w.reshape(-1), W1w.reshape(-1)])) <= WG_RTOL


# (nsets, n) of the wgmma forward: one set block and two (33), n = 1, below
# one 32-point box, past a 128-point block, [afn-pcg-256]'s size
FW_NSETS_N = [(1, 1), (2, 31), (20, 997), (33, 997), (3, 4097), (1, 100_003)]


@pytest.mark.parametrize("nsets,n", FW_NSETS_N)
@pytest.mark.parametrize("W2", WG_WIDTHS)
@pytest.mark.parametrize("source", WIDE_SOURCES)
def test_wide_forward_wgmma_matches_plain(dev, source, W2, nsets, n):
    """The wide forward (its 2-D windows on wgmma in 3xTF32, two products on
    bf16 tables; its 1-D window on the CUDA cores) at every width class of
    its N tiles (2P = 2 to 2050: one tile of each compiled width, 64, 72,
    128 and 136, rounded up from the width, and several past 136; K = 2P in
    stages of 32 b with a ragged last one), every phase source, nsets in one
    32-set block and two, n = 1 to 100003: relative Frobenius 1e-4 against
    the plain version (the regenerating sources against it in float64: at
    2P = 1026 and 2050 this also bounds the tensor cores' float32
    accumulation over K = 2P), a second launch bitwise equal, every launch
    counted (the table kernels' own widths 16 and 32 through the wide
    entry).  The weights come from a seeded torch generator on the card
    (numpy would take seconds for 2 x 33 x 2050^2 of them)."""
    pairs, singles = LAYOUTS["mixed"]
    src, P, name, _ = _wide_src(dev, n, W2, source, seed=W2 + n)
    gen = torch.Generator(device=dev).manual_seed(W2 + nsets)
    G2 = [torch.randn((nsets, W2, W2), generator=gen, device=dev) for _ in pairs]
    G1 = [torch.randn((nsets, W2), generator=gen, device=dev) for _ in singles]
    direct = name == "table" and W2 in pk.KERNEL_WIDTHS

    def call():
        if direct:
            G2c, G1c = pk._dense_stacks(torch.stack(G2, 1), torch.stack(G1, 1), W2, dev)
            return pk._forward_wide(src, G2c, G1c, pairs, singles)
        return torch.stack(_wide_forward(src, G2, G1, pairs, singles, name, P))

    key = f"2P={W2} nsets={nsets}"
    before = pk.WIDE_FORWARD.launches_by_shape.get(key, 0)
    ys, again = call(), call()
    torch.cuda.synchronize()
    ranges = 1 if name == "table" else len(pk._point_ranges(src, W2))
    assert pk.WIDE_FORWARD.launches_by_shape[key] == before + 2 * ranges
    assert torch.equal(ys, again) and tuple(ys.shape) == (nsets, n)
    assert _rel(ys, _wide_forward_want(src, G2, G1, P, pairs, singles, name)) <= WG_RTOL


@pytest.mark.parametrize("source", ["f32", "bf16"])
def test_wide_forward_unaligned_inputs(dev, source):
    """What the forward's TMA copies cannot read as given reaches them
    through copies: a table held at stride n = 997 (rows off 16-byte
    boundaries) through `_aligned_table`, and weights at 2P = 130 (520-byte
    rows) given as a strided view through the weight split, whose output
    is bitwise the plain split's (tf32 halves, rows padded to 132 floats,
    zeros in the pad); the result equals the plain version."""
    n, W2 = 997, 130
    Tp, P, _, rng = _wide_src(dev, n, W2, source)
    Tp = Tp.contiguous()
    assert Tp.stride(1) == n and pk._aligned_table(Tp).stride(1) % 16 == 0
    pairs = LAYOUTS["pairs"][0]
    wide = torch.from_numpy(rng.normal(size=(3, len(pairs), W2, W2 + 7)).astype(np.float32)).to(dev)
    G2s = wide[..., 3:W2 + 3]
    split = _cuda_build.split_weights_wide(G2s)
    assert split.shape[-1] == 132 and torch.equal(split, pk.split_weights_plain(G2s))
    before = pk.WIDE_FORWARD.launches
    ys = torch.stack(pk.packed_forward(Tp, list(torch.unbind(G2s, 1)), pairs=pairs))
    assert pk.WIDE_FORWARD.launches == before + 1
    assert _rel(ys, pk.packed_forward_plain(Tp, G2s, None, pairs, ())) <= KERNEL_RTOL


@pytest.mark.parametrize("case", ["split_pointer", "table_pointer", "table_stride"])
def test_wide_forward_refuses_misaligned(dev, case):
    """The C entry point refuses what its TMA copies cannot read (split
    weights or a table off 16-byte boundaries, a table's row stride not a
    multiple of 16 bytes): the launch returns cudaErrorInvalidValue (1)
    and the launcher raises."""
    n, W2 = 997, 128
    Tp, _, _, _ = _wide_src(dev, n, W2, "f32")
    gsplit = torch.zeros(2 * W2 * W2 + 1, device=dev)
    gsplit = gsplit[1:] if case == "split_pointer" else gsplit[:-1]
    if case == "table_pointer":
        Tp = torch.ones((5, W2, n + 7), device=dev)[:, :, 1:n + 1]
    elif case == "table_stride":
        Tp = Tp.contiguous()
    G1, y = torch.zeros(1, device=dev), torch.empty((1, n), device=dev)
    lib = _cuda_build.library("packed_ndft_wide")
    code = lib.wide_forward_launch(0, Tp.data_ptr(), Tp.stride(1), W2, n, _cuda_build._ints((0, 1)), 1,
                                   gsplit.data_ptr(), _cuda_build._ints(()), 0, G1.data_ptr(), 1, y.data_ptr(),
                                   _cuda_build._stream(y))
    assert code == 1
    with pytest.raises(RuntimeError, match="wide forward launch failed"):
        _cuda_build._check(lib, code, "wide forward")


MANY_PAIRS = tuple((2 * w, 2 * w + 1) for w in range(33))
MANY_SINGLES = tuple(range(65))


@pytest.mark.parametrize("route", ["f32@32", "bf16@32", "doubling@34", "direct@34",
                                   "f32@64", "bf16@64", "doubling@66", "direct@66"])
def test_many_windows_every_route(dev, route):
    """33 pairs and 65 singles in one call, on every route (the narrow
    float32-table, bf16-table and regenerating kernels, the wide pair on
    each phase source; a table's kernel by `table_route`, so at 2P = 32 the
    float32 table's three weight sets take the wide pair): two launches of
    the adjoint and two of the forward per call, their outputs concatenated
    / summed in order equal to the plain versions (tables: KERNEL_RTOL;
    regenerating: 1e-4 against float64) and a second call bitwise equal."""
    source, W2 = route.split("@")
    W2, n, nv, nsets = int(W2), 997, 3, 3
    rng = np.random.default_rng(W2)
    x = torch.from_numpy(rng.uniform(-0.25, 0.25, size=(66, n)).astype(np.float32)).to(dev)
    P = W2 // 2
    table = source in ("f32", "bf16")
    if table:
        src = pk.pack_phase_table(x, P, table_dtype=torch.float32 if source == "f32" else torch.bfloat16)
        name, tol = "table", KERNEL_RTOL
    else:
        src, name, tol = x, source, 1e-4
    if table:  # the route rule of tables: by width, table type and count
        dtype = torch.float32 if source == "f32" else torch.bfloat16
        adj_counter = pk.packed_adjoint if pk.table_route(W2, dtype, "adjoint", nv) != "wide" else pk.WIDE_ADJOINT
        fwd_counter = pk.packed_forward if pk.table_route(W2, dtype, "forward", nsets) != "wide" else pk.WIDE_FORWARD
    else:
        narrow = W2 in pk.REGEN_KERNEL_WIDTHS
        adj_counter = pk.packed_adjoint_regen if narrow else pk.WIDE_ADJOINT
        fwd_counter = pk.packed_forward_regen if narrow else pk.WIDE_FORWARD
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    before = (adj_counter.launches, fwd_counter.launches)
    runs = [_flat(*_wide_adjoint(src, alpha, MANY_PAIRS, MANY_SINGLES, name, P), alpha) for _ in range(2)]
    G2 = [torch.from_numpy(rng.normal(size=(nsets, W2, W2)).astype(np.float32)).to(dev) for _ in MANY_PAIRS]
    G1 = [torch.from_numpy(rng.normal(size=(nsets, W2)).astype(np.float32)).to(dev) for _ in MANY_SINGLES]
    ys = [torch.stack(_wide_forward(src, G2, G1, MANY_PAIRS, MANY_SINGLES, name, P)) for _ in range(2)]
    torch.cuda.synchronize()
    assert (adj_counter.launches, fwd_counter.launches) == (before[0] + 4, before[1] + 4)
    assert torch.equal(runs[0], runs[1]) and torch.equal(ys[0], ys[1])
    W2w, W1w = _wide_adjoint_want(src, alpha, P, MANY_PAIRS, MANY_SINGLES, name)
    assert _rel(runs[0], torch.cat([W2w.reshape(-1), W1w.reshape(-1)])) <= tol
    assert _rel(ys[0], _wide_forward_want(src, G2, G1, P, MANY_PAIRS, MANY_SINGLES, name)) <= tol
