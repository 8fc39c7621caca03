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
layouts with only 2-D or only 1-D windows, and the 32-pair / 64-single
limits of one call.

Tolerances:
- kernels: relative Frobenius error 1e-5 -- the same products summed in
  another order in float32, about sqrt(n) eps for n of a few thousand; the
  regenerated phases differ from torch's cos/sin by about 1e-6;
- a whole loss step on the card against the same step on CPU tensors (plain
  versions), float32: for the stream engine loss rtol 1e-4, gradient rtol
  1e-3 / atol 1e-4 -- the kernels' float32 rounding carried through the
  FGMRES solve and the SLQ estimate; for the fused matern12 engine, at
  mu = 1 where its FGMRES converges, loss rtol 1e-3, gradient rtol 1e-2 /
  atol 1e-3 -- at mu = 0.1 the 20-step FGMRES stops unconverged and float32
  rounding alone moved the loss by 5e-3 between card and CPU.
"""

import numpy as np
import pytest
import torch

from nfft4gp_torch.models.problem import GPProblem
from nfft4gp_torch.models.transforms import transform_inverse
from nfft4gp_torch.ops import packed_ndft as pk

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


def test_wrappers_count_and_refuse(dev):
    Tp, rng = _table(dev, 300, 16, torch.bfloat16)
    alpha = torch.ones((2, 300), device=dev)
    G2 = [torch.ones((3, 32, 32), device=dev)]
    before = (pk.packed_adjoint.launches, pk.packed_forward.launches)
    pk.packed_adjoint(Tp, alpha, pairs=((0, 1),))
    pk.packed_forward(Tp, G2, pairs=((0, 1),))
    assert (pk.packed_adjoint.launches, pk.packed_forward.launches) == (before[0] + 1, before[1] + 1)

    wide, _ = _table(dev, 300, 24, torch.bfloat16)          # 2P = 48: not compiled
    with pytest.raises(ValueError):
        pk.packed_adjoint(wide, alpha, pairs=((0, 1),))
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


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [37, 4099])
@pytest.mark.parametrize("P", [9, 17])
@pytest.mark.parametrize("phase_gen", pk.PHASE_GENS)
@pytest.mark.parametrize("nv", [1, 9])
def test_adjoint_regen_matches_plain(dev, layout, n, P, phase_gen, nv):
    pairs, singles = LAYOUTS[layout]
    xT, rng = _coords(dev, n)
    alpha = torch.from_numpy(rng.normal(size=(nv, n)).astype(np.float32)).to(dev)
    A2, A1 = pk.packed_adjoint_regen(xT, alpha, P=P, pairs=pairs, singles=singles, phase_gen=phase_gen)
    torch.cuda.synchronize()
    W2, W1 = pk.packed_adjoint_regen_plain(xT, alpha, P, pairs, singles, phase_gen)
    got = torch.cat([torch.stack(A2, 1).reshape(-1) if A2 else alpha.new_zeros(0),
                     torch.stack(A1, 1).reshape(-1) if A1 else alpha.new_zeros(0)])
    assert _rel(got, torch.cat([W2.reshape(-1), W1.reshape(-1)])) <= KERNEL_RTOL


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n", [37, 4099])
@pytest.mark.parametrize("P", [9, 17])
@pytest.mark.parametrize("phase_gen", pk.PHASE_GENS)
@pytest.mark.parametrize("nsets", [1, 7, 8, 17])
def test_forward_regen_matches_plain(dev, layout, n, P, phase_gen, nsets):
    """nsets straddle the forward's set tiles (7 sets per block at 2P = 34,
    16 at 2P = 18)."""
    pairs, singles = LAYOUTS[layout]
    xT, rng = _coords(dev, n)

    def weights(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)

    G2 = [weights(nsets, 2 * P, 2 * P) for _ in pairs]
    G1 = [weights(nsets, 2 * P) for _ in singles]
    ys = pk.packed_forward_regen(xT, G2, G1, P=P, pairs=pairs, singles=singles, phase_gen=phase_gen)
    torch.cuda.synchronize()
    want = pk.packed_forward_regen_plain(xT, torch.stack(G2, 1) if pairs else None,
                                         torch.stack(G1, 1) if singles else None, P, pairs, singles,
                                         phase_gen)
    assert len(ys) == nsets
    assert _rel(torch.stack(ys), want) <= KERNEL_RTOL


@pytest.mark.parametrize("kind", ["pairs", "singles"])
def test_regen_window_limits(dev, kind):
    """32 pairs / 64 singles in one call run; one more raises before any
    launch."""
    n, P = 300, 17
    xT, rng = _coords(dev, n, rows=64)
    if kind == "pairs":
        full, over = tuple((2 * w, 2 * w + 1) for w in range(32)), {"pairs": ((0, 1),) * 33}
        kw = {"pairs": full}
    else:
        full, over = tuple(range(64)), {"pairs": (), "singles": tuple(range(64)) + (0,)}
        kw = {"pairs": (), "singles": full}
    alpha = torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)).to(dev)
    A2, A1 = pk.packed_adjoint_regen(xT, alpha, P=P, **kw)
    torch.cuda.synchronize()
    W2, W1 = pk.packed_adjoint_regen_plain(xT, alpha, P, kw["pairs"], kw.get("singles", ()))
    got = torch.stack(A2, 1) if A2 else torch.stack(A1, 1)
    assert _rel(got, W2 if A2 else W1) <= KERNEL_RTOL
    G = [torch.ones((2, 2 * P, 2 * P) if A2 else (2, 2 * P), device=dev) for _ in full]
    ys = pk.packed_forward_regen(xT, G if A2 else (), () if A2 else G, P=P, **kw)
    torch.cuda.synchronize()
    want = pk.packed_forward_regen_plain(xT, torch.stack(G, 1) if A2 else None,
                                         None if A2 else torch.stack(G, 1), P, kw["pairs"],
                                         kw.get("singles", ()))
    assert _rel(torch.stack(ys), want) <= KERNEL_RTOL
    before = pk.packed_adjoint_regen.launches
    with pytest.raises(ValueError):
        pk.packed_adjoint_regen(xT, alpha, P=P, **over)
    with pytest.raises(ValueError):                        # 2P = 32: not a regenerating width
        pk.packed_adjoint_regen(xT, alpha, P=16, **kw)
    with pytest.raises(ValueError):                        # float64 coordinates
        pk.packed_adjoint_regen(xT.double(), alpha, P=P, **kw)
    assert pk.packed_adjoint_regen.launches == before


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
