"""Card-only checks of the port's CUDA kernels (marker `cuda`).

They need an NVIDIA GPU and nvcc, and skip without a CUDA device.  On a GPU
machine (this file imports no jax; --noconftest keeps tests/conftest.py,
which configures JAX, out of the run):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Each kernel is held against its plain torch version on the same CUDA
tensors, at small shapes that reach the edge cases the training shapes of
chip_smoke.py do not: both compiled widths, f32 and bf16 tables, a ragged
last tile, fewer points than one tile, weight-set counts that straddle the
forward's set tiles, and layouts with only 2-D or only 1-D windows.

Tolerances:
- kernels: relative Frobenius error 1e-5 -- the same products summed in
  another order in float32, about sqrt(n) eps for n of a few thousand;
- a whole fastsum + Nystrom loss step on the card against the same step
  on CPU tensors (plain versions), float32: loss rtol 1e-4, gradient rtol
  1e-3 / atol 1e-4 -- the kernels' float32 rounding carried through the
  FGMRES solve and the SLQ estimate.
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
