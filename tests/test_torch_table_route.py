"""The route rule of the table kernels and the launch planners of the
float32-table kernels (ops/packed_ndft.py `table_route`; ops/_cuda_build.py
`f32_stage_points`, `f32_rhs_per_block`, `f32_adjoint_chunks`,
`f32_forward_chunk` and the forward's passes), all pure Python, decided
before any launch, so they run here without a card.

The kernels themselves (csrc/packed_ndft.cu) run only on the card
(tests/test_torch_cuda.py); their plain versions' parity with the JAX
package is tests/test_torch_packed_ndft.py's.
"""

import pytest
import torch

from nfft4gp_torch.ops import _cuda_build as cb
from nfft4gp_torch.ops import packed_ndft as tpn

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("W2", [16, 32])
@pytest.mark.parametrize("op,limit", [("adjoint", "F32_MAX_NV"), ("forward", "F32_MAX_NSETS")])
def test_f32_tables_cut_over_to_the_wide_pair(W2, op, limit):
    """float32 tables at the narrow widths go to csrc/packed_ndft.cu up to
    the width's cut-over count and to the wide pair past it, on both sides
    of it; a width without a cut-over keeps csrc/packed_ndft.cu at any
    count."""
    cut = getattr(tpn, limit)[W2]
    if cut is None:
        for count in (1, 2, 10, 20, 33, 1000):
            assert tpn.table_route(W2, F32, op, count) == "f32"
        return
    assert cut >= 1
    for count in sorted({1, cut}):
        assert tpn.table_route(W2, F32, op, count) == "f32"
    assert tpn.table_route(W2, F32, op, cut + 1) == "wide"
    assert tpn.table_route(W2, F32, op, 10 * cut + 7) == "wide"


@pytest.mark.parametrize("op", ["adjoint", "forward"])
@pytest.mark.parametrize("count", [1, 2, 10, 20, 33])
def test_bf16_tables_stay_on_the_tensor_cores(op, count):
    """bf16 tables at 2P = 16, 32 keep csrc/packed_ndft_tc.cu at any count;
    at every other even width they take the wide pair."""
    for W2 in tpn.KERNEL_WIDTHS:
        assert tpn.table_route(W2, BF16, op, count) == "bf16"
    for W2 in (2, 8, 18, 34, 64, 128, 130, 256, 1028):
        assert tpn.table_route(W2, BF16, op, count) == "wide"
        assert tpn.table_route(W2, F32, op, count) == "wide"


@pytest.mark.parametrize("W2", [0, 15, 31, 33, 129])
def test_table_route_refuses_odd_widths(W2):
    with pytest.raises(ValueError):
        tpn.table_route(W2, F32, "adjoint", 1)


def test_f32_stage_points_and_rhs_per_block():
    """A stage holds 16 KB of each table operand (128 points at 2P = 32, 256
    at 16); the adjoint's compiled right-hand-side groups: 1 or 2 at 2P =
    32, 1, 2 or 4 at 16."""
    assert (cb.f32_stage_points(32), cb.f32_stage_points(16)) == (128, 256)
    assert [cb.f32_rhs_per_block(32, nv) for nv in (1, 2, 3, 10)] == [1, 2, 2, 2]
    assert [cb.f32_rhs_per_block(16, nv) for nv in (1, 2, 3, 10)] == [1, 2, 4, 4]


@pytest.mark.parametrize("W2", [16, 32])
@pytest.mark.parametrize("nv", [1, 2, 10])
@pytest.mark.parametrize("n,npairs,nsingles", [(1, 1, 0), (63, 1, 1), (4099, 2, 1), (100_000, 1, 0),
                                                (100_000, 5, 0), (1_000_000, 32, 0), (20_000, 0, 3)])
def test_f32_adjoint_chunks(W2, nv, n, npairs, nsingles):
    """Chunks of whole stages that cover the n points, none empty; with 2-D
    windows about one block an SM of 132: the (chunk, window, right-hand
    side group) blocks stay within the SMs unless one chunk already passes
    them, and fill more than half of them where the stages allow."""
    tp = cb.f32_stage_points(W2)
    sms = 132
    nchunks, chunk = cb.f32_adjoint_chunks(W2, nv, n, npairs, nsingles, sms)
    assert chunk % tp == 0 and chunk >= tp
    assert (nchunks - 1) * chunk < n <= nchunks * chunk
    if npairs:
        per_chunk = npairs * -(-nv // cb.f32_rhs_per_block(W2, nv))
        assert nchunks * per_chunk <= max(sms, per_chunk)
        if -(-n // tp) >= sms and per_chunk <= sms:
            assert nchunks * per_chunk > sms // 2


# the forward's limits of csrc/packed_ndft.cu (FwdCfg: weight sets a pass,
# points a block, by 2P), which the wrapper reads from the library
FW_SETS, FW_CHUNK = {16: 16, 32: 1}, {16: 1024, 32: 2048}


@pytest.mark.parametrize("W2", [16, 32])
@pytest.mark.parametrize("n", [1, 255, 256, 4099, 100_000, 1_000_000])
def test_f32_forward_chunk(W2, n):
    """The forward's blocks: whole stages, at most the kernel's points a
    block at the width (its y in shared memory), about one block an SM of
    132."""
    tp = cb.f32_stage_points(W2)
    cap = FW_CHUNK[W2]
    chunk = cb.f32_forward_chunk(W2, n, 132, cap)
    assert chunk % tp == 0 and tp <= chunk <= cap and cap % tp == 0
    blocks = -(-n // chunk)
    assert blocks <= 132 or chunk == cap
    if chunk > tp:                           # a stage fewer a block would need more blocks than SMs
        assert -(-n // (chunk - tp)) > 132 or chunk == cap


@pytest.mark.parametrize("W2", [16, 32])
@pytest.mark.parametrize("nsets", [1, 3, 4, 5, 17, 33])
def test_f32_forward_passes_cover_every_set(W2, nsets):
    """The float32-table forward runs its weight sets in passes of at most
    the library's sets a pass (16 at 2P = 16, 1 at 32), in order, each set
    once."""
    cap = FW_SETS[W2]
    passes = cb.forward_regen_split(nsets, cap)
    assert [s for s0, ns in passes for s in range(s0, s0 + ns)] == list(range(nsets))
    assert all(1 <= ns <= cap for _, ns in passes) and len(passes) == -(-nsets // cap)
