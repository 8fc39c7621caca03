"""The launch plans of the fused dense CG and Lanczos kernels
(solvers/fused_pcg.py `cg_plan`, `lanczos_plan`, `dense_plan`), on the CPU.

A plan says which rows (CG) or column panels (Lanczos) of K each block of
the one-block-an-SM cooperative launch owns, how many of them stay in
shared memory for the launch and how many stream every step.  The C entry
points of csrc/fused_pcg.cu refuse a plan that breaks any of what is held
here (tests/test_torch_cuda.py checks that on the card); these tests hold
the plans the wrappers make to it at the sizes around the card's 132 SMs,
the 2.7k rows where CG's rows stop fitting, n = 4096 (partly streamed) and
the n = 16384 limit, for a card of 132, 114 and 1 SMs.
"""

import pytest

from nfft4gp_torch.solvers import fused_pcg as fp

NS = (1, 31, 131, 132, 133, 2048, 2700, 4096, 16384)
SMS = (132, 114, 1)
H100_SMEM = 232448   # opt-in shared memory a block of an H100
SMALL_SMEM = 101376  # a card with 99 KB a block


def _cg_smem(plan):
    row = 4 * fp._ld(plan.n)
    return fp.SMEM_SLACK + fp.CG_FIXED + row * (1 + max(plan.resident) + plan.stages)


def _lz_smem(plan):
    per = [plan.pstarts[b + 1] - plan.pstarts[b] for b in range(plan.blocks)]
    held = max(p * r for p, r in zip(per, plan.resident))
    streams = any(r < plan.chunks for r in plan.resident)
    stage = 4 * plan.chunk_rows * (fp._nvp4(plan.nv) + (plan.width if streams else 0))
    own = -(-4 * max(per) * plan.width * (fp._nvp4(plan.nv) + plan.nv * (plan.maxits + 1)) // 1024) * 1024
    assert plan.own == (own <= fp.LZ_OWN_MAX)
    return fp.SMEM_SLACK + fp.LZ_FIXED + (own if plan.own else 0) + plan.stages * stage + held * plan.chunk_bytes


@pytest.mark.parametrize("budget", [H100_SMEM, SMALL_SMEM], ids=["h100", "99k"])
@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", NS)
def test_cg_plan_covers_rows_once_and_fits(n, sms, budget):
    row = 4 * fp._ld(n)
    base = fp.SMEM_SLACK + fp.CG_FIXED + row  # and p
    all_rows = base + row * -(-n // min(sms, n))
    two_stages = base + 2 * row  # two one-row stages
    if min(all_rows, two_stages) > budget:  # neither the rows nor a ring fit
        with pytest.raises(ValueError):
            fp.cg_plan(n, sms, budget)
        return
    plan = fp.cg_plan(n, sms, budget)
    # one block an SM at most, none without rows
    assert plan.blocks == min(sms, n) <= sms
    assert len(plan.starts) == plan.blocks + 1 and len(plan.resident) == plan.blocks
    assert plan.starts[0] == 0 and plan.starts[-1] == n
    counts = [plan.starts[b + 1] - plan.starts[b] for b in range(plan.blocks)]
    assert min(counts) >= 1 and max(counts) - min(counts) <= 1
    covered = [i for b in range(plan.blocks) for i in range(plan.starts[b], plan.starts[b + 1])]
    assert covered == list(range(n))
    assert all(0 <= r <= c for r, c in zip(plan.resident, counts))
    streamed = any(r < c for r, c in zip(plan.resident, counts))
    if streamed:  # one-row stages: about CG_RING_BYTES, two at least
        assert plan.stages == min(fp.MAX_STAGES, max(2, fp.CG_RING_BYTES // row), (budget - base) // row)
    else:
        assert plan.stages == 0
    assert plan.smem == _cg_smem(plan) <= budget
    assert plan.resident_bytes + plan.streamed_bytes == n * row
    assert plan.streamed_bytes == sum(c - r for r, c in zip(plan.resident, counts)) * row


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("nv,maxits", [(1, 10), (10, 10), (16, 10), (16, 64)])
@pytest.mark.parametrize("n", NS)
def test_lanczos_plan_covers_columns_once_and_fits(n, nv, maxits, sms):
    plan = fp.lanczos_plan(n, nv, sms, H100_SMEM, maxits)
    assert (plan.nv, plan.maxits) == (nv, maxits)
    C = plan.width
    assert C in fp.LZ_WIDTHS
    panels = -(-n // C)
    # the narrowest width whose panels are no more than the blocks a card runs
    if C != fp.LZ_WIDTHS[0] and C != fp.LZ_WIDTHS[-1]:
        assert -(-n // (C // 2)) > min(sms, fp.MAX_BLOCKS) >= panels
    assert plan.blocks == min(sms, panels) <= sms
    assert plan.pstarts[0] == 0 and plan.pstarts[-1] == panels
    per = [plan.pstarts[b + 1] - plan.pstarts[b] for b in range(plan.blocks)]
    assert min(per) >= 1 and max(per) - min(per) <= 1
    cols = [c for b in range(plan.blocks) for c in range(plan.pstarts[b] * C, min(n, plan.pstarts[b + 1] * C))]
    assert cols == list(range(n))
    groups = fp.LZ_CONS // (C // 4)
    assert all(0 <= r <= plan.chunks for r in plan.resident)
    # chunks of LZ_STREAM_ROWS rows a consumer column group where K streams
    # (LZ_RESIDENT_ROWS where it all stays), whole boxes of at most 256 rows
    if plan.streams:
        assert plan.chunk_rows == min(256, fp.LZ_STREAM_ROWS * groups) and plan.stages == fp.LZ_STAGES
    else:
        assert plan.chunk_rows == min(256, fp.LZ_RESIDENT_ROWS * groups)
        assert 2 <= plan.stages <= fp.LZ_MAX_STAGES and plan.resident == (plan.chunks,) * plan.blocks
    assert plan.smem == _lz_smem(plan) <= H100_SMEM
    assert plan.resident_bytes + plan.streamed_bytes == panels * plan.chunks * plan.chunk_bytes


@pytest.mark.parametrize("n", NS)
def test_dense_plan_pairs_both_and_keeps_k_resident_below_its_size(n):
    cg, lz = fp.dense_plan(n, 10, 132, H100_SMEM)
    assert cg == fp.cg_plan(n, 132, H100_SMEM) and lz == fp.lanczos_plan(n, 10, 132, H100_SMEM, 10)
    # CG's rows of K fit the SMs' shared memory up to about n = 2.7k, and
    # stream in part past it
    assert (cg.streamed_bytes == 0) == (n <= 2048)
    # a resident row per block at least wherever p and the ring leave room
    if n <= 4096:
        assert min(cg.resident) >= 1
    # Lanczos holds all of K at n = 2048, v_it alone in its ring, and about
    # a fifth of K at 4096 (a ring of two large stages beside it); there, at
    # 10 steps, the blocks' own columns of w and of V in shared memory, at
    # nv = 16 and 64 steps in global memory
    if n in (2048, 4096):
        assert lz.own and not fp.lanczos_plan(n, 16, 132, H100_SMEM, 64).own
    if n <= 2048:
        assert lz.streamed_bytes == 0 and lz.stage_bytes == 4 * lz.chunk_rows * 12
    if n == 4096:
        assert 0.15 < lz.resident_bytes / (lz.resident_bytes + lz.streamed_bytes) < 0.3


@pytest.mark.parametrize("kind", ["cg", "lanczos"])
def test_plans_refuse_outside_the_limits(kind):
    make = (lambda n, nv: fp.cg_plan(n, 132, H100_SMEM)) if kind == "cg" else (
        lambda n, nv: fp.lanczos_plan(n, nv, 132, H100_SMEM))
    with pytest.raises(ValueError):
        make(0, 1)
    with pytest.raises(ValueError):
        make(fp.MAX_N + 1, 1)
    with pytest.raises(ValueError):
        (fp.cg_plan(64, 0, H100_SMEM) if kind == "cg" else fp.lanczos_plan(64, 1, 0, H100_SMEM))
    with pytest.raises(ValueError):  # a card whose shared memory holds no ring
        (fp.cg_plan(fp.MAX_N, 132, 100_000) if kind == "cg" else fp.lanczos_plan(64, 16, 132, 20_000))
    if kind == "lanczos":
        with pytest.raises(ValueError):
            fp.lanczos_plan(64, fp.MAX_NV + 1, 132, H100_SMEM)
        with pytest.raises(ValueError):
            fp.lanczos_plan(64, 2, 132, H100_SMEM, fp.MAX_ITS + 1)
