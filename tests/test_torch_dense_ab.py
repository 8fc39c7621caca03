"""scripts/torch_table_kernels_ab.py --kernels dense, on the CPU: its
arguments parse, without a card it refuses to run (exit non-zero, no
result line) rather than timing anything on the CPU, and the pieces it
builds on the card from plain text and plans -- the phase-timed copy of
csrc/fused_pcg.cu and the --variants plans -- are what they claim."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from nfft4gp_torch.solvers import fused_pcg as fp

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_table_kernels_ab.py"


def _module():
    spec = importlib.util.spec_from_file_location("torch_table_kernels_ab", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dense_mode_parses():
    ab = _module()
    args = ab.parse_args(["--kernels", "dense", "--old-csrc", "OLD/csrc", "--variants"])
    assert args.kernels == "dense" and args.old_csrc == Path("OLD/csrc") and args.variants
    args = ab.parse_args(["--kernels", "dense"])
    assert args.old_csrc is None and not args.variants


def test_dense_mode_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(SCRIPT), "--kernels", "dense", "--old-csrc", "OLD/csrc"],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "[ab]" not in proc.stdout and '{"ab"' not in proc.stdout


def test_phase_timed_source_switches_every_mark_on():
    """The timed copy of csrc/fused_pcg.cu: every `// @phase:` mark becomes a
    call, the phase recorder sits after the includes, the reader is
    exported; a source without marks is refused."""
    ab = _module()
    src = (ROOT / "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch" / "csrc"
           / "fused_pcg.cu").read_text()
    marks = src.count(ab.PHASE_ANCHOR)
    assert marks >= len(ab.PHASES[0]) + len(ab.PHASES[1]) + 2  # both kernels' marks, the product's two
    timed = ab.phase_timed_source(src)
    assert ab.PHASE_ANCHOR not in timed
    assert timed.count("phase(0, it, ") + timed.count("phase(1, it, ") == marks
    assert timed.index(ab.INCLUDE_LAST) < timed.index("void phase(int kernel") < timed.index("phase(0, it, 0);")
    assert timed.rstrip().endswith("}") and "int fused_phase_times(" in timed
    with pytest.raises(ValueError):
        ab.phase_timed_source(src.replace(ab.PHASE_ANCHOR, ""))


@pytest.mark.parametrize("n", [2700, 4096, 16384])
@pytest.mark.parametrize("sms", [132, 114])
def test_variant_plans_match_the_plans_rules(n, sms):
    """The --variants plans: at the card's own settings they are the card's
    own plan; at others they cover the same rows / panels and fit the
    shared memory."""
    ab = _module()
    smem = 232448
    cg = fp.cg_plan(n, sms, smem)
    assert cg.stages and ab.cg_variant(cg, cg.stages, smem) == cg
    for stages in (2, 3, 4, 8):
        v = ab.cg_variant(cg, stages, smem)
        assert v.starts == cg.starts and v.stages == stages and v.smem <= smem
        assert v.smem == fp.SMEM_SLACK + fp.CG_FIXED + v.row_bytes * (1 + max(v.resident) + stages)
    lz = fp.lanczos_plan(n, 10, sms, smem, 10)
    assert lz.streams
    assert ab.lanczos_variant(lz, smem, own=lz.own, rows_per_group=fp.LZ_STREAM_ROWS, stages=fp.LZ_STAGES) == lz
    for own, per_group, stages in ((False, 8, 2), (lz.own, 2, 6), (lz.own, 4, 3)):
        v = ab.lanczos_variant(lz, smem, own=own, rows_per_group=per_group, stages=stages)
        assert v.pstarts == lz.pstarts and v.stages == stages and v.own == own and v.smem <= smem
        assert all(0 <= r < v.chunks for r in v.resident)
        assert v.smem == fp.SMEM_SLACK + fp.LZ_FIXED + v.own_bytes + stages * v.stage_bytes + max(
            (v.pstarts[b + 1] - v.pstarts[b]) * v.resident[b] for b in range(v.blocks)) * v.chunk_bytes
