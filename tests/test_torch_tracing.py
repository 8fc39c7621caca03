"""The port's tracer (utils/timers.py): spans, counters and host_read, on a
tiny GPProblem (gaussian, two 2-feature windows, the stream engine's plain
versions, Nystrom, float64, n = 300).

Off, nothing is recorded and the answers are those of a run with tracing
on, bit for bit.  On, one Adam step gives the tree step > loss >
{op_build, precond_setup, fgmres > sync x k, slq > sync x m} with the grad
norm's read a sync under step; the fgmres span carries the solve's
iterations and relres; host_syncs is the count the code's loops give.

The `cuda` test runs on a card (this file imports no jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py -q

It holds a device kernel's interval, from a CUDA-only profile, inside the
host span that launched and read it (the shared clock), and counts the
blocking calls of one training step and of one prediction request with
torch.cuda.set_sync_debug_mode("warn"):
those inside host_read's sync spans equal host_syncs, and the others in
the port come from the library calls named in LIBRARY_SYNCS (a warning
with no frame of the port, such as the debug mode's own, is not the
step's).
"""

import json
import warnings
from collections import Counter
from pathlib import Path

import pytest
import torch

from nfft4gp_torch.models import adam
from nfft4gp_torch.models.gp import gp_loss_gaussian_ran_softplus
from nfft4gp_torch.models.problem import GPProblem
from nfft4gp_torch.solvers.fgmres import fgmres
from nfft4gp_torch.utils import timers

N = 300
# the blocking calls of one training step that host_read does not count:
# the libraries' info checks, by the port's (file, function) that calls them
LIBRARY_SYNCS = {
    ("nystrom.py", "nystrom_setup"),      # torch.linalg.svd
    ("nystrom.py", "trace"),              # torch.linalg.cholesky
    ("lanczos.py", "lanczos_batch"),      # torch.linalg.solve
    ("lanczos.py", "slq_logdet"),         # torch.linalg.eigh
}
# how far a device interval may lie outside the host span that waited for
# it: the two clocks' offset as the profiler converts them
CLOCK_SLACK_NS = 50_000


def _problem(device="cpu", dtype=torch.float64):
    g = torch.Generator().manual_seed(0)
    X = torch.rand(N, 4, generator=g, dtype=dtype)
    y = torch.sin(3 * X[:, 0]) + 0.1 * torch.randn(N, generator=g, dtype=dtype)
    prob = GPProblem(kernel="gaussian", windows=[[0, 1], [2, 3]], operator="fastsum", precond="nystrom", rank=20,
                     fastsum_engine="stream", device=device)
    return prob, X.to(device), y.to(device)


def _step(trace_on):
    prob, X, y = _problem()
    loss_fn = prob.make_loss(X, y)
    x0 = torch.zeros(3, dtype=torch.float64)
    if not trace_on:
        return adam.adam_run(loss_fn, x0, maxits=1), None
    with timers.tracing() as tr:
        out = adam.adam_run(loss_fn, x0, maxits=1)
    return out, tr


def _children(tr):
    by_id = {s.id: s for s in tr.spans}
    return by_id, Counter((s.name, by_id[s.parent].name if s.parent is not None else None) for s in tr.spans)


def test_tracing_off_records_nothing():
    timers.profiled().clear()
    assert timers.span("loss") is timers.NO_SPAN
    timers.count("host_syncs")
    assert timers.host_read(torch.ones(2).sum(), float) == 2.0
    _step(trace_on=False)
    assert not timers.profiled().spans and not timers.profiled().counters


def test_loss_and_gradient_bitwise_equal_with_tracing_on_and_off():
    (st_off, ls_off, _, gs_off), _ = _step(trace_on=False)
    (st_on, ls_on, _, gs_on), tr = _step(trace_on=True)
    assert torch.equal(ls_off[0], ls_on[0]) and torch.equal(gs_off[0], gs_on[0]) and torch.equal(st_off.x, st_on.x)
    assert tr.spans


def test_predicted_mean_bitwise_equal_with_tracing_on_and_off():
    prob, X, y = _problem()
    prob.raw_params_ = torch.zeros(3, dtype=torch.float64)
    Xt = torch.rand(40, 4, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    off = prob.predict(X, y, Xt, maxits=30)
    with timers.tracing() as tr:
        on = prob.predict(X, y, Xt, maxits=30)
    assert torch.equal(off, on)
    by_id, pairs = _children(tr)
    assert pairs[("predict", None)] == 1 and pairs[("op_build", "predict")] == 1
    assert pairs[("precond_setup", "predict")] == 1 and pairs[("fgmres", "predict")] == 1
    assert pairs[("mean", "predict")] == 1
    under = Counter(by_id[s.parent].name if s.parent is not None else None for s in tr.spans if s.name == "sync")
    (f,) = [s for s in tr.spans if s.name == "fgmres"]
    assert under == {
        "fgmres": 1 + 4 * (f.attrs["restarts"] + 1) + 3 * f.attrs["iters"] + 1,
        # the windows' feature columns (two plans, two windows) and the fold maps' copies
        # (two plans, two folds, two 2-feature windows, 2 parity sets, 2 dims)
        "op_build": 2 * 2 + 2 * 2 * 2 * 2 * 2,
        "precond_setup": 2 * 2 * 2 + 2,
        # GPProblem.predict's (1, 1, 0.1) for the preconditioner's plan (the landmarks, drawn
        # on the points' device here, need no copy)
        None: 3,
    }
    assert sum(under.values()) == tr.counters["host_syncs"]


def test_one_adam_step_gives_the_span_tree():
    _, tr = _step(trace_on=True)
    by_id, pairs = _children(tr)
    assert pairs[("step", None)] == 1 and pairs[("loss", "step")] == 1
    for child in ("op_build", "precond_setup", "fgmres", "slq"):
        assert pairs[(child, "loss")] == 1
    assert pairs[("sync", "step")] == 1          # the grad norm's read
    assert pairs[("sync", "fgmres")] > 0 and pairs[("sync", "slq")] > 0
    assert {name for name, _ in pairs} == {"step", "loss", "op_build", "precond_setup", "fgmres", "slq", "sync"}
    for s in tr.spans:                           # children lie inside their parents
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0_ns <= s.t0_ns <= s.t1_ns <= p.t1_ns
    step = next(s for s in tr.spans if s.name == "step")
    assert step.attrs == {"step": 1}


@pytest.mark.parametrize("tol", [1e-6, 1e-14])
def test_fgmres_span_carries_the_loss_results_solve(tol):
    g = torch.Generator().manual_seed(3)
    X = torch.rand(N, 3, generator=g, dtype=torch.float64)
    y = torch.sin(4 * X[:, 0]) + 0.1 * torch.randn(N, generator=g, dtype=torch.float64)
    probes = torch.randint(0, 2, (4, N), generator=g).to(torch.float64) * 2 - 1
    with timers.tracing() as tr:
        res = gp_loss_gaussian_ran_softplus(torch.tensor([0.0, -1.0, -2.0], dtype=torch.float64), X, y, probes,
                                            rank=10, maxits=10, tol=tol)
    (sp,) = [s for s in tr.spans if s.name == "fgmres"]
    assert sp.attrs["iters"] == res.solve_iters and sp.attrs["restarts"] == 0
    assert sp.attrs["relres"] == float(res.solve_relres)
    if tol < 1e-12:
        assert res.solve_iters == 20


def test_fgmres_span_counts_restarts():
    g = torch.Generator().manual_seed(4)
    A = torch.rand(50, 50, generator=g, dtype=torch.float64)
    A = A @ A.T + 0.5 * torch.eye(50, dtype=torch.float64)
    b = torch.rand(50, generator=g, dtype=torch.float64)
    with timers.tracing() as tr:
        res = fgmres(lambda v: A @ v, b, kdim=4, maxits=14, tol=1e-14)
    (sp,) = [s for s in tr.spans if s.name == "fgmres"]
    assert (sp.attrs["iters"], sp.attrs["restarts"]) == (res.niter, 3) == (14, 3)
    assert sp.attrs["relres"] == float(res.relres)
    # normb; per cycle beta, its history entry, y's copy and the true
    # residual; an iteration's two reads and history entry; `converged`
    assert tr.counters["host_syncs"] == 1 + 4 * 4 + 3 * 14 + 1


def test_host_syncs_is_the_count_of_the_code():
    _, tr = _step(trace_on=True)
    by_id = {s.id: s for s in tr.spans}
    under = Counter(by_id[s.parent].name for s in tr.spans if s.name == "sync")
    (f,) = [s for s in tr.spans if s.name == "fgmres"]
    steps = tr.counters["lanczos_steps"]
    assert under == {
        # normb; per cycle beta, its history entry, y's copy and the true residual; an
        # iteration's two reads and history entry; `converged`
        "fgmres": 1 + 4 * (f.attrs["restarts"] + 1) + 3 * f.attrs["iters"] + 1,
        # a check at the start of each Lanczos step, and the one that stops it early
        "slq": steps + (steps < 10),
        "step": 1,                 # the gradient's norm
        "loss": 1,                 # the gradient mask's copy
        # the fold maps' copies: two folds x two 2-feature windows x 2 parity sets x 2 dims
        "op_build": 2 * 2 * 2 * 2,
        # the window rows' copies (K1, K11; both sides; two windows) and stable_chol's two info reads
        "precond_setup": 2 * 2 * 2 + 2,
    }
    assert sum(under.values()) == tr.counters["host_syncs"]


def test_a_profiler_turns_tracing_on():
    from torch.profiler import ProfilerActivity, profile

    timers.profiled().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with timers.span("outer", k=1):
            timers.host_read(torch.ones(3).sum(), float)
    tr = timers.profiled()
    assert [s.name for s in tr.spans] == ["sync", "outer"] and tr.counters == {"host_syncs": 1}
    assert tr.spans[0].parent == tr.spans[1].id and tr.spans[1].attrs == {"k": 1}
    timers.profiled().clear()
    timers.host_read(torch.ones(3).sum(), float)
    assert not tr.spans and not tr.counters


def test_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    prob, X, y = _problem()
    loss_fn = prob.make_loss(X, y)
    with timers.trace(str(tmp_path), device="cpu"):
        adam.adam_run(loss_fn, torch.zeros(3, dtype=torch.float64), maxits=1)
    spans = json.loads((tmp_path / "spans.json").read_text())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = Counter(e["name"] for e in spans["traceEvents"])
    assert names["step"] == names["loss"] == names["fgmres"] == names["slq"] == 1
    assert spans["counters"]["host_syncs"] == names["sync"] > 0
    (step,) = [e for e in spans["traceEvents"] if e["name"] == "step"]
    ops = [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("aten::")]
    # the profiler's host ops of the step lie inside the step's span
    inside = [e for e in ops if step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]]
    assert len(inside) > 0.9 * len(ops) > 0


def test_stage_timers_are_a_summary_of_their_spans():
    t = timers.StageTimers()
    for _ in range(2):
        with t("solve"):
            torch.ones(10) * 2
    assert t.counts["solve"] == 2 == sum(s.name == "solve" for s in t.trace.spans)
    assert t.totals["solve"] == pytest.approx(sum(s.t1_ns - s.t0_ns for s in t.trace.spans) * 1e-9)


@pytest.mark.cuda
def test_card_shares_the_clock_and_counts_the_syncs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda:0")
    x = torch.ones(1000, device=dev)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with timers.tracing() as tr, profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timers.span("probe"):
            torch.cuda._sleep(20_000_000)
            timers.host_read(x.sum(), float)
    (probe,) = [s for s in tr.spans if s.name == "probe"]
    sleeps = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA and "spin" in e.name().lower()]
    assert sleeps
    s, e = sleeps[-1]
    assert e - s > 1_000_000
    assert probe.t0_ns - CLOCK_SLACK_NS <= s and e <= probe.t1_ns + CLOCK_SLACK_NS, (probe.t0_ns - s, probe.t1_ns - e)

    prob, X, y = _problem(dev, torch.float32)
    loss_fn = prob.make_loss(X, y)
    x0 = torch.zeros(3, device=dev)
    adam.adam_run(loss_fn, x0, maxits=1)          # builds and warms
    torch.cuda.synchronize()
    prob.raw_params_ = x0
    Xt = torch.rand(40, 4, generator=torch.Generator().manual_seed(1)).to(dev)
    prob.predict(X, y, Xt, maxits=30)
    torch.cuda.synchronize()
    for work in (lambda: adam.adam_run(loss_fn, x0, maxits=1), lambda: prob.predict(X, y, Xt, maxits=30)):
        tr, outside, lines = sync_warnings(work)
        assert tr.counters["host_syncs"] == tr.counters["warned_in_sync"] > 0, lines
        assert set(outside) <= LIBRARY_SYNCS, lines


def sync_warnings(fn):
    """Run fn with tracing on and torch.cuda.set_sync_debug_mode("warn").
    Returns the trace, its counter `warned_in_sync` the warnings raised
    inside a sync span; a Counter of the others by the port's (file,
    function) that made the blocking call; and every warning's call
    site, in the port where it has a frame."""
    import sys

    pkg = Path(timers.__file__).parents[1]
    outside, lines = Counter(), Counter()

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        in_sync = bool(tr.open) and tr.open[-1].name == "sync"
        f = sys._getframe(1)
        while f is not None and (pkg not in Path(f.f_code.co_filename).parents
                                 or f.f_code.co_filename == timers.__file__):
            f = f.f_back
        site = (Path(filename).name, f.f_code.co_name if f else "", f.f_lineno if f else lineno)
        lines[("sync" if in_sync else "other",) + site] += 1
        if in_sync:
            tr.count("warned_in_sync")
        elif f is not None:
            outside[(Path(f.f_code.co_filename).name, f.f_code.co_name)] += 1

    with timers.tracing() as tr, warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return tr, outside, lines
