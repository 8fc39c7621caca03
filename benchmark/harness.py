"""One run of one cell: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name: the cell's entry in
BENCHMARK.json, its configuration file, its traffic mix
(benchmark/traffic/<traffic>.json), its limits (benchmark/limits/<cell>.json)
and its per-layer metrics' readers (benchmark/metrics/<metric>.py).  The
traffic's `kind` picks the loop: `train` (Adam steps of GPProblem.make_loss's
closure), `predict` (GPProblem.predict requests) or `solve` (PCG solves of
one deployment's operator, each request a fresh right-hand side).
"""

import gc
import importlib
import importlib.util
import json
import math
import random
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from . import check, generator, trace
from . import spans as spans_mod
from .reference import afn_reference as aref
from .reference import gp_reference as ref
from .reference import solve_reference as sref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = spans_mod.PORT
FORBIDDEN = ("jax", "jaxlib", "flax", "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu",
             "nfft4gp_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    bdir = root / "benchmark"
    return Cell(name=name, chips=w["chips"], config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((bdir / "traffic" / f"{w['traffic']}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer,
                limits=json.loads((bdir / "limits" / f"{name}.json").read_text()))


def port(module: str):
    return importlib.import_module(f"{PORT}.{module}")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card_label(dev) -> str:
    """The card's name and nvidia-smi's power limit."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


# --- the program's side ------------------------------------------------------------

def launch_counts():
    pk = port("ops.packed_ndft")
    return {fn.__name__: dict(fn.launches_by_shape) for fn in pk.KERNEL_WRAPPERS}


def launch_delta(after: dict, before: dict) -> dict:
    return {k: {s: c - before.get(k, {}).get(s, 0) for s, c in v.items() if c - before.get(k, {}).get(s, 0)}
            for k, v in after.items()}


class Window(NamedTuple):
    units: int
    window_s: float
    setup_s: float
    failed: int
    memory_peak: int
    spans: dict
    span_units: int      # units run under the timed spans
    launches: dict
    stretch: Optional[trace.Stretch]
    stretch_launches: dict
    answers: dict        # what the check compares: the program's side
    counters: Optional[dict] = None   # the program's own counts over the window


class _Traced(NamedTuple):
    outs: list
    window_s: float
    setup_s: float
    spans: dict
    span_units: int
    launches: dict
    stretch: Optional[trace.Stretch]
    stretch_launches: dict


def _window(run_unit, seconds, traced, dev, t0, profile_after, profile_units, min_units=1) -> _Traced:
    """Run whole units until `seconds` have passed and at least `min_units`
    have run.  A traced run times its units under the synchronizing spans,
    but for a stretch of `profile_units` after `profile_after`, which it
    profiles without them, so that the trace holds no wait of the
    benchmark's."""
    log = spans_mod.SpanLog(dev)
    port("ops.packed_ndft").reset_launch_counts()
    stretch, stretch_launches, span_units = None, {}, 0
    outs = []
    sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t0
    while True:
        if traced and stretch is None and len(outs) >= profile_after:
            before = launch_counts()
            got, stretch = trace.profiled(lambda: [run_unit(len(outs) + k) for k in range(profile_units)], dev)
            stretch_launches = launch_delta(launch_counts(), before)
            outs.extend(got)
        else:
            with spans_mod.installed(log) if traced else nullcontext():
                outs.append(run_unit(len(outs)))
            span_units += traced
        done = time.perf_counter() - t_start >= seconds and len(outs) >= min_units
        if done and (not traced or stretch is not None):
            break
    sync(dev)
    window_s = time.perf_counter() - t_start
    return _Traced(outs=outs, window_s=window_s, setup_s=setup_s, spans=dict(log.seconds), span_units=span_units,
                   launches=launch_counts(), stretch=stretch, stretch_launches=stretch_launches)


def _peak(dev):
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def nearfield_lfil(problem: dict) -> int:
    """The near-field's size the configuration states (GPProblem's default
    where it states none: 16 for matern12, else 0)."""
    nf = problem.get("fastsum_nearfield_lfil")
    return (16 if problem["kernel"] == "matern12" else 0) if nf is None else nf


def reference_problem(cell: Cell, inp: generator.Inputs, which: str, prec: ref.Precision = ref.REFERENCE,
                      plan: Optional[aref.Plan] = None) -> ref.Problem:
    """The reference's problem: the configuration's windows, preconditioner
    (AFN on `plan`'s structure) and, in training, its near-field, whose
    pairs are found here once, on the points in `prec`'s dtype."""
    cfg = cell.config
    p = cfg["problem"]
    spec = cfg["reference"][which]
    specs = tuple(ref.WindowSpec(feats=tuple(w), nyquist=spec["nyquist"],
                                 table=_dtype(spec["tables"].get(str(len(w)))))
                  for w in p["windows"])
    nearfield, nf = None, nearfield_lfil(p)
    if which == "train" and nf > 0:
        X = inp.X.to(prec.dtype)
        with ref.tf32_mode(prec.tf32):
            nearfield = tuple(sref.NearField(*ref.scaled_points(X[:, list(w)], prec.dtype), nf)
                              for w in p["windows"])
    return ref.Problem(kind=p["kernel"], X=inp.X, y=inp.y, probes=inp.probes, landmarks=inp.landmarks,
                       specs=specs, N=p["fastsum_N"], rank=p["rank"], maxits=p["maxits"], tol=p["tol"],
                       precond=p["precond"], plan=plan, nearfield=nearfield)


def plan_structure(plan) -> aref.Plan:
    """The structure of the port's AFN plan, on the host."""
    return aref.Plan(perm=plan.perm.cpu(), k=int(plan.k), use_ran=bool(plan.use_ran),
                     idx=plan.pattern[0].cpu(), mask=plan.pattern[1].cpu())


def plan_faults(cell: Cell, answers: dict) -> list:
    """What is wrong with the AFN plan a training run's answers hold (none
    without AFN)."""
    p = cell.config["problem"]
    if p["precond"] != "afn":
        return []
    plan = answers.get("plan")
    return ["no AFN plan"] if plan is None else aref.plan_faults(plan, cell.config["n"], p["rank"])


def _dtype(name):
    return None if name is None else getattr(torch, name)


def control_precision(config: dict) -> ref.Precision:
    c = config["control"]
    return ref.Precision(dtype=_dtype(c["dtype"]), tf32=c["tf32"])


def _compared(records, end, beta1) -> dict:
    """The program's side of `check_steps` consecutive steps: records
    [(Adam state before, loss, solve's answer)] and the state after them.
    The gradient of the first step is the optimizer's, worked out from its
    first moment before and after it."""
    states = [r[0] for r in records] + [end]
    start = states[0]
    return {"start": ref.AdamStart(*(a.detach().double().cpu() for a in (start.x, start.m, start.v)), start.t),
            "losses": [float(r[1]) for r in records],
            "grad1": ((states[1].m - beta1 * start.m) / (1.0 - beta1)).double().cpu(),
            "change": (end.x - start.x).double().cpu(),
            "solution": records[0][2]}


def run_train(cell: Cell, inp, seconds, traced, dev, t0) -> Window:
    """Set-up builds the loss closure and drives its first steps; the
    window steps the same closure on.  What the check reads: the first
    `check_steps` steps of the set-up and the first `check_steps` of the
    window, which run whatever the set-up left behind (a captured graph, a
    cache) on the timed path; with AFN, the plan's structure, and the rows
    of the Schur FSAI that the set-up's factorizations repaired."""
    cfg, tr = cell.config, cell.traffic
    adam = port("models.adam")
    hp = cfg["adam"]
    check = tr["check_steps"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prob = port("models.problem").GPProblem(**cfg["problem"])
    # an AFN plan is made at the starting hyperparameters, as GPProblem.fit makes it
    params0 = tuple(math.log1p(math.exp(v)) for v in cfg["raw_params0"])
    loss_fn = prob.make_loss(inp.X, inp.y, params0, probes=inp.probes, landmarks=inp.landmarks)
    x0 = torch.tensor(cfg["raw_params0"], dtype=inp.X.dtype, device=dev)
    state = [adam.adam_init(x0)]
    taken, compared = [], {}
    solve = [None]

    def step(i, part):
        solve[0] = None
        before = state[0]
        st, ls, _, _ = adam.adam_run(loss_fn, before.x, maxits=1, alpha=hp["alpha"], beta1=hp["beta1"],
                                     beta2=hp["beta2"], eps=hp["eps"], state0=before)
        state[0] = st
        if i < check:
            taken.append((before, ls[0], solve[0]))
            if i + 1 == check:
                compared[part] = _compared(taken, st, hp["beta1"])
                taken.clear()
        return ls[0]

    repaired = []
    with spans_mod.captured(solve):
        with spans_mod.kept_breakdowns(repaired):
            for s in range(tr["setup_steps"]):
                step(s, "setup")
        w = _window(lambda i: step(i, "window"), seconds, traced, dev, t0, tr["profile_after"], tr["profile_units"],
                    min_units=check)
    failed = sum(not math.isfinite(float(v)) for v in w.outs)
    peak = _peak(dev)
    if prob.afn_plan_ is not None:
        compared.update(plan=plan_structure(prob.afn_plan_), repaired=[int(b) for b in repaired])
    del loss_fn, prob, state
    _free(dev)
    return Window(units=len(w.outs), window_s=w.window_s, setup_s=w.setup_s, failed=failed, memory_peak=peak,
                  spans=w.spans, span_units=w.span_units, launches=w.launches, stretch=w.stretch,
                  stretch_launches=w.stretch_launches, answers=compared)


def reference_train(cell: Cell, rp: ref.Problem, start: ref.AdamStart, prec: ref.Precision = ref.REFERENCE) -> dict:
    """The reference's (or, at a lower precision, the control's) steps from
    an Adam state, on the reference's problem `rp` (made in `prec`)."""
    losses, g1, x = ref.adam_steps(rp, start, cell.traffic["check_steps"], prec)
    return {"losses": losses, "grad1": g1.cpu(), "change": (x - start.x.to(x)).cpu()}


def run_predict(cell: Cell, inp, seconds, traced, dev, t0, seed) -> Window:
    cfg, tr = cell.config, cell.traffic
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prob = port("models.problem").GPProblem(**cfg["problem"])
    x0 = torch.tensor(cfg["raw_params0"], dtype=inp.X.dtype, device=dev)
    prob.raw_params_ = x0
    maxits = predict_maxits(cell)
    warm = tr["warm_requests"]

    def request(i):
        Xt = generator.test_points(cfg, tr, seed, i, dev)
        mean = prob.predict(inp.X, inp.y, Xt, landmarks=inp.landmarks, maxits=maxits)
        sync(dev)
        return mean

    for i in range(warm):
        request(i)
    w = _window(lambda i: request(warm + i), seconds, traced, dev, t0, tr["profile_after"], tr["profile_units"])
    units = len(w.outs)
    failed = sum(not bool(torch.isfinite(m).all()) for m in w.outs)
    peak = _peak(dev)
    picks = sorted(random.Random(seed).sample(range(units), min(tr["check_requests"], units)))
    means = [w.outs[i].double().cpu() for i in picks]
    w.outs.clear()
    del prob
    _free(dev)
    return Window(units=units, window_s=w.window_s, setup_s=w.setup_s, failed=failed, memory_peak=peak,
                  spans=w.spans, span_units=w.span_units, launches=w.launches, stretch=w.stretch,
                  stretch_launches=w.stretch_launches, answers={"requests": [warm + i for i in picks], "means": means})


def reference_predict(cell: Cell, inp, seed, requests, prec: ref.Precision = ref.REFERENCE) -> list:
    """The reference's posterior means of the given requests."""
    cfg, tr = cell.config, cell.traffic
    x0 = torch.tensor(cfg["raw_params0"], dtype=torch.float64, device=inp.X.device)
    tests = [generator.test_points(cfg, tr, seed, i, inp.X.device) for i in requests]
    return ref.posterior_mean(reference_problem(cell, inp, "predict"), x0, tests, predict_maxits(cell), prec)


def predict_maxits(cell: Cell) -> int:
    return cell.traffic.get("maxits") or 2 * cell.config["problem"]["maxits"] * 10


def run_solve(cell: Cell, inp, seconds, traced, dev, t0, seed) -> Window:
    """Set-up builds the deployment's operator (geometry, radius near-field,
    clipped coefficients, the packed plan) and its AFN preconditioner (plan
    and factorization) once; a request solves A x = b for a fresh
    right-hand side by PCG from x = 0.  What the check reads: the answers
    of `check_requests` requests of the window, drawn from the seed."""
    cfg, tr = cell.config, cell.traffic
    p = cfg["problem"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    fs, kernels, afn = port("ops.fastsum"), port("ops.kernels"), port("preconds.afn")
    X, kind = inp.X, p["kernel"]
    params = kernels.KernelParams.make(p["f"], p["l"], p["mu"], dtype=X.dtype, device=dev)
    windows = kernels.make_windows(p["windows"])
    tables = _dtype(p["table_dtype"])
    geom = fs.additive_fastsum_geometry(X, windows, N=p["fastsum_N"], table_dtype=tables)
    stencils = fs.additive_nearfield_stencil_direct(geom, kind, p["nf_lfil"])
    if stencils is None:
        raise RuntimeError("the radius near-field's cell grid degenerated on these sites")
    plan = fs.additive_fastsum_coeffs(kind, params, geom, psd_clip=p["psd_clip"], nearfield_lfil=0)
    pn = fs.packed_ndft_plan(plan, table_dtype=tables, nf_stencils=stencils, nf_require_grad=False)
    del plan, geom, stencils
    aplan = afn.afn_plan(kind, params, X, maxrank=p["rank"], lfil=p["lfil"], rank=p["rank"], force_afn=True)
    pre = afn.afn_setup_from_plan(kind, params, X, aplan, windows=windows)
    warm = tr["warm_requests"]

    def matvec(v):
        return fs.packed_ndft_matvec(pn, v)

    def request(i):
        b = generator.rhs(cfg, seed, i, dev)
        res = port("solvers.pcg").pcg(matvec, b, precond=pre.solve, tol=p["tol"], maxits=p["maxits"],
                                      replace_every=p["replace_every"])
        sync(dev)
        return res

    def window_request(i):
        res = request(warm + i)
        return res.niter, res.converged, res.x, res.relres

    for i in range(warm):
        request(i)
    w = _window(window_request, seconds, traced, dev, t0, tr["profile_after"], tr["profile_units"],
                min_units=tr["check_requests"])
    units = len(w.outs)
    failed = sum(not conv for _, conv, _, _ in w.outs)
    iters = sum(its for its, _, _, _ in w.outs)
    peak = _peak(dev)
    picks = sorted(random.Random(seed).sample(range(units), min(tr["check_requests"], units)))
    answers = {"requests": [warm + i for i in picks], "x": [w.outs[i][2].double().cpu() for i in picks],
               "relres": [float(w.outs[i][3]) for i in picks]}
    w.outs.clear()
    del pn, pre, aplan
    _free(dev)
    return Window(units=units, window_s=w.window_s, setup_s=w.setup_s, failed=failed, memory_peak=peak,
                  spans=w.spans, span_units=w.span_units, launches=w.launches, stretch=w.stretch,
                  stretch_launches=w.stretch_launches, answers=answers,
                  counters={"pcg_iters": iters})


def solve_operator(cell: Cell, inp, prec: ref.Precision = ref.REFERENCE) -> sref.Operator:
    """The reference's operator (and dense kernel) of a solve cell's sites."""
    return sref.Operator(sref.spec_of(cell.config["problem"]), inp.X, prec)


def solve_rhs(cell: Cell, inp, seed, requests):
    """The right-hand sides of the given requests, (len, n)."""
    return torch.stack([generator.rhs(cell.config, seed, i, inp.X.device) for i in requests])


def make_inputs(cell: Cell, seed: int, dev):
    """The cell's shared inputs from the seed."""
    if cell.traffic["kind"] == "solve":
        return generator.solve_inputs(cell.config, seed, dev)
    return generator.make_inputs(cell.config, seed, dev)


def run_program(cell: Cell, inp, seconds, traced, dev, t0, seed) -> Window:
    """The set-up and the window of the cell's traffic kind."""
    kind = cell.traffic["kind"]
    if kind == "train":
        return run_train(cell, inp, seconds, traced, dev, t0)
    if kind == "predict":
        return run_predict(cell, inp, seconds, traced, dev, t0, seed)
    if kind == "solve":
        return run_solve(cell, inp, seconds, traced, dev, t0, seed)
    raise ValueError(f"unknown traffic kind {kind!r}")


TRAIN_PARTS = (("setup", ""), ("window", "w_"))     # part of the answers, prefix of its numbers


def numbers(cell: Cell, inp, seed, answers: dict, reference=None):
    """(compared numbers, the reference's side) of a program's answers;
    `reference` reuses the reference's side of an earlier call (a training
    part it lacks is worked out from the answers' start).  The residual of
    a training part's solve is read on the reference's operator whenever
    the answers hold one."""
    if cell.traffic["kind"] == "train":
        reference = dict(reference or {})
        nums = {}
        if cell.config["problem"]["precond"] == "afn":
            # a plan that is not the configuration's AFN plan sets every other number missing
            nums["plan_bad"] = float(bool(plan_faults(cell, answers)))
            if nums["plan_bad"]:
                return nums, reference
        rp = None
        for part, prefix in TRAIN_PARTS:
            a = answers[part]
            if rp is None and (part not in reference or a.get("solution") is not None):
                rp = reference_problem(cell, inp, "train", plan=answers.get("plan"))
            if part not in reference:
                reference[part] = reference_train(cell, rp, a["start"])
            nums.update(check.train_numbers(a, reference[part], prefix))
            if a.get("solution") is not None:
                nums[prefix + "solve_res"] = ref.solve_residual(rp, a["start"].x, a["solution"])
        return nums, reference
    if cell.traffic["kind"] == "solve":
        op = reference if reference is not None else solve_operator(cell, inp)
        on_op, on_kernel = sref.residuals(op, solve_rhs(cell, inp, seed, answers["requests"]),
                                          torch.stack(answers["x"]))
        return check.solve_numbers(on_op, on_kernel), op
    reference = reference if reference is not None else reference_predict(cell, inp, seed, answers["requests"])
    return check.predict_numbers(answers["means"], reference), reference


def control_answers(cell: Cell, inp, seed, answers: dict, prec: Optional[ref.Precision] = None) -> dict:
    """The control's answers: the reference in the program's place at the
    precision below the configuration's (its `control`; or at `prec`), from
    the same starts as the program's."""
    prec = prec or control_precision(cell.config)
    if cell.traffic["kind"] == "train":
        rp = reference_problem(cell, inp, "train", prec, answers.get("plan"))
        out = {part: {"start": answers[part]["start"], "solution": None,
                      **reference_train(cell, rp, answers[part]["start"], prec)} for part, _ in TRAIN_PARTS}
        return {**out, "plan": answers.get("plan")} if "plan" in answers else out
    if cell.traffic["kind"] == "solve":
        p = cell.config["problem"]
        op = solve_operator(cell, inp, prec)
        maxits = cell.config["control"].get("maxits") or p["maxits"]
        solves = [sref.cg(op.matvec, b.to(prec.dtype), p["tol"], maxits)
                  for b in solve_rhs(cell, inp, seed, answers["requests"])]
        return {"requests": answers["requests"], "x": [x.double().cpu() for x, _ in solves],
                "steps": [steps for _, steps in solves]}
    return {"requests": answers["requests"],
            "means": reference_predict(cell, inp, seed, answers["requests"], prec)}


# --- readings and the result -------------------------------------------------------

class Reading(NamedTuple):
    """What a per-layer metric's reader reads."""

    cell: Cell
    units: int
    spans: dict                  # span -> host seconds over the units run under the timed spans
    span_units: int
    launches: dict               # wrapper -> {shape: launches} over the window
    stretch: Optional[trace.Stretch]
    stretch_launches: dict
    counters: Optional[dict] = None   # the program's own counts over the window

    def per_unit_ms(self, span):
        s = self.spans.get(span)
        return None if s is None or self.span_units == 0 else 1000.0 * s / self.span_units


def read_metric(name: str, reading: Reading, metrics_dir: Path = HERE / "metrics"):
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}", metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(reading)


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """One run; returns the result line as a dict ("checks" last)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    inp = make_inputs(cell, seed, dev)
    w = run_program(cell, inp, seconds, traced, dev, t0, seed)
    nums, _ = numbers(cell, inp, seed, w.answers)
    correct, checks = check.verdict(nums, cell.limits)
    correct = correct and w.failed == 0 and w.units > 0
    metrics = {}
    if traced:
        reading = Reading(cell=cell, units=w.units, spans=w.spans, span_units=w.span_units, launches=w.launches,
                          stretch=w.stretch, stretch_launches=w.stretch_launches, counters=w.counters)
        for m in cell.per_layer:
            v = read_metric(m["name"], reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": w.setup_s, cell.traffic["metric"]: w.window_s / max(w.units, 1)}
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": w.memory_peak}
    out = {"correct": bool(correct), "attempted": w.units, "failed": w.failed, "metrics": metrics,
           "device": device}
    if traced and w.stretch is not None:
        device["busy_s"] = w.stretch.busy_s
        device["window_s"] = w.stretch.wall_s
        out["breakdown"] = trace.breakdown(w.stretch)
    out["card"] = card_label(dev)
    out["window"] = {"seconds": w.window_s, "units": w.units}
    out["checks"] = checks
    return out
