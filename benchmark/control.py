"""The readings that a cell's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds ...] [--witness-seeds ...] [--witness-dtype float32|float64] \
        [--fault-seeds ...] [--seconds S] [--fault-seconds F]

For every seed of --seeds the program's compared numbers (a run with a
window of S seconds, no trace); for every seed of --control-seeds the
control's (the reference in the program's place at the precision below the
configuration's, from the program's own starts); for every seed of
--witness-seeds the reference in float32 (or --witness-dtype) with TF32
off (a second witness: where it sides with the float64 reference and the
program does not, the program is at fault); for every seed of
--fault-seeds the program's under each planted fault (benchmark/faults.py),
with a window of F seconds (default S).  One JSON line a reading, then a
summary: per number the largest program reading (the lower reading) and
the smallest control and fault readings.  The benchmark's own runs never
run this; it is how PERF.md's limits were read.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _detail(answers, reference):
    """Each training part's losses, first gradient and change, both sides."""
    if not isinstance(reference, dict):
        return None
    out = {}
    for part, ref in reference.items():
        prog = answers[part]
        out[part] = {side: {"losses": [float(v) for v in d["losses"]], "grad1": [float(v) for v in d["grad1"]],
                            "change": [float(v) for v in d["change"]]} for side, d in (("program", prog), ("reference", ref))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--fault-seconds", type=float, default=None)
    ap.add_argument("--faults", default="", help="names of the faults to plant (default: all of the traffic's)")
    ap.add_argument("--witness-dtype", default="float32", choices=("float32", "float64"),
                    help="the witness's working dtype (TF32 off)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=None, help="a smaller n, for a rehearsal on the CPU")
    ap.add_argument("--problem", default="{}", help="GPProblem settings over the configuration's (JSON)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import faults, harness

    cell = harness.load_cell(args.workload, ROOT)
    if args.n:
        cell = cell._replace(config={**cell.config, "n": args.n})
    cell = cell._replace(config={**cell.config, "problem": {**cell.config["problem"], **json.loads(args.problem)}})
    dev = torch.device(args.device)
    seeds = {k: [int(s) for s in v.split(",") if s] for k, v in
             (("program", args.seeds), ("control", args.control_seeds), ("witness", args.witness_seeds),
              ("fault", args.fault_seeds))}
    readings = []

    def emit(kind, seed, nums, extra=None):
        row = {"kind": kind, "seed": seed, "numbers": nums, **(extra or {})}
        readings.append(row)
        print(json.dumps(row), flush=True)

    def program(inp, seed, seconds=args.seconds):
        return harness.run_program(cell, inp, seconds, False, dev, time.perf_counter(), seed)

    for seed in sorted(set(sum(seeds.values(), []))):
        inp = harness.make_inputs(cell, seed, dev)
        w = program(inp, seed)
        t = time.perf_counter()
        nums, reference = harness.numbers(cell, inp, seed, w.answers)
        if seed in seeds["program"]:
            emit("program", seed, nums, {"units": w.units, "window_s": w.window_s, "failed": w.failed,
                                         "setup_s": w.setup_s, "reference_s": time.perf_counter() - t,
                                         "claimed": w.answers.get("relres"),
                                         "counters": w.counters, "detail": _detail(w.answers, reference),
                                         "repaired": w.answers.get("repaired")})
        witness = harness.ref.Precision(getattr(torch, args.witness_dtype), False)
        for kind, prec in (("control", None), ("witness", witness)):
            if seed in seeds[kind]:
                other = harness.control_answers(cell, inp, seed, w.answers, prec)
                emit(kind, seed, harness.numbers(cell, inp, seed, other, reference)[0],
                     {"steps": other["steps"]} if "steps" in other else None)
        if seed in seeds["fault"]:
            for name, fault in faults.for_cell(cell).items():
                if args.faults and name not in args.faults.split(","):
                    continue
                with fault():
                    fw = program(inp, seed, args.fault_seconds if args.fault_seconds is not None else args.seconds)
                # the set-up's start is the program's; the window's is the fault's own;
                # a solve's reference is its operator, the same for every answer
                same = {"setup": reference["setup"]} if cell.traffic["kind"] == "train" else (
                    reference if cell.traffic["kind"] == "solve" else None)
                emit(f"fault:{name}", seed, harness.numbers(cell, inp, seed, fw.answers, same)[0],
                     {"units": fw.units, "failed": fw.failed})
        del inp
        harness._free(dev)

    summary = {}
    for row in readings:
        for k, v in row["numbers"].items():
            s = summary.setdefault(k, {})
            key = "lower" if row["kind"] == "program" else row["kind"]
            agg = max if key in ("lower", "witness") else min
            s[key] = v if key not in s else agg(s[key], v)
    print(json.dumps({"summary": summary, "workload": cell.name, "card": harness.card_label(dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
