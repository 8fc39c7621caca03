"""The numbers that decide `correct`, each held against its limit.

Training, for two runs of `check_steps` steps each: the first steps of the
set-up, from the configuration's start, and the first steps of the window,
from the program's own Adam state before them (the window's numbers carry
the prefix `w_`).  For each: the loss of the first step, the gradient of
the first step as Adam got it (worked out from its first moment before and
after that step) and the change of the hyperparameters over the steps, the
program's against the reference's from the same state; and `solve_res`,
the residual ||y - K x|| / ||y|| of the program's FGMRES answer x of its
first step on the reference's operator, which every point's row enters.
Each hyperparameter (f, l, mu) is a leaf; a leaf's gap is the gap between
the two sides' magnitudes over the reference's magnitude of that leaf or of
the median leaf, whichever is larger.  The gradient's number is its worst
leaf.  The loss is the first step's: a leaf whose gradient lies near zero
may take its next Adam step with the other sign on one side, and the later
steps' losses then part by that step (PERF.md gives both readings).  The change's is its median leaf: the lengthscale's gradient lies
within a few thousandths of the others' at the start, so float32 rounding
flips the sign of its Adam steps on some seeds and its own change is noise
(PERF.md gives both readings).  Leaves whose reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change.  With AFN, `plan_bad` (limit 0) is 1 where the program's plan is
not the configuration's AFN plan (benchmark/reference/afn_reference.py
`plan_faults`), and the reference, which follows that plan's structure,
is then not run: every other number is missing and fails.

Prediction: per compared request the largest gap of a posterior mean over
the reference's largest mean, the worst request counting.

Solve: per compared request the residual of the program's answer x to its
right-hand side b on the reference's operator (`solve_res`, ||b - A x|| /
||b||: every point's row and the near-field enter it), the worst request
counting.  Beside it `exact_res`, the same on the dense kernel K, which the
readings of benchmark/control.py report and no limit holds: the control
moves it by a fifth, and K lies farther from A than any sound answer does
from A's solution (PERF.md).

The limits of a cell are benchmark/limits/<cell>.json; PERF.md gives the
readings each was set from.
"""

import math

import torch


def _leaf_gaps(p, r, keep=None):
    p = torch.as_tensor(p, dtype=torch.float64).abs().cpu()
    r = torch.as_tensor(r, dtype=torch.float64).abs().cpu()
    floor = torch.maximum(r, torch.median(r))
    gaps = (p - r).abs() / torch.clamp(floor, min=1e-300)
    return gaps if keep is None else gaps[keep]


def train_numbers(prog: dict, ref: dict, prefix: str = "") -> dict:
    """prog / ref: {'losses': [...], 'grad1': (3,), 'change': (3,)}."""
    lp = torch.tensor(prog["losses"], dtype=torch.float64)
    lr = torch.tensor(ref["losses"], dtype=torch.float64)
    loss_gap = float((lp[0] - lr[0]).abs() / lr[0].abs())
    g = torch.as_tensor(ref["grad1"], dtype=torch.float64).abs().cpu()
    moving = g >= 1e-3 * torch.median(g)
    change = _leaf_gaps(prog["change"], ref["change"], moving)
    return {
        prefix + "loss_gap": loss_gap,
        prefix + "grad_gap": float(torch.max(_leaf_gaps(prog["grad1"], ref["grad1"]))),
        prefix + "change_gap": float(torch.quantile(change, 0.5)) if change.numel() else 0.0,
    }


def predict_numbers(prog_means, ref_means) -> dict:
    worst = 0.0
    for p, r in zip(prog_means, ref_means):
        p = p.to(torch.float64).cpu()
        r = r.to(torch.float64).cpu()
        worst = max(worst, float(torch.max((p - r).abs()) / torch.max(r.abs())))
    return {"mean_gap": worst}


def solve_numbers(on_operator, on_kernel) -> dict:
    """The worst compared request's residuals on the operator and on the
    dense kernel."""
    return {"solve_res": max(on_operator), "exact_res": max(on_kernel)}


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {value, limit}}) over the numbers the limits name; a
    number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
