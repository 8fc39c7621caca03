"""Spans around the calls into the port's layers, recorded from outside it.

`spans.json` names the callables: a module attribute of the port, or a
method of one of its classes ("Class.method"), wrapped in place for the
traced run and restored after, and, for a callable handed to it as an
argument, that argument's name.  A span waits for the device
before and after the call, so its host seconds hold the device work it
launched; the profiled stretch of a traced run therefore runs without
them.  A name the port no longer has is skipped: its metric then reads
nothing.

`spans.json`'s "solve" names the solver whose answers the check reads
(`captured`); `kept_breakdowns` keeps the rows that AFN's factorizations
repaired.
"""

import functools
import importlib
import inspect
import json
import time
from contextlib import contextmanager
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
PORT = "preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch"


class SpanLog:
    """Seconds and calls per span name."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds = {}
        self.calls = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            self.sync()
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sync()
                self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t
                self.calls[name] = self.calls.get(name, 0) + 1

        return spanned


def _owner(mod, attr: str):
    """(the object that holds `attr`'s last name, that name): the module, or
    a class of it for "Class.method"; None where the port lacks it."""
    *path, name = attr.split(".")
    owner = mod
    for part in path:
        owner = getattr(owner, part, None)
    return (None, name) if owner is None else (owner, name)


def _with_spanned_args(log, fn, args_spans):
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        for arg, span in args_spans.items():
            if bound.arguments.get(arg) is not None:
                bound.arguments[arg] = log.wrap(span, bound.arguments[arg])
        return fn(*bound.args, **bound.kwargs)

    return call


@contextmanager
def installed(log: SpanLog, spec_file: Path = HERE / "spans.json"):
    """Wrap the callables `spec_file` lists while the block runs."""
    spec = json.loads(spec_file.read_text())
    undo = []
    try:
        for entry in spec["wrap"]:
            owner, name = _owner(importlib.import_module(f"{PORT}.{entry['module']}"), entry["attr"])
            fn = getattr(owner, name, None)
            if fn is None:
                continue
            new = _with_spanned_args(log, fn, entry.get("args", {}))
            if entry.get("span"):
                new = log.wrap(entry["span"], new)
            setattr(owner, name, new)
            undo.append((owner, name, fn))
        yield log
    finally:
        for owner, name, fn in reversed(undo):
            setattr(owner, name, fn)


@contextmanager
def captured(holder: list, spec_file: Path = HERE / "spans.json"):
    """While the block runs, the first answer of the solver that
    `spec_file`'s "solve" names is put in holder[0] whenever holder[0] is
    None (the caller clears it at each step); a solver the port no longer
    has leaves it None."""
    spec = json.loads(spec_file.read_text())["solve"]
    mod = importlib.import_module(f"{PORT}.{spec['module']}")
    fn = getattr(mod, spec["attr"], None)
    if fn is None:
        yield holder
        return

    @functools.wraps(fn)
    def keep(*args, **kwargs):
        out = fn(*args, **kwargs)
        if holder[0] is None:
            holder[0] = getattr(out, spec["field"])
        return out

    setattr(mod, spec["attr"], keep)
    try:
        yield holder
    finally:
        setattr(mod, spec["attr"], fn)


@contextmanager
def kept_breakdowns(holder: list):
    """While the block runs, the count of Schur rows each AFN factorization
    of the loss closure repaired (a 0-d tensor, not read here) is appended
    to `holder`; a port without the factorization keeps nothing."""
    mod = importlib.import_module(f"{PORT}.models.problem")
    fn = getattr(mod, "afn_setup_from_plan", None)
    if fn is None:
        yield holder
        return

    @functools.wraps(fn)
    def keep(*args, **kwargs):
        pre = fn(*args, **kwargs)
        if hasattr(pre, "gs"):
            holder.append(pre.breakdown)
        return pre

    mod.afn_setup_from_plan = keep
    try:
        yield holder
    finally:
        mod.afn_setup_from_plan = fn
