"""Faults planted in the port for the check to catch.

Each fault is a context manager that breaks the timed path underneath the
harness and restores it on exit: `benchmark/control.py` reads what each
does to the compared numbers on the card, and
benchmark/tests/test_bench_faults.py sees `correct` come out false under
each.  `for_cell` gives a cell its traffic kind's faults and those of the
layers its configuration has (AFN, a near-field).  The cells run on one
chip, so the exchange between chips is not among them.
"""

from contextlib import contextmanager

import torch

from .harness import nearfield_lfil
from .spans import PORT


def _mod(name):
    import importlib

    return importlib.import_module(f"{PORT}.{name}")


@contextmanager
def _patched(mod, attr, new):
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    try:
        yield
    finally:
        setattr(mod, attr, old)


@contextmanager
def state_unchanged():
    """Adam's step returns its state as it was."""
    adam = _mod("models.adam")
    with _patched(adam, "adam_step", lambda state, grad, **kw: state):
        yield


@contextmanager
def half_batch_train():
    """The loss over the first half of the points only, its mean over them."""
    GP = _mod("models.problem").GPProblem
    orig = GP.make_loss

    def make_loss(self, X, y, params0=(1.0, 1.0, 0.1), *, probes=None, landmarks=None, **kw):
        h = X.shape[0] // 2
        return orig(self, X[:h], y[:h], params0, probes=None if probes is None else probes[:, :h], **kw)

    with _patched(GP, "make_loss", make_loss):
        yield


@contextmanager
def altered_loss():
    """Each step's loss is off by one part in a hundred where the loss
    closure produces it."""
    GP = _mod("models.problem").GPProblem
    orig = GP.make_loss

    def make_loss(self, *a, **kw):
        fn = orig(self, *a, **kw)

        def loss_fn(raw):
            loss, grad = fn(raw)
            return loss * 1.01, grad

        return loss_fn

    with _patched(GP, "make_loss", make_loss):
        yield


@contextmanager
def half_batch_predict():
    """The second half of each request's test points is left out (no mean)."""
    GP = _mod("models.problem").GPProblem
    orig = GP.predict

    def predict(self, X, y, X_test, **kw):
        h = X_test.shape[0] // 2
        mean = orig(self, X, y, X_test[:h], **kw)
        return torch.cat([mean, mean.new_zeros(X_test.shape[0] - h)])

    with _patched(GP, "predict", predict):
        yield


@contextmanager
def altered_mean():
    """One posterior mean of each request is altered where it is produced."""
    GP = _mod("models.problem").GPProblem
    orig = GP.predict

    def predict(self, *a, **kw):
        mean = orig(self, *a, **kw).clone()
        mean[0] += torch.max(torch.abs(mean))
        return mean

    with _patched(GP, "predict", predict):
        yield


def _pcg_patched(make):
    """`solvers.pcg.pcg` replaced by make(original) while the block runs."""
    mod = _mod("solvers.pcg")
    return _patched(mod, "pcg", make(mod.pcg))


@contextmanager
def half_iterations():
    """PCG stops after half the iterations it takes to reach tol."""
    def make(orig):
        def pcg(matvec, b, x0=None, **kw):
            full = orig(matvec, b, x0, **kw)
            return orig(matvec, b, x0, **{**kw, "maxits": max(1, full.niter // 2)})
        return pcg

    with _pcg_patched(make):
        yield


@contextmanager
def nearfield_dropped():
    """The operator is built without its near-field correction (nf lfil 0)."""
    fs = _mod("ops.fastsum")
    orig = fs.additive_nearfield_stencil_direct
    with _patched(fs, "additive_nearfield_stencil_direct",
                  lambda geom, kind, nearfield_lfil=None, **kw: orig(geom, kind, 0, **kw)):
        yield


@contextmanager
def half_batch_solve():
    """The second half of each right-hand side is left unsolved (taken as 0)."""
    def make(orig):
        def pcg(matvec, b, x0=None, **kw):
            kept = b.clone()
            kept[b.shape[0] // 2:] = 0.0
            return orig(matvec, kept, x0, **kw)
        return pcg

    with _pcg_patched(make):
        yield


@contextmanager
def altered_solution():
    """One entry of each answer x is altered where PCG produces it."""
    def make(orig):
        def pcg(*a, **kw):
            res = orig(*a, **kw)
            x = res.x.clone()
            x[0] += torch.max(torch.abs(x))
            return res._replace(x=x)
        return pcg

    with _pcg_patched(make):
        yield


@contextmanager
def afn_trace_dropped():
    """AFN's trace tr(M^-1 dM_j) reads 0."""
    Afn = _mod("preconds.afn").AfnPrecond
    with _patched(Afn, "trace", lambda self: torch.zeros(3, dtype=self.L11.dtype, device=self.L11.device)):
        yield


@contextmanager
def dvp_dropped():
    """AFN's dvp runs with the Schur FSAI's gradient values zeroed (its trace
    keeps them)."""
    Afn = _mod("preconds.afn").AfnPrecond
    orig = Afn.dvp

    def dvp(self, z):
        kept = self.gs.dval
        self.gs.dval = torch.zeros_like(kept)
        try:
            return orig(self, z)
        finally:
            self.gs.dval = kept

    with _patched(Afn, "dvp", dvp):
        yield


@contextmanager
def nearfield_grad_dropped():
    """The radius near-field's dK/dl values are zero (its K values kept)."""
    fs = _mod("ops.fastsum")
    orig = fs._nf_direct_values

    def values(*a, **kw):
        entry = orig(*a, **kw)
        return entry if entry.A_l is None else entry._replace(A_l=torch.zeros_like(entry.A_l))

    with _patched(fs, "_nf_direct_values", values):
        yield


FAULTS = {
    "train": {"state_unchanged": state_unchanged, "half_batch": half_batch_train, "altered_answer": altered_loss},
    "predict": {"half_batch": half_batch_predict, "altered_answer": altered_mean},
    "solve": {"half_iterations": half_iterations, "nearfield_dropped": nearfield_dropped,
              "half_batch": half_batch_solve, "altered_answer": altered_solution},
}

AFN_FAULTS = {"afn_trace_dropped": afn_trace_dropped, "dvp_dropped": dvp_dropped}
NEARFIELD_FAULTS = {"nearfield_dropped": nearfield_dropped, "nearfield_grad_dropped": nearfield_grad_dropped}


def for_cell(cell) -> dict:
    """The faults a cell can have: its traffic kind's, AFN's where a training
    configuration states AFN, the near-field's where it states one."""
    out = dict(FAULTS[cell.traffic["kind"]])
    p = cell.config["problem"]
    if cell.traffic["kind"] == "train":
        if p.get("precond") == "afn":
            out.update(AFN_FAULTS)
        if nearfield_lfil(p) > 0:
            out.update(NEARFIELD_FAULTS)
    return out
