"""Faults planted in the port for the check to catch.

Each fault is a context manager that breaks the timed path underneath the
harness and restores it on exit: `benchmark/control.py` reads what each
does to the compared numbers on the card, and
benchmark/tests/test_bench_faults.py sees `correct` come out false under
each.  The cells run on one chip, so the exchange between chips is not
among them.
"""

from contextlib import contextmanager

import torch

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


FAULTS = {
    "train": {"state_unchanged": state_unchanged, "half_batch": half_batch_train, "altered_answer": altered_loss},
    "predict": {"half_batch": half_batch_predict, "altered_answer": altered_mean},
}
