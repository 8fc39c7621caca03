"""Adam for the 3-parameter GP problem (port of models/adam.py).

Bias-corrected Adam (beta1=.9, beta2=.999, eps=1e-8; ref SRC/optimizer/adam.c),
stopping on ||grad|| < tol.  The loss callable returns (loss, grad): the
analytic GP gradient, not autodiff.
"""

from typing import Callable, NamedTuple

import torch

from ..utils.timers import host_read, span


class AdamState(NamedTuple):
    x: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    t: int  # iteration count


def adam_init(x0) -> AdamState:
    x0 = torch.as_tensor(x0)
    return AdamState(x=x0, m=torch.zeros_like(x0), v=torch.zeros_like(x0), t=0)


def adam_step(state: AdamState, grad, *, alpha=0.01, beta1=0.9, beta2=0.999, eps=1e-8):
    """One Adam update given the gradient at state.x (ref adam.c:122-160)."""
    t = state.t + 1
    m = beta1 * state.m + (1.0 - beta1) * grad
    v = beta2 * state.v + (1.0 - beta2) * grad * grad
    m_hat = m / (1.0 - beta1**t)
    v_hat = v / (1.0 - beta2**t)
    x = state.x - alpha * m_hat / (torch.sqrt(v_hat) + eps)
    return AdamState(x=x, m=m, v=v, t=t)


def adam_run(loss_fn: Callable, x0, *, maxits: int = 100, tol: float = 1e-6,
             alpha: float = 0.01, beta1: float = 0.9, beta2: float = 0.999,
             eps: float = 1e-8, callback: Callable = None, state0: AdamState = None):
    """Adam loop.  Returns (final_state, loss_history, x_history, grad_history).
    Each iteration is a `step` span (utils/timers.py), `step` its Adam count."""
    state = adam_init(x0) if state0 is None else state0
    losses, xs, grads = [], [state.x], []
    for it in range(maxits):
        with span("step", step=state.t + 1):
            loss, grad = loss_fn(state.x)
            losses.append(loss)
            grads.append(grad)
            state = adam_step(state, grad, alpha=alpha, beta1=beta1, beta2=beta2, eps=eps)
            xs.append(state.x)
            if callback is not None:
                callback(it, state, loss, grad)
            if host_read(torch.linalg.norm(grad), float) < tol:
                break
    return state, losses, xs, grads
