"""Hyperparameter transforms (port of models/transforms.py).

Softplus (threshold 20), sigmoid, exp and identity (ref
SRC/optimizer/transform.c:4-89).  Forward returns (value, derivative) for
the chain rule in the loss; inverse maps a constrained value to raw space.
"""

import torch

_SOFTPLUS_HI = 20.0
_SOFTPLUS_LO = -20.0


def _softplus_fwd(x):
    xc = torch.clamp(x, _SOFTPLUS_LO, _SOFTPLUS_HI)
    mid = torch.log1p(torch.exp(xc))
    val = torch.where(x > _SOFTPLUS_HI, x, torch.where(x < _SOFTPLUS_LO, torch.exp(x), mid))
    sig = 1.0 / (1.0 + torch.exp(-xc))
    one = torch.ones_like(x)
    dval = torch.where(x > _SOFTPLUS_HI, one, torch.where(x < _SOFTPLUS_LO, torch.exp(x), sig))
    return val, dval


def _softplus_inv(v):
    small = 2.06115362243856e-09   # exp(-20), ref transform.c:44-53
    mid = torch.log(torch.expm1(torch.clamp(v, min=small)))
    return torch.where(v > _SOFTPLUS_HI, v, torch.where(v < small, torch.log(v), mid))


def _sigmoid_fwd(x):
    s = 1.0 / (1.0 + torch.exp(-x))
    return s, s * (1.0 - s)


def _exp_fwd(x):
    e = torch.exp(x)
    return e, e


_FWD = {
    "softplus": _softplus_fwd,
    "sigmoid": _sigmoid_fwd,
    "exp": _exp_fwd,
    "identity": lambda x: (x, torch.ones_like(x)),
}
_INV = {
    "softplus": _softplus_inv,
    "sigmoid": lambda v: torch.log(v / (1.0 - v)),
    "exp": torch.log,
    "identity": lambda v: v,
}


def transform_forward(kind: str, x):
    """(transformed value, d transformed / d raw), elementwise."""
    return _FWD[kind](torch.as_tensor(x))


def transform_inverse(kind: str, v):
    return _INV[kind](torch.as_tensor(v))
