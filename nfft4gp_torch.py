"""Short-name alias for the PyTorch package."""

import sys

import preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu_torch as _pkg

sys.modules[__name__] = _pkg
