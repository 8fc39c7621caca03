"""NFFT4GP on PyTorch: the additive-fastsum GP training step for NVIDIA GPUs.

A port of the JAX package
`preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu`,
which stays the reference.  Module paths mirror it one to one, so each
counterpart is found under the same name.  This package imports torch and
numpy only, never jax.

What is here: the kernel families with (f, l, mu) gradients and additive
windows, the dense operator, the folded-NDFT fastsum operator for windows
of one or two features (table engine in torch, streamed engine on the two
hand-written CUDA kernels of `ops/packed_ndft.py`), FGMRES, batched
Lanczos/SLQ, the Nystrom preconditioner, the marginal-likelihood loss with
the reference's estimator, Adam and `GPProblem.fit`.

Float32 products run in full float32: TF32 is switched off here.  This is
the counterpart of the JAX package's `precision="highest"` products; the
Nystrom solve amplifies projector error by 1/eta (preconds/nystrom.py).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from . import utils, ops, solvers, preconds, models  # noqa: E402

__version__ = "0.1.0"

from .ops.kernels import (  # noqa: E402
    KernelParams,
    kernel_matrix,
    kernel_matrix_with_grad,
    additive_kernel_matrix,
    additive_kernel_matrix_with_grad,
    make_windows,
)
from .solvers.fgmres import fgmres  # noqa: E402
from .solvers.lanczos import lanczos, slq_logdet  # noqa: E402
from .preconds.nystrom import NystromPrecond, nystrom_setup  # noqa: E402
from .models.transforms import transform_forward, transform_inverse  # noqa: E402
from .models.gp import GPConfig, gp_loss  # noqa: E402
from .models.adam import AdamState, adam_init, adam_step  # noqa: E402
from .models.problem import GPProblem  # noqa: E402
