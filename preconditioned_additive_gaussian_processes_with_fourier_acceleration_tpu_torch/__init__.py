"""NFFT4GP on PyTorch: GP training on NVIDIA GPUs.

A port of the JAX package
`preconditioned_additive_gaussian_processes_with_fourier_acceleration_tpu`,
which stays the reference.  Module paths mirror it one to one, so each
counterpart is found under the same name.  This package imports torch and
numpy only, never jax.

What is here: the kernel families with (f, l, mu) gradients and additive
windows, the dense operator, the folded-NDFT fastsum operator, full (one
to three features) or additive over windows of one to three features,
with the matern12 near-field (a KNN pattern, or on the stream engine every
pair within the pitch of a cell grid, `ops/cellgrid.py`; table engine in
torch; streamed-table and phase-regenerating engines on the hand-written
CUDA kernels of `ops/packed_ndft.py`), PCG, FGMRES, batched Lanczos/SLQ,
the dense small-n Krylov solves on the cooperative CUDA kernels of
`solvers/fused_pcg.py`, the Cholesky, Nystrom, FSAI and AFN
preconditioners (with FPS and the rank estimates of `ops/fps.py` and
`ops/rankest.py`), the marginal-likelihood loss with the reference's
estimator, Adam, prediction with std on the dense kernel or the fastsum
operator, `GPProblem.fit` and `.predict`, the exact one-vs-all multiclass
GP, the readers of the reference's text formats (`io/`), the TEST4
command-line program (`cli.py`), the row-sharded multi-device path
(`parallel/`), and the stage timers, profiler trace and debug dumps of
`utils/`.

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
    gaussian_kernel,
    matern32_kernel,
    matern12_kernel,
    kernel_matrix,
    kernel_matrix_with_grad,
    additive_kernel_matrix,
    additive_kernel_matrix_with_grad,
    make_windows,
)
from .solvers.pcg import pcg  # noqa: E402
from .solvers.fgmres import fgmres  # noqa: E402
from .solvers.lanczos import lanczos, slq_logdet  # noqa: E402
from .preconds.chol import CholPrecond, chol_setup  # noqa: E402
from .preconds.nystrom import NystromPrecond, nystrom_setup  # noqa: E402
from .preconds.fsai import FsaiPrecond, fsai_setup  # noqa: E402
from .preconds.afn import AfnPrecond, afn_setup  # noqa: E402
from .models.transforms import transform_forward, transform_inverse  # noqa: E402
from .models.gp import GPConfig, GPPredictResult, gp_loss, gp_predict, gp_predict_fastsum  # noqa: E402
from .models.adam import AdamState, adam_init, adam_step  # noqa: E402
from .models.problem import GPProblem  # noqa: E402
