"""Row-sharded multi-device training on torch.distributed (port of the JAX
package's parallel/): one process per device, NCCL on the card, gloo on
the CPU when asked."""

from . import mesh, sharded, training
from .mesh import PointsMesh, make_mesh, points_sharding, replicated_sharding, run_ranks
from .sharded import shard_plan, shard_points, sharded_dot, sharded_matvec_dense
from .training import make_sharded_train_step, shard_training_data, train_sharded
