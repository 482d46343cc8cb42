"""Multi-GPU compute plane: meshes of device positions and the sharded
EC pipelines over them.

The port's counterpart of ``seaweedfs_tpu/parallel``. The reference
scales over a ``jax.sharding.Mesh`` of chips with XLA collectives; here
one process drives every position of a :class:`~.mesh.Mesh`, each on a
CUDA stream of its own. Volume batches are the data-parallel axis, shard
byte columns the sequence axis, and parity aggregation adds bit-plane
partial sums across a stripe axis.
"""

from .mesh import make_mesh  # noqa: F401
from .ec_sharded import (  # noqa: F401
    encode_batch_parity,
    encode_sharded,
    encode_stripe_psum,
    sharded_ec_step,
)
