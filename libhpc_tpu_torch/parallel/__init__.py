"""The distributed layer: port of ``libhpc_tpu/parallel/`` onto
``torch.distributed``, one process (rank) a device.

The reference runs one controller and ``jax.shard_map`` bodies over
sharded global arrays. Here every rank runs the same body on its own shard:
containers are built whole on every rank (``DistX.from_scipy``), each rank
keeps its slice (``.shard(mesh)``), and a ``dist_*_fn`` returns a callable
from this rank's shard of x to this rank's shard of y. NCCL carries the
collectives on the card, gloo on the CPU; ``mesh.RankPool`` and
``mesh.launch`` start gloo ranks on one host for tests and examples.
"""

from libhpc_tpu_torch.parallel.mesh import make_mesh_1d, make_mesh_2d  # noqa: F401
