"""Rank meshes and distributed solvers (port of ``libwave_tpu.parallel``).

The JAX package expresses parallelism over a ``jax.sharding.Mesh``; the
port over a ``torch.distributed`` process group, one process per rank:

- ``dp`` axis: observation and factor banks sharded across ranks;
- ``tp`` axis: the map state's axis (the one-step distributed LM holds
  one chunk of landmark rows per ``tp`` rank);
- collectives (psum for normal-equation reductions, all_gather for pose
  blocks, ppermute for pose-graph halos) are explicit calls on a mesh
  :class:`~libwave_tpu_torch.parallel.mesh.Axis`, over NCCL between cards
  or gloo (the CPU, or several ranks on one card).
"""

from libwave_tpu_torch.parallel.mesh import make_mesh, MeshConfig  # noqa: F401
from libwave_tpu_torch.parallel.dist_ba import (  # noqa: F401
    shard_ba_problem,
    distributed_lm_step,
    gather_landmarks,
    partition_ba_problem,
    solve_ba_sharded,
)
from libwave_tpu_torch.parallel.dist_vio import (  # noqa: F401
    partition_vio_problem,
    solve_vio_sharded,
)
from libwave_tpu_torch.parallel.multihost import (  # noqa: F401
    MultiHostConfig,
    initialize_multihost,
    make_host_mesh,
    flatten_mesh,
    host_block_range,
    solve_ba_multihost,
)
from libwave_tpu_torch.parallel.dist_pose_graph import (  # noqa: F401
    BlockPoseGraph,
    partition_pose_graph,
    solve_pose_graph_blocks,
    unpartition,
)
