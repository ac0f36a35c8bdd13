"""Data parallelism on ``torch.distributed`` (parity: the data-parallel
core of the JAX package's ``parallel/``): the data group and mesh
(``mesh.py``), the collectives (``collective.py``), the planner
(``planner.py``), ``ParallelExecutor`` and the fleet's collective mode.
Tensor, pipeline and sequence parallelism, ZeRO, ring attention, the
embedding stack and DGC wait for ROADMAP.md Queue 1 item 9."""

from .fleet import (DistributedStrategy, Fleet,  # noqa: F401
                    PaddleCloudRoleMaker, UserDefinedRoleMaker, fleet)
from .mesh import get_mesh, mesh_axis_sizes  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401

__all__ = ["ParallelExecutor", "get_mesh", "mesh_axis_sizes", "fleet",
           "Fleet", "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
           "DistributedStrategy"]
