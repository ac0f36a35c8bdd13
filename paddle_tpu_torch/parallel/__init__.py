"""Parallelism on ``torch.distributed`` (parity: the JAX package's
``parallel/``): the data group and the meshes (``mesh.py``), the
collectives (``collective.py``), the planner (``planner.py``),
``ParallelExecutor``, the fleet's collective mode, and the SPMD
Transformer trainer (``transformer.py``: dp × pp × tp with sequence
parallelism, the 1F1B pipeline and the expert-parallel switch MoE).
The planner's tp walk, ZeRO-1 (``ReduceStrategy.Reduce``) and the Fluid
pipeline (``pipeline_program.py`` on ``pipeline_schedule.py``'s 1F1B
tables) run through ``CompiledProgram.with_data_parallel`` on the (dp,
pp, tp) mesh. ``zero.py``'s ShardedAdam runs the ZeRO ladder (stages
1-3, bucketed or a collective a leaf, comm/compute overlap,
host-offloaded state) over the data group. Ring attention, the
embedding stack and DGC wait for ROADMAP.md Queue 1 item 9."""

from . import transformer  # noqa: F401
from .fleet import (DistributedStrategy, Fleet,  # noqa: F401
                    PaddleCloudRoleMaker, UserDefinedRoleMaker, fleet)
from .mesh import SPMDMesh, get_mesh, mesh_axis_sizes  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from .transformer import SPMDTrainer  # noqa: F401
from .zero import ShardedAdam, ZeroLayoutError  # noqa: F401

__all__ = ["ParallelExecutor", "get_mesh", "mesh_axis_sizes", "fleet",
           "Fleet", "PaddleCloudRoleMaker", "UserDefinedRoleMaker",
           "DistributedStrategy", "SPMDMesh", "SPMDTrainer", "transformer",
           "ShardedAdam", "ZeroLayoutError"]
