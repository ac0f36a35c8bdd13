"""incubate/fleet/collective: the collective (nccl2-mode) fleet over the
port's data group."""

from ....parallel.fleet import (CollectiveOptimizer, DistributedStrategy,
                                fleet)

__all__ = ["fleet", "CollectiveOptimizer", "DistributedStrategy"]
