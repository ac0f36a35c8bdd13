"""incubate/fleet/base/fleet_base.py: re-exports the Fleet facade
(``paddle_tpu_torch/parallel/fleet.py``)."""

from ....parallel.fleet import (DistributedStrategy, Fleet,  # noqa: F401
                                PaddleCloudRoleMaker, UserDefinedRoleMaker,
                                fleet)

__all__ = ["Fleet", "fleet", "DistributedStrategy", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]
