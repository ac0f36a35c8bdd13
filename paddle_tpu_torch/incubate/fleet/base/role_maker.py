"""incubate/fleet/base/role_maker.py."""

from ....parallel.fleet import (PaddleCloudRoleMaker,  # noqa: F401
                                UserDefinedRoleMaker)

Role = type("Role", (), {"WORKER": 1, "SERVER": 2})

__all__ = ["PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role"]
