"""reference: incubate/fleet/base/role_maker.py: the role makers of
``paddle_tpu_torch/parallel/fleet.py``."""
from paddle_tpu_torch.parallel.fleet import (  # noqa: F401
    MPISymetricRoleMaker,
    PaddleCloudRoleMaker,
    Role,
    RoleMakerBase,
    UserDefinedCollectiveRoleMaker,
    UserDefinedRoleMaker,
)

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker", "UserDefinedCollectiveRoleMaker",
           "MPISymetricRoleMaker"]
