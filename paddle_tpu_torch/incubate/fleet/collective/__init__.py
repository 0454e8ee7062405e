"""reference: incubate/fleet/collective/__init__.py: the collective fleet,
whose ``minimize`` returns a CompiledProgram over a mesh of the world's
ranks (``paddle_tpu_torch/parallel/fleet.py``)."""
from paddle_tpu_torch.parallel.fleet import (  # noqa: F401
    DistributedOptimizer,
    Fleet,
    fleet,
)
from paddle_tpu_torch.parallel.strategy import DistributedStrategy  # noqa: F401

__all__ = ["fleet", "Fleet", "DistributedOptimizer", "DistributedStrategy"]
