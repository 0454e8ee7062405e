"""reference: incubate/fleet/parameter_server/distribute_transpiler/: the
parameter-server face of the same fleet singleton; the programs come from
``DistributeTranspiler`` (``paddle_tpu_torch/transpiler.py``) and the host
parameter server (``paddle_tpu_torch/distributed/ps.py``)."""
from paddle_tpu_torch.parallel.fleet import (  # noqa: F401
    DistributedOptimizer,
    Fleet,
    fleet,
)
from paddle_tpu_torch.transpiler import (  # noqa: F401
    DistributeTranspiler,
    DistributeTranspilerConfig,
)

__all__ = ["fleet", "Fleet", "DistributedOptimizer",
           "DistributeTranspiler", "DistributeTranspilerConfig"]
