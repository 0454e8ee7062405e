"""Multi-process execution: the ring registry over ``torch.distributed``
(``env``), device meshes (``mesh``: one rank a mesh device, with
differentiable collectives), the strategies, ``CompiledProgram`` (data-,
FSDP- and tensor-parallel steps over a mesh), the collective program
rewriters (``collective_transpiler``), fleet (``fleet_mod``; ``fleet`` is
its singleton, as the JAX package exports it), the 5D hybrid engine
(``hybrid``) and ring attention (the module ``ring_attention``:
sequence-parallel exact attention over a group of ranks, differentiable).

The port's counterpart of the JAX package's ``parallel/``; the pipelined
programs (ROADMAP A10 part 3) are not ported yet.
"""
from paddle_tpu_torch.parallel import env  # noqa: F401
from paddle_tpu_torch.parallel import mesh  # noqa: F401
from paddle_tpu_torch.parallel.mesh import MeshGuard, data_parallel_mesh, make_mesh  # noqa: F401
from paddle_tpu_torch.parallel.strategy import (  # noqa: F401
    BuildStrategy,
    DistributedStrategy,
    ExecutionStrategy,
)
from paddle_tpu_torch.parallel.compiled_program import CompiledProgram  # noqa: F401
from paddle_tpu_torch.parallel import ring_attention  # noqa: F401
from paddle_tpu_torch.parallel import collective_transpiler  # noqa: F401
from paddle_tpu_torch.parallel.collective_transpiler import (  # noqa: F401
    Collective,
    GradAllReduce,
    LocalSGD,
)
from paddle_tpu_torch.parallel import fleet as fleet_mod  # noqa: F401
from paddle_tpu_torch.parallel.fleet import fleet  # noqa: F401
from paddle_tpu_torch.parallel import hybrid  # noqa: F401
