"""Multi-process execution: the ring registry over ``torch.distributed``
(``env``), device meshes (``mesh``: one rank a mesh device), the strategies,
``CompiledProgram`` (data-, FSDP- and tensor-parallel steps over a mesh)
and the collective program rewriters (``collective_transpiler``).

The port's counterpart of the JAX package's ``parallel/``, with ring
attention (the module ``ring_attention``, as the JAX package exports it:
sequence-parallel exact attention over a group of ranks); the hybrid
engine and fleet (ROADMAP A10 part 2 item 4) and the pipelined programs
(part 3) are not ported yet.
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
