"""Multi-process training: the ring registry over ``torch.distributed``
(``env``) and the collective program rewriters (``collective_transpiler``).

The port's counterpart of part of the JAX package's ``parallel/``; the
mesh, ``CompiledProgram``, fleet and the pipelined and hybrid programs are
not ported yet (ROADMAP A10).
"""
from paddle_tpu_torch.parallel import env  # noqa: F401
from paddle_tpu_torch.parallel import collective_transpiler  # noqa: F401
from paddle_tpu_torch.parallel.collective_transpiler import (  # noqa: F401
    Collective,
    GradAllReduce,
    LocalSGD,
)
