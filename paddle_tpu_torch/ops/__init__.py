"""Op kernels of the port (importing registers them).

Only the op types of the ported slices are here so far; each sits in
the file that holds it in the JAX package's ``ops/``.
"""
from paddle_tpu_torch.ops import (  # noqa: F401
    collective_ops,
    control_flow_ops,
    math_ops,
    metric_ops,
    nn_ops,
    optimizer_ops,
    rnn_ops,
    sequence_ops,
    tensor_ops,
)
from paddle_tpu_torch.ops import extended_ops  # noqa: F401,E402  (last: its aliases name the others)
