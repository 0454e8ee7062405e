"""Op kernels of the port (importing registers them).

Only the op types the BERT serving slice runs are here so far; each
sits in the file that holds it in the JAX package's ``ops/``.
"""
from paddle_tpu_torch.ops import math_ops, nn_ops, tensor_ops  # noqa: F401
