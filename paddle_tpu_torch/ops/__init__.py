"""Op kernels of the port (importing registers them).

Only the op types of the ported slices (BERT serving and pretraining,
LeNet and ResNet training) are here so far; each sits in the file that
holds it in the JAX package's ``ops/``.
"""
from paddle_tpu_torch.ops import math_ops, metric_ops, nn_ops, optimizer_ops, tensor_ops  # noqa: F401
