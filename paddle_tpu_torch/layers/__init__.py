"""fluid-style layers namespace (reference: python/paddle/fluid/layers/):
the layers the ported model builders, optimizers, clips and learning-rate
schedules call."""
from paddle_tpu_torch.layers import io, learning_rate_scheduler, nn, ops, tensor  # noqa: F401
from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.learning_rate_scheduler import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.ops import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
