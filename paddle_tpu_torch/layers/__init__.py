"""fluid-style layers namespace (reference: python/paddle/fluid/layers/):
the tensor, nn and io layers, the layers the optimizers, clips and
learning-rate schedules call, the control-flow and recurrent layers, and
the sequence and beam layers."""
from paddle_tpu_torch.layers import (  # noqa: F401
    control_flow, extended, io, learning_rate_scheduler, nn, ops, rnn, tensor)
from paddle_tpu_torch.layers.control_flow import *  # noqa: F401,F403
from paddle_tpu_torch.layers.extended import *  # noqa: F401,F403
from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.learning_rate_scheduler import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.ops import *  # noqa: F401,F403
from paddle_tpu_torch.layers.rnn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
