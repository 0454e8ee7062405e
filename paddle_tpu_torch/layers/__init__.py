"""fluid-style layers namespace (reference: python/paddle/fluid/layers/),
the layers ``models/transformer.py`` ``bert_encoder`` calls."""
from paddle_tpu_torch.layers import io, nn, tensor  # noqa: F401
from paddle_tpu_torch.layers.io import *  # noqa: F401,F403
from paddle_tpu_torch.layers.nn import *  # noqa: F401,F403
from paddle_tpu_torch.layers.tensor import *  # noqa: F401,F403
