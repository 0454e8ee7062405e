"""Model builders of the port (reference: the JAX package's models/)."""
from paddle_tpu_torch.models import transformer  # noqa: F401
