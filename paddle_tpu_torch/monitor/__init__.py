"""Process metrics (the port's subset of the JAX package's ``monitor/``):
the registry the reader's stall counters count into."""
from paddle_tpu_torch.monitor.registry import REGISTRY, Counter, MetricsRegistry  # noqa: F401
