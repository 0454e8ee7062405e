"""Incubating APIs (reference: python/paddle/fluid/incubate/)."""
from paddle_tpu_torch.incubate import data_generator  # noqa: F401
