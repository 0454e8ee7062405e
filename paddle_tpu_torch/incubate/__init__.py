"""Incubating APIs (reference: python/paddle/fluid/incubate/): the data
generator, and fleet's import paths (``incubate.fleet``)."""
from paddle_tpu_torch.incubate import data_generator  # noqa: F401
from paddle_tpu_torch.incubate import fleet  # noqa: F401
