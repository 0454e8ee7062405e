"""Contrib namespace (reference: python/paddle/fluid/contrib/).  Ported
so far: ``mixed_precision`` (bf16 AMP)."""
from paddle_tpu_torch.contrib import mixed_precision  # noqa: F401
