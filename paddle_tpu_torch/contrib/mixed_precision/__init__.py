"""Automatic mixed precision.

Reference: python/paddle/fluid/contrib/mixed_precision/ — decorate()
(decorator.py:194) wraps the optimizer; rewrite_program casts the white
list's ops to a low precision type, with fp32 master weights.

As in the JAX package, the low precision type is **bfloat16**: it has
fp32's exponent range, so loss scaling is not needed (kept as API
surface, off by default).  The rewrite casts the inputs of the product
ops (the white list) to bf16; parameters and optimizer state stay fp32
(master weights by construction: the cast is part of the program, and
its gradient flows back through it in fp32).
"""
from paddle_tpu_torch.contrib.mixed_precision.decorator import (  # noqa: F401
    AutoMixedPrecisionLists,
    OptimizerWithMixedPrecision,
    bf16_guard,
    decorate,
    rewrite_program,
)
