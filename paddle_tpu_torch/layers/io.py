"""Input layers (reference: python/paddle/fluid/layers/io.py — data:41)."""
from __future__ import annotations

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import types as core_types

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True, stop_gradient=True, **kwargs):
    """Declare an input variable (reference: layers/io.py:41).
    ``append_batch_size`` prepends -1.  Ragged (``lod_level > 0``)
    inputs come with a later slice of the port."""
    if lod_level:
        raise NotImplementedError("lod_level > 0 inputs are not ported yet")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    return block.create_var(
        name=name,
        shape=shape,
        dtype=core_types.canonical_dtype(dtype),
        stop_gradient=stop_gradient,
        is_data=True,
        lod_level=lod_level,
    )
