"""Input layers (reference: python/paddle/fluid/layers/io.py — data:41)."""
from __future__ import annotations

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import types as core_types

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True, stop_gradient=True, **kwargs):
    """Declare an input variable (reference: layers/io.py:41).
    ``append_batch_size`` prepends -1.  A ragged input (``lod_level > 0``)
    is padded, with a companion ``<name>_seq_len`` int32 var of its
    lengths (what ``DataFeeder`` feeds), and for nested levels
    ``<name>_inner_len`` (level 1) and ``<name>_inner_len_<k>`` of shape
    [B, S1..Sk], as in the JAX package."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    var = block.create_var(
        name=name,
        shape=shape,
        dtype=core_types.canonical_dtype(dtype),
        stop_gradient=stop_gradient,
        is_data=True,
        lod_level=lod_level,
    )
    if lod_level > 0:
        block.create_var(name=name + "_seq_len", shape=[-1], dtype="int32",
                         stop_gradient=True, is_data=True)
    for level in range(1, lod_level):
        suffix = "_inner_len" if level == 1 else "_inner_len_%d" % level
        block.create_var(name=name + suffix, shape=[-1] * (level + 1), dtype="int32",
                         stop_gradient=True, is_data=True)
    return var
