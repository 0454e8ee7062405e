"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py):
reshape, transpose and range, as the JAX package's ``layers/tensor.py`` builds
them."""
from __future__ import annotations

from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["reshape", "transpose", "range"]


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="reshape2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"shape": list(shape)},
    )
    if act:
        helper.kwargs["act"] = act
        return helper.append_activation(out)
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="transpose2",
        inputs={"X": [x]},
        outputs={"Out": [out], "XShape": [xshape]},
        attrs={"axis": list(perm)},
    )
    return out


def range(start, end, step, dtype):
    dtype = core_types.canonical_dtype(dtype)
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="range", inputs={}, outputs={"Out": [out]},
        attrs={"start": float(start), "end": float(end), "step": float(step), "dtype": dtype},
    )
    return out
