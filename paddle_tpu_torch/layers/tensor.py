"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py):
create_parameter, create_global_var, reshape, transpose, slice, gather
and range, as the JAX package's ``layers/tensor.py`` builds them."""
from __future__ import annotations

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "reshape", "transpose", "slice", "gather",
           "range"]


def _helper_out(op_type, inputs, attrs=None, dtype="float32", out_slot="Out", stop_gradient=False):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=stop_gradient)
    helper.append_op(type=op_type, inputs=inputs, outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """reference: layers/tensor.py create_parameter — a raw trainable
    parameter outside any layer."""
    helper = LayerHelper("create_parameter")
    attr = attr or ParamAttr(name=name)
    if default_initializer is None:
        default_initializer = initializer.Constant(0.0) if is_bias else initializer.Xavier()
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """A global-block var filled with ``value`` by the startup program
    (the optimizer's learning rate is one)."""
    helper = LayerHelper("global_var")
    name = name or unique_name.generate("global_var")
    block = framework.default_main_program().global_block()
    var = block.create_var(
        name=name, shape=shape, dtype=core_types.canonical_dtype(dtype), persistable=persistable,
        stop_gradient=True,
    )
    helper.set_variable_initializer(var, initializer.Constant(value))
    return var


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


def slice(input, axes, starts, ends):
    return _helper_out(
        "slice", {"Input": [input]}, {"axes": axes, "starts": starts, "ends": ends}, dtype=input.dtype
    )


def gather(input, index):
    return _helper_out("gather", {"X": [input], "Index": [index]}, dtype=input.dtype)


def range(start, end, step, dtype):
    dtype = core_types.canonical_dtype(dtype)
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="range", inputs={}, outputs={"Out": [out]},
        attrs={"start": float(start), "end": float(end), "step": float(step), "dtype": dtype},
    )
    return out
