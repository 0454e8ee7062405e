"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py):
parameters and constants, casts and shape ops, ``scale``, ``sums``,
``reduce_sum``, the elementwise family, comparisons, logical ops,
``where``, ``concat``, ``expand``, ``assign`` and ``argmax``, as the JAX
package's ``layers/tensor.py`` builds them."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["create_parameter", "create_global_var", "cast", "sums", "fill_constant", "reshape",
           "transpose", "slice", "gather", "scale", "reduce_sum", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_pow", "equal", "not_equal", "less_than", "less_equal",
           "greater_than", "greater_equal", "logical_and", "logical_or", "logical_not", "where",
           "range", "concat", "assign", "fill_constant_batch_size_like", "zeros", "expand",
           "argmax"]


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


def cast(x, dtype):
    dtype = core_types.canonical_dtype(dtype)
    return _helper_out("cast", {"X": [x]}, {"in_dtype": x.dtype, "out_dtype": dtype}, dtype=dtype)


def sums(input, out=None):
    helper = LayerHelper("sum")
    out = out or helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sum", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def concat(input, axis=0, name=None):
    return _helper_out("concat", {"X": list(input)}, {"axis": axis}, dtype=input[0].dtype)


def assign(input, output=None):
    """``input`` (a Variable, or a numpy array as an ``assign_value``
    constant) into ``output`` or a new var."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        out = output or helper.create_variable_for_type_inference(str(input.dtype))
        helper.append_op(
            type="assign_value",
            outputs={"Out": [out]},
            attrs={"shape": list(input.shape), "dtype": str(input.dtype),
                   "values": input.flatten().tolist()},
        )
        return out
    out = output or helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    dtype = core_types.canonical_dtype(dtype)
    out = out or helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0):
    dtype = core_types.canonical_dtype(dtype)
    return _helper_out(
        "fill_constant_batch_size_like",
        {"Input": [input]},
        {
            "shape": list(shape),
            "dtype": dtype,
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
        dtype=dtype,
        stop_gradient=True,
    )


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


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


def expand(x, expand_times, name=None):
    return _helper_out("expand", {"X": [x]}, {"expand_times": expand_times}, dtype=x.dtype)


def slice(input, axes, starts, ends):
    return _helper_out(
        "slice", {"Input": [input]}, {"axes": axes, "starts": starts, "ends": ends}, dtype=input.dtype
    )


def gather(input, index):
    return _helper_out("gather", {"X": [input], "Index": [index]}, dtype=input.dtype)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def _reduce(op_type, input, dim, keep_dim, name=None):
    attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
    if dim is not None:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    else:
        attrs["dim"] = [0]
    return _helper_out(op_type, {"X": [input]}, attrs, dtype=input.dtype)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    cond = cond or helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond


def equal(x, y, cond=None):
    return _compare("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _compare("not_equal", x, y, cond)


def less_than(x, y, cond=None, force_cpu=None):
    return _compare("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _compare("greater_equal", x, y, cond)


def logical_and(x, y, out=None, name=None):
    return _compare("logical_and", x, y, out)


def logical_or(x, y, out=None, name=None):
    return _compare("logical_or", x, y, out)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not")
    out = out or helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op(type="logical_not", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def where(condition, x, y):
    return _helper_out("where", {"Condition": [condition], "X": [x], "Y": [y]}, dtype=x.dtype)


def range(start, end, step, dtype):
    dtype = core_types.canonical_dtype(dtype)
    helper = LayerHelper("range")
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="range", inputs={}, outputs={"Out": [out]},
        attrs={"start": float(start), "end": float(end), "step": float(step), "dtype": dtype},
    )
    return out



def argmax(x, axis=0):
    return _helper_out("arg_max", {"X": [x]}, {"axis": axis}, dtype="int64", stop_gradient=True)
