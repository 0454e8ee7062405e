"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py):
parameters and constants, casts and shape ops, ``scale``, ``sums``, the
reductions, the elementwise family, comparisons, logical ops, ``where``,
``concat`` / ``split`` / ``stack``, ``expand``, ``assign``, the arg and
sort ops, ``scatter``, ``shape``, ``cumsum``, ``isfinite`` and ``pow``,
as the JAX package's ``layers/tensor.py`` builds them."""
from __future__ import annotations

import builtins

import numpy as np

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["create_parameter", "create_tensor", "create_global_var", "cast", "concat", "split",
           "sums", "assign", "fill_constant", "fill_constant_batch_size_like", "ones", "zeros",
           "ones_like", "zeros_like", "reshape", "transpose", "squeeze", "unsqueeze", "flatten",
           "stack", "unstack", "expand", "slice", "scale", "increment_const", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "elementwise_add",
           "elementwise_sub", "elementwise_mul", "elementwise_div", "elementwise_max",
           "elementwise_min", "elementwise_pow", "equal", "not_equal", "less_than", "less_equal",
           "greater_than", "greater_equal", "logical_and", "logical_or", "logical_not", "where",
           "range", "gather", "argmax", "argmin", "argsort", "scatter", "shape", "cumsum",
           "isfinite", "pow"]


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


def create_tensor(dtype, name=None, persistable=False):
    block = framework.default_main_program().current_block()
    return block.create_var(name=name or unique_name.generate("create_tensor"),
                            dtype=core_types.canonical_dtype(dtype), persistable=persistable)


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


def split(input, num_or_sections, dim=-1, name=None):
    """``num_or_sections`` equal parts (an int) or parts of those sizes
    along ``dim``."""
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else len(input.shape) + dim
    if isinstance(num_or_sections, int):
        attrs = {"num": num_or_sections, "axis": dim, "sections": []}
        n_out = num_or_sections
    else:
        attrs = {"num": 0, "axis": dim, "sections": list(num_or_sections)}
        n_out = len(num_or_sections)
    outs = [helper.create_variable_for_type_inference(input.dtype) for _ in builtins.range(n_out)]
    helper.append_op(type="split", inputs={"X": [input]}, outputs={"Out": outs}, attrs=attrs)
    return outs


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


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros_like(x, out=None):
    helper = LayerHelper("fill_zeros_like")
    out = out or helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def ones_like(x, out=None):
    return fill_constant_batch_size_like(x, list(x.shape), x.dtype, 1.0)


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


def _with_xshape(op_type, x, attrs, name=None):
    """An op with the reference's XShape companion output."""
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    xshape = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out], "XShape": [xshape]},
                     attrs=attrs)
    return out


def transpose(x, perm, name=None):
    return _with_xshape("transpose2", x, {"axis": list(perm)}, name)


def squeeze(input, axes, name=None):
    return _with_xshape("squeeze2", input, {"axes": axes}, name)


def unsqueeze(input, axes, name=None):
    return _with_xshape("unsqueeze2", input, {"axes": axes}, name)


def flatten(x, axis=1, name=None):
    return _with_xshape("flatten2", x, {"axis": axis}, name)


def stack(x, axis=0):
    return _helper_out("stack", {"X": list(x)}, {"axis": axis}, dtype=x[0].dtype, out_slot="Y")


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype) for _ in builtins.range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


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


def increment_const(x, value):
    return scale(x, scale=1.0, bias=float(value))


def _reduce(op_type, input, dim, keep_dim, name=None):
    attrs = {"keep_dim": keep_dim, "reduce_all": dim is None}
    if dim is not None:
        attrs["dim"] = dim if isinstance(dim, (list, tuple)) else [dim]
    else:
        attrs["dim"] = [0]
    return _helper_out(op_type, {"X": [input]}, attrs, dtype=input.dtype)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


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


def argmin(x, axis=0):
    return _helper_out("arg_min", {"X": [x]}, {"axis": axis}, dtype="int64", stop_gradient=True)


def argsort(input, axis=-1, descending=False, name=None):
    """(the sorted values, their int64 indices) along ``axis``."""
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    ids = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op(type="argsort", inputs={"X": [input]}, outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def scatter(input, index, updates, name=None, overwrite=True):
    return _helper_out("scatter", {"X": [input], "Ids": [index], "Updates": [updates]},
                       {"overwrite": overwrite}, dtype=input.dtype)


def shape(input):
    return _helper_out("shape", {"Input": [input]}, dtype="int32", stop_gradient=True)


def cumsum(x, axis=None, exclusive=None, reverse=None):
    attrs = {}
    if axis is not None:
        attrs["axis"] = axis
    if exclusive is not None:
        attrs["exclusive"] = exclusive
    if reverse is not None:
        attrs["reverse"] = reverse
    return _helper_out("cumsum", {"X": [x]}, attrs, dtype=x.dtype)


def isfinite(x):
    return _helper_out("isfinite", {"X": [x]}, dtype="bool", stop_gradient=True)


def pow(x, factor=1.0, name=None):
    return _helper_out("pow", {"X": [x]}, {"factor": float(factor)}, dtype=x.dtype)
