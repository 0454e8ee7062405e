"""Variable operator-overload sugar (reference: framework.py monkey
patch + layers/math_op_patch.py), as the JAX package's
``layers/math_helper.py`` writes it: a scalar operand of ``+``, ``-``,
``*`` or ``/`` becomes a ``scale`` op where one can express it, a
``fill_constant`` [1] operand otherwise, so both packages give the same
Program JSON."""
from __future__ import annotations


def binary_op(x, other, op_type, reverse=False):
    from paddle_tpu_torch.layer_helper import LayerHelper
    from paddle_tpu_torch.layers import tensor as ltensor

    if isinstance(other, (int, float)):
        if op_type == "elementwise_add" and not reverse:
            return ltensor.scale(x, scale=1.0, bias=float(other))
        if op_type == "elementwise_sub":
            if reverse:
                return ltensor.scale(x, scale=-1.0, bias=float(other))
            return ltensor.scale(x, scale=1.0, bias=-float(other))
        if op_type == "elementwise_mul":
            return ltensor.scale(x, scale=float(other))
        if op_type == "elementwise_div" and not reverse:
            return ltensor.scale(x, scale=1.0 / float(other))
        # the rest (a scalar over x): a constant var
        other = ltensor.fill_constant([1], x.dtype, float(other))
    a, b = (other, x) if reverse else (x, other)
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(a.dtype)
    helper.append_op(type=op_type, inputs={"X": [a], "Y": [b]}, outputs={"Out": [out]}, attrs={"axis": -1})
    return out
