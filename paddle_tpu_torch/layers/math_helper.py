"""Variable operator-overload sugar (reference: framework.py monkey
patch + layers/math_op_patch.py): ``x + y`` between two Variables."""
from __future__ import annotations


def binary_op(x, other, op_type):
    from paddle_tpu_torch.framework import Variable
    from paddle_tpu_torch.layer_helper import LayerHelper

    if not isinstance(other, Variable):
        raise TypeError(
            "%s with a %s operand needs the scale op, not ported yet"
            % (op_type, type(other).__name__))
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [other]}, outputs={"Out": [out]}, attrs={"axis": -1})
    return out
