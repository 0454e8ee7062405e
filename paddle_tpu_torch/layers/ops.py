"""Unary layer wrappers, as the JAX package's ``layers/ops.py`` makes them.

Reference: python/paddle/fluid/layers/ops.py via layer_function_generator.py
— thin wrappers around registered activation/math ops.
"""
from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

_UNARY = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "tanh",
    "sqrt",
    "rsqrt",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "square",
    "softplus",
    "softsign",
    "log",
    "relu6",
    "elu",
    "swish",
    "hard_sigmoid",
    "hard_swish",
    "thresholded_relu",
    "stanh",
    "soft_relu",
    "brelu",
    "leaky_relu",
    "gelu",
    "sign",
]

__all__ = list(_UNARY)


def _make(op_type):
    def layer(x, *args, name=None, **kwargs):
        attrs = dict(kwargs)
        # positional alpha/threshold args map per-op; common case: first arg
        if args:
            keymap = {
                "leaky_relu": "alpha",
                "elu": "alpha",
                "relu6": "threshold",
                "swish": "beta",
                "thresholded_relu": "threshold",
                "soft_relu": "threshold",
            }
            attrs[keymap.get(op_type, "value")] = args[0]
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


for _name in _UNARY:
    globals()[_name] = _make(_name)
