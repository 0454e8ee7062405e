"""NN layers (reference: python/paddle/fluid/layers/nn.py): fc,
embedding, layer_norm, mean, softmax_with_cross_entropy, matmul, topk
and accuracy, as the JAX package's ``layers/nn.py`` builds them."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch import initializer
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["fc", "embedding", "layer_norm", "mean", "softmax_with_cross_entropy", "matmul",
           "topk", "accuracy"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None, act=None, name=None):
    """Fully-connected (reference: layers/nn.py:223): mul + sum + bias + act."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = param_attr if isinstance(param_attr, (list, tuple)) else [param_attr] * len(inputs)
    mul_results = []
    for inp, pattr in zip(inputs, param_attrs):
        w_in = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(pattr, shape=[w_in, size], dtype=inp.dtype)
        tmp = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) != 1:
        raise NotImplementedError("fc over several inputs needs the sum op, not ported yet")
    pre_act = helper.append_bias_op(mul_results[0], dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None,
              param_attr=None, dtype="float32"):
    """reference: layers/nn.py:449 — a dense gather from a table on the
    device.  Parameter-server tables (``is_distributed``) are a later
    slice of the port."""
    if is_distributed:
        raise NotImplementedError("distributed lookup tables are not ported yet")
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=size, dtype=dtype)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed, "padding_idx": padding_idx},
    )
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(param_attr, shape=norm_shape, dtype=input.dtype,
                                    default_initializer=initializer.Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape, dtype=input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def _simple(op_type, x, attrs=None, out_slot="Out", in_slot="X", dtype=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(type=op_type, inputs={in_slot: [x]}, outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def mean(x, name=None):
    return _simple("mean", x)


def softmax_with_cross_entropy(
    logits, label, soft_label=False, ignore_index=-100, numeric_stable_mode=True, return_softmax=False, axis=-1
):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index, "axis": axis},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    indices = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op(
        type="top_k", inputs={"X": [input]}, outputs={"Out": [values], "Indices": [indices]}, attrs={"k": k}
    )
    return values, indices


def accuracy(input, label, k=1, correct=None, total=None):
    """reference: layers/metric_op.py accuracy — top_k + accuracy op."""
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    acc = helper.create_variable_for_type_inference("float32", stop_gradient=True)
    correct = correct or helper.create_variable_for_type_inference("int32", stop_gradient=True)
    total = total or helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Indices": [indices], "Label": [label]},
        outputs={"Accuracy": [acc], "Correct": [correct], "Total": [total]},
    )
    return acc
