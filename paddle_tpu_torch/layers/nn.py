"""NN layers (reference: python/paddle/fluid/layers/nn.py): fc,
embedding, conv2d, pool2d, batch_norm, layer_norm, dropout, relu,
softmax, mean, cross_entropy, softmax_with_cross_entropy, matmul, topk,
accuracy, clip and clip_by_norm, as the JAX package's ``layers/nn.py``
builds them."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch import initializer, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm", "dropout", "relu",
           "softmax", "mean", "cross_entropy", "square_error_cost", "softmax_with_cross_entropy",
           "matmul", "topk", "accuracy", "clip", "clip_by_norm"]


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
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op(type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
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


def _pair_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 2


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None,
           data_format="NCHW"):
    """reference: layers/nn.py conv2d.  The filter is OIHW in both
    layouts, initialised Normal(0, sqrt(2 / fan_in))."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(
            "conv2d data_format must be 'NCHW' or 'NHWC' (got %r)" % (data_format,))
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    fsize = _pair_list(filter_size)
    fan_in = (num_channels // groups) * int(np.prod(fsize))
    w = helper.create_parameter(
        param_attr,
        shape=[num_filters, num_channels // groups] + fsize,
        dtype=input.dtype,
        default_initializer=initializer.Normal(0.0, (2.0 / fan_in) ** 0.5),
    )
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": _pair_list(stride),
            "paddings": _pair_list(padding),
            "dilations": _pair_list(dilation),
            "groups": groups,
            "data_format": data_format,
        },
    )
    return helper.append_activation(_conv_bias(helper, pre_bias, data_format))


def _conv_bias(helper, pre_bias, data_format="NCHW"):
    """One bias per filter, added along the channel axis (none with
    ``bias_attr=False``)."""
    if helper.bias_attr is False:
        return pre_bias
    caxis = 1 if data_format == "NCHW" else len(pre_bias.shape) - 1
    b = helper.create_parameter(helper.bias_attr, shape=[pre_bias.shape[caxis]],
                                dtype=pre_bias.dtype, is_bias=True)
    tmp = helper.create_variable_for_type_inference(pre_bias.dtype)
    helper.append_op(
        type="elementwise_add",
        inputs={"X": [pre_bias], "Y": [b]},
        outputs={"Out": [tmp]},
        attrs={"axis": caxis},
    )
    return tmp


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, exclusive=True, name=None,
           data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": _pair_list(pool_size),
            "strides": _pair_list(pool_stride),
            "paddings": _pair_list(pool_padding),
            "global_pooling": global_pooling,
            "data_format": data_format,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5, param_attr=None,
               bias_attr=None, data_layout="NCHW", name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False,
               use_global_stats=False, sync=False):
    """reference: layers/nn.py batch_norm.  The running stats are
    persistable vars (Constant 0 and 1 in the startup program) that the
    op updates in the step: MeanOut and VarianceOut are Mean and
    Variance."""
    helper = LayerHelper("batch_norm", param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype
    scale = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                    default_initializer=initializer.Constant(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype, is_bias=True)
    mean_name = moving_mean_name or unique_name.generate(helper.name + ".mean")
    var_name = moving_variance_name or unique_name.generate(helper.name + ".variance")
    block = helper.main_program.global_block()
    mean = block.create_var(name=mean_name, shape=[c], dtype=dtype, persistable=True,
                            stop_gradient=True)
    variance = block.create_var(name=var_name, shape=[c], dtype=dtype, persistable=True,
                                stop_gradient=True)
    helper.set_variable_initializer(mean, initializer.Constant(0.0))
    helper.set_variable_initializer(variance, initializer.Constant(1.0))
    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean],
                "Variance": [variance]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test or use_global_stats,
            "data_layout": data_layout,
            "sync_bn": bool(sync),
        },
    )
    return helper.append_activation(out)


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


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    """reference: layers/nn.py dropout.  The op's ``seed`` is the
    program's next (``Program.next_seed``) unless one is given; the op
    draws its mask from that seed alone."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else helper.main_program.next_seed(),
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def _simple(op_type, x, attrs=None, out_slot="Out", in_slot="X", dtype=None):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype or x.dtype)
    helper.append_op(type=op_type, inputs={in_slot: [x]}, outputs={out_slot: [out]}, attrs=attrs or {})
    return out


def mean(x, name=None):
    return _simple("mean", x)


def relu(x, name=None):
    return _simple("relu", x)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    return _simple("softmax", input, {"axis": axis})


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


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


def clip(x, min, max, name=None):
    return _simple("clip", x, {"min": min, "max": max})


def clip_by_norm(x, max_norm, name=None):
    return _simple("clip_by_norm", x, {"max_norm": max_norm})
