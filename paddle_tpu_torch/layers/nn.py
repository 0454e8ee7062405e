"""NN layers (reference: python/paddle/fluid/layers/nn.py): fc,
embedding (in HBM, or on the parameter server with ``is_distributed``),
conv2d, conv2d_transpose, pool2d, the norms (batch, layer, group,
spectral, data, l2), dropout, the activations and softmaxes, the losses,
matmul and mul, one_hot and label_smooth, pad / crop and resize, the
pixel reorderings, bilinear_tensor_product, py_func, topk, accuracy,
auc, clip, clip_by_norm, and the sequence layers over the padded+length encoding
(the pools, softmax, expand, reverse, mask, erase, enumerate, the CRF,
edit_distance and ctc_greedy_decoder), the sequence, RNN-unit and
sampled-loss layers (im2sequence, warpctc, sequence_conv, nce, hsigmoid,
lstm_unit, gru_unit, row_conv, nested_sequence_pool), as the JAX
package's ``layers/nn.py`` builds them."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch import initializer, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["fc", "embedding", "conv2d", "conv2d_transpose", "pool2d", "batch_norm", "layer_norm",
           "group_norm", "dropout", "relu", "softmax", "log_softmax", "mean", "cross_entropy",
           "square_error_cost", "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
           "huber_loss", "log_loss", "smooth_l1", "matmul", "mul", "prelu", "l2_normalize",
           "one_hot", "label_smooth", "maxout", "pad", "pad2d", "pad_constant_like", "crop",
           "image_resize", "resize_bilinear", "resize_nearest", "pixel_shuffle",
           "shuffle_channel", "spectral_norm", "data_norm", "bilinear_tensor_product", "py_func",
           "topk", "accuracy", "auc", "clip", "clip_by_norm", "sequence_pool", "sequence_softmax",
           "sequence_expand", "sequence_reverse", "sequence_mask", "sequence_erase",
           "sequence_enumerate", "sequence_expand_as", "sequence_first_step",
           "sequence_last_step", "linear_chain_crf", "crf_decoding", "edit_distance",
           "ctc_greedy_decoder", "im2sequence", "warpctc", "sequence_conv", "nce", "hsigmoid",
           "lstm_unit", "gru_unit", "row_conv", "nested_sequence_pool"]


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
    """reference: layers/nn.py:449.

    ``is_distributed=True``: the table does NOT live on the device —
    rows are served by the parameter server (distributed/ps.py) and
    prefetched per batch (reference: transpiler/distribute_lookup_table.py
    + parameter_prefetch.cc).  The layer records the table's metadata on
    the program (``program._distributed_tables``, keyed by the prefetch
    var, one entry per lookup site: several sites may share one server
    table); bind servers with
    ``paddle_tpu_torch.distributed.bind_distributed_tables(program,
    endpoints)`` and the executor pulls before and pushes after each
    step.  The ids must be a feed of the step.  Otherwise the lookup is a
    dense gather from a table on the device."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    if is_distributed:
        from paddle_tpu_torch.param_attr import ParamAttr

        block = helper.main_program.current_block()
        attr = param_attr if isinstance(param_attr, ParamAttr) else ParamAttr(name=param_attr)
        table_name = attr.name or unique_name.generate("dist_emb_table")
        rows = block.create_var(
            name=unique_name.generate(table_name + "@PREFETCH"),
            shape=[-1, size[1]], dtype=dtype, stop_gradient=False,
        )
        ids_shape = tuple(input.shape or ())
        local_shape = ids_shape[:-1] if ids_shape and ids_shape[-1] == 1 else ids_shape
        local = block.create_var(
            name=unique_name.generate(table_name + "@LOCALIDS"),
            shape=list(local_shape) or [-1], dtype="int32", stop_gradient=True,
        )
        tmp = helper.create_variable_for_type_inference(dtype)
        pad = -1 if padding_idx is None else (padding_idx if padding_idx >= 0 else size[0] + padding_idx)
        helper.append_op(
            type="distributed_lookup_table",
            inputs={"Rows": [rows], "Ids": [local], "OrigIds": [input]},
            outputs={"Out": [tmp]},
            attrs={"table": table_name, "padding_idx": pad},
        )
        prog = helper.main_program
        if not hasattr(prog, "_distributed_tables"):
            prog._distributed_tables = {}
        prog._distributed_tables[rows.name] = {
            "table": table_name,
            "dim": int(size[1]),
            "height": int(size[0]),
            "ids_name": input.name,
            "rows_name": rows.name,
            "local_name": local.name,
            "squeeze_last": bool(ids_shape and ids_shape[-1] == 1),
        }
        return tmp
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


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None, stride=1, padding=0,
                     dilation=1, groups=1, param_attr=None, bias_attr=None, act=None, name=None):
    """reference: layers/nn.py conv2d_transpose (NCHW; the filter is
    [in_c, num_filters / groups, kh, kw])."""
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    filter_shape = [input.shape[1], num_filters // groups] + list(fsize)
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=input.dtype)
    pre_bias = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair_list(stride), "paddings": _pair_list(padding),
               "dilations": _pair_list(dilation), "groups": groups},
    )
    return helper.append_activation(_conv_bias(helper, pre_bias))


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


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    s = helper.create_parameter(param_attr, shape=[c], dtype=input.dtype,
                                default_initializer=initializer.Constant(1.0))
    b = helper.create_parameter(bias_attr, shape=[c], dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(type="group_norm", inputs={"X": [input], "Scale": [s], "Bias": [b]},
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon, "groups": groups})
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


def log_softmax(input, axis=-1, name=None):
    return _simple("log_softmax", input, {"axis": axis})


def prelu(x, mode="all", param_attr=None, name=None):
    """Alpha (0.25 at start) of shape [1] (``all``), [C] (``channel``) or
    x's sample shape (``element``)."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    alpha_shape = [1] if mode == "all" else ([x.shape[1]] if mode == "channel" else list(x.shape[1:]))
    alpha = helper.create_parameter(param_attr, shape=alpha_shape, dtype=x.dtype,
                                    default_initializer=initializer.Constant(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]}, outputs={"Out": [out]},
                     attrs={"mode": mode})
    return out


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


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None, normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index, "normalize": normalize},
    )
    return out


def _loss_with_side_output(op_type, x, y, side_slot, attrs):
    """A loss op over X and Y with a second output (the residual or the
    difference) that carries no gradient."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(x.dtype)
    side = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], side_slot: [side]}, attrs=attrs)
    return out


def huber_loss(input, label, delta):
    return _loss_with_side_output("huber_loss", input, label, "Residual", {"delta": delta})


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    return _loss_with_side_output("smooth_l1_loss", x, y, "Diff", {"sigma": sigma or 1.0})


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_loss", inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [out]}, attrs={"epsilon": epsilon})
    return out


def auc(input, label, curve="ROC", num_thresholds=200, topk=1, slide_steps=1):
    """As in the JAX package, there is no graph AUC op: the streaming AUC
    of a CTR model is ``paddle_tpu_torch.metrics.Auc`` over the fetched
    probabilities."""
    raise NotImplementedError("use paddle_tpu_torch.metrics.Auc for streaming AUC")


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


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(type="l2_normalize", inputs={"X": [x]}, outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"depth": depth})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    """(1 - epsilon) label + epsilon / K, K the last dim (a uniform prior,
    as the JAX package builds it: ``prior_dist`` is not read)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    smooth = ltensor.scale(label, scale=1.0 - epsilon)
    return ltensor.increment_const(smooth, epsilon / float(label.shape[-1]))


def maxout(x, groups, name=None):
    return _simple("maxout", x, {"groups": groups})


def pad(x, paddings, pad_value=0.0, name=None):
    return _simple("pad", x, {"paddings": paddings, "pad_value": pad_value})


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0, data_format="NCHW",
          name=None):
    return _simple("pad2d", input, {"paddings": paddings, "mode": mode, "pad_value": pad_value})


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(y.dtype)
    helper.append_op(type="pad_constant_like", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"pad_value": float(pad_value)})
    return out


def crop(x, shape=None, offsets=None, name=None):
    """The block of ``shape`` (a list, or a var whose shape it is) at
    ``offsets``."""
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x]}
    attrs = {"offsets": list(offsets or [0] * len(x.shape))}
    if isinstance(shape, (list, tuple)):
        attrs["shape"] = list(shape)
    elif shape is not None:
        ins["Y"] = [shape]
    helper.append_op(type="crop", inputs=ins, outputs={"Out": [out]}, attrs=attrs)
    return out


def image_resize(input, out_shape=None, scale=None, name=None, resample="BILINEAR",
                 actual_shape=None, align_corners=True, align_mode=1):
    """reference: layers/nn.py image_resize, bilinear or nearest."""
    helper = LayerHelper("image_resize", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    if out_shape is None and scale is None:
        raise ValueError("image_resize: one of out_shape and scale must be set")
    attrs = {"align_corners": bool(align_corners)}
    if out_shape is not None:
        attrs["out_h"], attrs["out_w"] = int(out_shape[0]), int(out_shape[1])
    if scale is not None:
        attrs["scale"] = float(scale)
    op_type = "bilinear_interp" if resample.upper() == "BILINEAR" else "nearest_interp"
    helper.append_op(type=op_type, inputs={"X": [input]}, outputs={"Out": [out]}, attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None, align_corners=True,
                    align_mode=1, **kw):
    return image_resize(input, out_shape, scale, name, "BILINEAR", align_corners=align_corners,
                        align_mode=align_mode)


def resize_nearest(input, out_shape=None, scale=None, name=None, align_corners=True, **kw):
    return image_resize(input, out_shape, scale, name, "NEAREST", align_corners=align_corners)


def pixel_shuffle(x, upscale_factor):
    return _simple("pixel_shuffle", x, {"upscale_factor": upscale_factor})


def shuffle_channel(x, group):
    return _simple("shuffle_channel", x, {"group": group})


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` over its spectral norm, with the power iteration's U
    and V as persistable Normal(0, 1) parameters that do not train."""
    from paddle_tpu_torch.param_attr import ParamAttr

    helper = LayerHelper("spectral_norm", name=name)
    if any(int(s) < 0 for s in weight.shape):
        raise ValueError("spectral_norm requires a fully static weight shape, got %s"
                         % (weight.shape,))
    h = int(weight.shape[dim])
    w = int(np.prod([int(s) for i, s in enumerate(weight.shape) if i != dim]))
    u = helper.create_parameter(ParamAttr(trainable=False), shape=[h], dtype=weight.dtype,
                                default_initializer=initializer.Normal(0.0, 1.0))
    v = helper.create_parameter(ParamAttr(trainable=False), shape=[w], dtype=weight.dtype,
                                default_initializer=initializer.Normal(0.0, 1.0))
    out = helper.create_variable_for_type_inference(weight.dtype)
    helper.append_op(type="spectral_norm", inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out]},
                     attrs={"dim": int(dim), "power_iters": int(power_iters), "eps": float(eps)})
    return out


def data_norm(input, act=None, epsilon=1e-4, param_attr=None, data_layout="NCHW", in_place=False,
              name=None, moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """CTR data normalisation by trainable BatchSize / BatchSum /
    BatchSquareSum accumulators (1e4, 0 and 1e4 at start, or the
    ``batch_size`` / ``batch_sum`` / ``batch_square`` of a dict
    ``param_attr``), which the op's gradient folds each batch into."""
    from paddle_tpu_torch.param_attr import ParamAttr

    helper = LayerHelper("data_norm", name=name, act=act)
    c = int(input.shape[1] if data_layout == "NCHW" else input.shape[-1])
    defaults = {"batch_size": 1e4, "batch_sum": 0.0, "batch_square": 1e4}
    if param_attr and isinstance(param_attr, dict):
        defaults.update({k: param_attr.get(k, v) for k, v in defaults.items()})

    def stat(suffix, value):
        return helper.create_parameter(
            ParamAttr(name=None if name is None else name + "." + suffix), shape=[c],
            dtype=input.dtype, default_initializer=initializer.Constant(float(value)))

    batch_size = stat("batch_size", defaults["batch_size"])
    batch_sum = stat("batch_sum", defaults["batch_sum"])
    batch_square_sum = stat("batch_square_sum", defaults["batch_square"])
    means = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    scales = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="data_norm",
        inputs={"X": [input], "BatchSize": [batch_size], "BatchSum": [batch_sum],
                "BatchSquareSum": [batch_square_sum]},
        outputs={"Y": [out], "Means": [means], "Scales": [scales]},
        attrs={"epsilon": float(epsilon), "data_layout": data_layout})
    return helper.append_activation(out)


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None, bias_attr=None):
    """out[b, k] = x[b]ᵀ W[k] y[b] + bias, W [size, M, N]."""
    helper = LayerHelper("bilinear_tensor_product", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    m, n = int(x.shape[-1]), int(y.shape[-1])
    w = helper.create_parameter(param_attr, shape=[size, m, n], dtype=x.dtype)
    bias = helper.create_parameter(bias_attr, shape=[1, size], dtype=x.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x], "Y": [y], "Weight": [w]}
    if bias is not None:
        ins["Bias"] = [bias]
    helper.append_op(type="bilinear_tensor_product", inputs=ins, outputs={"Out": [out]}, attrs={})
    return helper.append_activation(out)


# py_func's host functions, by the op's ``func_id`` attr: (func, output
# (shape, dtype) specs, out_shape_fn), one entry per distinct triple
_PY_FUNC_REGISTRY = []
_PY_FUNC_INDEX = {}


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None,
            out_shape_fn=None):
    """Run the host function ``func`` at the op's place in the step, on
    numpy copies of ``x``, into the pre-made vars ``out`` (their shapes
    and dtypes are the contract).  A -1 in position 0 of an output shape
    is the first input's batch; any other dynamic dim needs
    ``out_shape_fn(input_shapes) -> [shape, ...]``.  ``backward_func`` is
    not taken, as in the JAX package: keep py_func off the gradient's
    path."""
    if backward_func is not None:
        raise NotImplementedError("py_func backward_func: use differentiable ops")
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    specs = [(tuple(int(s) for s in o.shape), o.dtype) for o in outs]
    key = (func, tuple(specs), out_shape_fn)
    func_id = _PY_FUNC_INDEX.get(key)
    if func_id is None:
        _PY_FUNC_REGISTRY.append((func, specs, out_shape_fn))
        func_id = _PY_FUNC_INDEX[key] = len(_PY_FUNC_REGISTRY) - 1
    helper.append_op(type="py_func", inputs={"X": [v.name for v in xs]},
                     outputs={"Out": [o.name for o in outs]}, attrs={"func_id": func_id})
    return outs if isinstance(out, (list, tuple)) else outs[0]


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


# ---------------------------------------------------------------------------
# sequence layers over the padded+length encoding (ops/sequence_ops.py)
# ---------------------------------------------------------------------------
def sequence_pool(input, pool_type, seq_len=None):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    midx = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    inputs = {"X": [input]}
    if seq_len is None and input.block.has_var(input.name + "_seq_len"):
        seq_len = input.block.var(input.name + "_seq_len")
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(
        type="sequence_pool",
        inputs=inputs,
        outputs={"Out": [out], "MaxIndex": [midx]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_softmax(input, seq_len=None, use_cudnn=False, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_softmax", inputs=inputs, outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def sequence_reverse(x, seq_len=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    if seq_len is not None:
        inputs["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_reverse", inputs=inputs, outputs={"Y": [out]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="sequence_mask",
        inputs={"X": [x]},
        outputs={"Y": [out]},
        attrs={"maxlen": maxlen if maxlen is not None else -1, "out_dtype": dtype},
    )
    return out



def sequence_erase(input, tokens, seq_len=None, name=None):
    """reference: sequence_erase_op.cc; returns (packed, new_seq_len)."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    new_len = helper.create_variable_for_type_inference("int32")
    ins = {"X": [input]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_erase", inputs=ins,
                     outputs={"Out": [out], "OutSeqLen": [new_len]},
                     attrs={"tokens": list(tokens)})
    return out, new_len


def sequence_enumerate(input, win_size, pad_value=0, seq_len=None, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_enumerate", inputs=ins, outputs={"Out": [out]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_expand_as(x, y, seq_len=None, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_first_step(input, seq_len=None):
    return sequence_pool(input, "first", seq_len=seq_len)


def sequence_last_step(input, seq_len=None):
    return sequence_pool(input, "last", seq_len=seq_len)



def linear_chain_crf(input, label, param_attr=None, seq_len=None):
    """CRF negative log-likelihood cost [B, 1]; creates the [K+2, K]
    transition parameter (row 0 start, row 1 end, rows 2.. transitions)."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(param_attr, shape=[size + 2, size], dtype=input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    emission_exps = helper.create_variable_for_type_inference(input.dtype)
    transition_exps = helper.create_variable_for_type_inference(input.dtype)
    log_likelihood = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Emission": [input], "Transition": [transition], "Label": [label]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(
        type="linear_chain_crf", inputs=ins,
        outputs={"Alpha": [alpha], "EmissionExps": [emission_exps],
                 "TransitionExps": [transition_exps],
                 "LogLikelihood": [log_likelihood]},
        attrs={},
    )
    return log_likelihood


def crf_decoding(input, param_attr, label=None, seq_len=None):
    """Viterbi decode using the transition parameter created by
    linear_chain_crf (shared by ``param_attr.name``)."""
    from paddle_tpu_torch.param_attr import ParamAttr

    helper = LayerHelper("crf_decoding")
    attr = ParamAttr._to_attr(param_attr)
    transition = helper.main_program.global_block().var(attr.name)
    viterbi_path = helper.create_variable_for_type_inference("int64")
    ins = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        ins["Label"] = [label]
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="crf_decoding", inputs=ins,
                     outputs={"ViterbiPath": [viterbi_path]}, attrs={})
    return viterbi_path



def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  input_length=None, label_length=None):
    """Batched Levenshtein distance -> (Out [B, 1], SequenceNum []).
    ``ignored_tokens`` are erased (sequence_erase) before the DP."""
    helper = LayerHelper("edit_distance")
    if ignored_tokens:
        input, input_length = sequence_erase(input, ignored_tokens, input_length)
        label, label_length = sequence_erase(label, ignored_tokens, label_length)
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    ins = {"Hyps": [input], "Refs": [label]}
    if input_length is not None:
        ins["HypsLength"] = [input_length]
    if label_length is not None:
        ins["RefsLength"] = [label_length]
    helper.append_op(type="edit_distance", inputs=ins,
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0):
    """Greedy CTC decode: per-step argmax then ctc_align (merge repeats,
    drop blanks).  Returns (decoded [B, T], decoded_length [B])."""
    helper = LayerHelper("ctc_greedy_decoder")
    from paddle_tpu_torch.layers import tensor as ltensor

    idx = ltensor.argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    ins = {"Input": [idx]}
    if input_length is not None:
        ins["SeqLen"] = [input_length]
    helper.append_op(type="ctc_align", inputs=ins,
                     outputs={"Output": [out], "OutputLength": [out_len]},
                     attrs={"blank": int(blank), "merge_repeated": True,
                            "padding_num": int(padding_value)})
    return out, out_len




# ---------------------------------------------------------------------------
# the sequence, RNN-unit and sampled-loss layers (reference: layers/nn.py
# im2sequence, warpctc:4324, sequence_conv:2210, nce:4950, hsigmoid:5066,
# lstm_unit, gru_unit, row_conv:6334; ops in ops/nn_ops.py)
# ---------------------------------------------------------------------------
def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    """The ``filter_size`` patches of NCHW ``input`` at ``stride`` as rows
    [N·oh·ow, C·kh·kw].  ``padding`` is accepted and, as in the JAX
    package's layer, not passed to the op (which pads nothing)."""
    helper = LayerHelper("im2sequence", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="im2sequence",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "kernels": filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2,
            "strides": stride if isinstance(stride, (list, tuple)) else [stride] * 2,
        },
    )
    return out


def warpctc(input, label, blank=0, norm_by_times=False, input_length=None,
            label_length=None):
    """CTC loss; input [B, T, C] padded logits, label [B, L]."""
    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Logits": [input], "Label": [label]}
    if input_length is not None:
        ins["LogitsLength"] = [input_length]
    if label_length is not None:
        ins["LabelLength"] = [label_length]
    helper.append_op(
        type="warpctc", inputs=ins, outputs={"Loss": [loss]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return loss


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, bias_attr=None, param_attr=None, act=None,
                  seq_len=None, name=None):
    """Context-window conv over padded sequences [B, T, D]."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    D = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[filter_size * D, num_filters],
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "Filter": [w]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(
        type="sequence_conv", inputs=ins, outputs={"Out": [out]},
        attrs={"contextStart": -int(filter_size // 2), "contextLength": filter_size,
               "contextStride": filter_stride},
    )
    return helper.append_activation(helper.append_bias_op(out, dim_start=2))


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=10, name=None, sampler="uniform",
        custom_dist=None, seed=0, is_sparse=False):
    """Noise-contrastive estimation loss -> [B, 1] cost.  uniform,
    log_uniform (Zipfian), and custom_dist (a length-num_total_classes
    probability sequence — the reference's CustomSampler,
    operators/math/sampler.cc) samplers with their log(k*P) corrections;
    ``sample_weight`` [B, 1] scales each example's cost
    (reference: operators/nce_op.h sample_weight)."""
    if custom_dist is not None:
        sampler = "custom_dist"
    if sampler not in ("uniform", "log_uniform", "custom_dist"):
        raise ValueError("nce: unknown sampler %r" % sampler)
    if sampler == "custom_dist" and custom_dist is None:
        raise ValueError("nce: sampler='custom_dist' requires custom_dist")
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    w = helper.create_parameter(param_attr, shape=[num_total_classes, dim], dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[num_total_classes], dtype=input.dtype,
                                is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Input": [input], "Label": [label], "Weight": [w]}
    if b is not None:
        ins["Bias"] = [b]
    if sample_weight is not None:
        ins["SampleWeight"] = [sample_weight]
    attrs = {"num_neg_samples": num_neg_samples, "seed": seed, "sampler": sampler}
    if custom_dist is not None:
        dist = np.asarray(custom_dist, dtype=np.float32).reshape(-1)
        if dist.shape[0] != num_total_classes:
            raise ValueError(
                "nce: custom_dist length %d != num_total_classes %d"
                % (dist.shape[0], num_total_classes)
            )
        attrs["custom_dist"] = dist
    helper.append_op(type="nce", inputs=ins, outputs={"Cost": [cost]}, attrs=attrs)
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None, path_table=None, path_code=None, is_custom=False,
             is_sparse=False):
    """Hierarchical sigmoid loss.  Default: complete binary tree over
    ``num_classes`` leaves.  Custom (is_custom=True): ``path_table`` /
    ``path_code`` [N, L] give each sample's leaf->root non-leaf indices
    (-1 padded) and branch labels, and ``num_classes`` is the NON-LEAF
    count (reference: layers/nn.py hsigmoid custom-tree contract)."""
    if is_custom:
        if path_table is None or path_code is None:
            raise ValueError(
                "hsigmoid(is_custom=True) requires path_table and path_code"
            )
    elif path_table is not None or path_code is not None:
        raise ValueError(
            "hsigmoid: path_table/path_code need is_custom=True "
            "(silently ignoring them would train the wrong tree)"
        )
    helper = LayerHelper("hierarchical_sigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    dim = input.shape[-1]
    rows = num_classes if is_custom else num_classes - 1
    w = helper.create_parameter(param_attr, shape=[rows, dim], dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[rows], dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    pre = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "Label": [label], "W": [w]}
    if b is not None:
        ins["Bias"] = [b]
    if is_custom:
        ins["PathTable"] = [path_table]
        ins["PathCode"] = [path_code]
    helper.append_op(
        type="hierarchical_sigmoid", inputs=ins,
        outputs={"Out": [out], "PreOut": [pre]},
        attrs={"num_classes": num_classes, "is_custom": is_custom},
    )
    return out


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step: returns (hidden, cell).  x_t [B, D] concatenated
    with h_prev feeds a 4H projection (reference: layers/nn.py lstm_unit)."""
    helper = LayerHelper("lstm_unit", param_attr=param_attr, bias_attr=bias_attr, name=name)
    from paddle_tpu_torch.layers import tensor as ltensor

    H = hidden_t_prev.shape[-1]
    cat = ltensor.concat([x_t, hidden_t_prev], axis=1)
    gates = fc(cat, 4 * H, param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [gates], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias},
    )
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", origin_mode=False):
    """One GRU step (reference: layers/nn.py gru_unit).  size = 3*H.  As
    the JAX package's layer, it passes no attrs: ``activation``,
    ``gate_activation`` and ``origin_mode`` are ignored, and the op computes
    the ``origin_mode=True`` form (ROADMAP queue C)."""
    helper = LayerHelper("gru_unit", param_attr=param_attr, bias_attr=bias_attr)
    H = size // 3
    w = helper.create_parameter(param_attr, shape=[H, 3 * H], dtype=input.dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 3 * H], dtype=input.dtype, is_bias=True)
    gate = helper.create_variable_for_type_inference(input.dtype)
    reset_h = helper.create_variable_for_type_inference(input.dtype)
    out_h = helper.create_variable_for_type_inference(input.dtype)
    ins = {"Input": [input], "HiddenPrev": [hidden], "Weight": [w]}
    if b is not None:
        ins["Bias"] = [b]
    helper.append_op(
        type="gru_unit", inputs=ins,
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_h], "Hidden": [out_h]},
        attrs={},
    )
    return out_h, reset_h, gate


def row_conv(input, future_context_size, param_attr=None, act=None, seq_len=None):
    """Lookahead (row) convolution; filter [future_context_size + 1, D]."""
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    d = int(input.shape[-1])
    filt = helper.create_parameter(param_attr, shape=[future_context_size + 1, d],
                                   dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "Filter": [filt]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="row_conv", inputs=ins, outputs={"Out": [out]}, attrs={})
    return helper.append_activation(out)


def nested_sequence_pool(input, outer_len, inner_len, pool_type="sum",
                         inner_pool_type=None):
    """N-level LoD pooling on the padded nested encoding (reference:
    nested-sequence semantics of lod_tensor.h:110,:229 — recursively
    nested sequences, e.g. doc -> sentence -> word).

    ``inner_len`` is one length tensor (2-level) or a list ordered
    outer->inner (N-level): level k's tensor has shape [B, S1..Sk].
    For input [B, S1, ..., SL, D...], pools the innermost level with
    ``inner_pool_type`` (defaults to ``pool_type``), then each enclosing
    level with ``pool_type``; returns [B, D...].  Each level is a
    flatten-to-[prod, Sk, D] + ``sequence_pool`` over its lengths."""
    from paddle_tpu_torch.layers import tensor as ltensor

    inners = list(inner_len) if isinstance(inner_len, (list, tuple)) else [inner_len]
    lengths = [outer_len] + inners  # index k = level-k lengths, [B, S1..Sk]
    L = len(lengths)
    x = input
    for k in range(L, 0, -1):
        tail = [int(s) for s in x.shape[k:]]  # [Sk, D...]
        flat = ltensor.reshape(x, shape=[-1] + tail)
        ln = lengths[k - 1]
        ln_flat = ltensor.reshape(ln, shape=[-1]) if k > 1 else ln
        ptype = (inner_pool_type or pool_type) if k == L else pool_type
        pooled = sequence_pool(flat, ptype, seq_len=ln_flat)  # [prod, D...]
        if k > 1:
            lead = [int(s) for s in input.shape[1:k]]
            x = ltensor.reshape(
                pooled, shape=[-1] + lead + [int(s) for s in pooled.shape[1:]]
            )
        else:
            x = pooled
    return x
