"""Composite network blocks (reference: python/paddle/fluid/nets.py —
simple_img_conv_pool:28, img_conv_group:136, sequence_conv_pool:249,
glu:307, scaled_dot_product_attention:345).

Pure compositions over the layers API: each block appends the ops its
layers append, so a program built here has the JAX package's desc.
"""
from __future__ import annotations

from paddle_tpu_torch import layers

__all__ = [
    "simple_img_conv_pool",
    "sequence_conv_pool",
    "glu",
    "scaled_dot_product_attention",
    "img_conv_group",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    """reference: nets.py:28."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """reference: nets.py:136 — the VGG conv block."""
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def to_list(v):
        return v if isinstance(v, (list, tuple)) else [v] * len(conv_num_filter)

    paddings = to_list(conv_padding)
    fsizes = to_list(conv_filter_size)
    pattrs = to_list(param_attr)
    with_bn = to_list(conv_with_batchnorm)
    drops = to_list(conv_batchnorm_drop_rate)
    for i, nf in enumerate(conv_num_filter):
        local_act = conv_act if not with_bn[i] else None
        tmp = layers.conv2d(
            input=tmp, num_filters=nf, filter_size=fsizes[i],
            padding=paddings[i], param_attr=pattrs[i], act=local_act,
        )
        if with_bn[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if drops[i]:
                tmp = layers.dropout(x=tmp, dropout_prob=drops[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None,
                       seq_len=None):
    """reference: nets.py:249 — the text-conv block."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, bias_attr=bias_attr, act=act, seq_len=seq_len,
    )
    return layers.sequence_pool(conv_out, pool_type, seq_len=seq_len)


def glu(input, dim=-1):
    """reference: nets.py:307 — gated linear unit: split | a * sigmoid(b)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    a, b = ltensor.split(input, num_or_sections=2, dim=dim)
    return a * layers.sigmoid(b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """reference: nets.py:345 — multi-head scaled dot-product attention
    over [B, T, D] tensors."""
    from paddle_tpu_torch.layers import tensor as ltensor

    d_key = int(queries.shape[-1]) // num_heads

    def split_heads(x):
        if num_heads == 1:
            return x
        B, T, D = x.shape
        x = ltensor.reshape(x, shape=[0, int(T), num_heads, int(D) // num_heads])
        return ltensor.transpose(x, [0, 2, 1, 3])

    def merge_heads(x):
        if num_heads == 1:
            return x
        x = ltensor.transpose(x, [0, 2, 1, 3])
        s = x.shape
        return ltensor.reshape(x, shape=[0, int(s[1]), int(s[2]) * int(s[3])])

    q, k, v = split_heads(queries), split_heads(keys), split_heads(values)
    scaled = layers.scale(q, scale=d_key ** -0.5)
    product = layers.matmul(scaled, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    return merge_heads(layers.matmul(weights, v))
