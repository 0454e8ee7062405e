"""NN ops (the slice's subset of the JAX package's ``ops/nn_ops.py``).

Reference kernels: operators/activation_op.cc (gelu),
layer_norm_op.cc, and the fused attention op whose compute is the
hand-written CUDA kernel in ``kernels/fused_attention.py``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels.fused_attention import fused_attention_fwd
from paddle_tpu_torch.ops.common import maybe, one


@register_op("gelu")
def gelu(inputs, attrs, device):
    approximate = "tanh" if attrs.get("approximate", False) else "none"
    return {"Out": F.gelu(one(inputs, "X"), approximate=approximate)}


@register_op("layer_norm")
def layer_norm(inputs, attrs, device):
    """Statistics in fp32 (at least), output in X's dtype; outputs the
    per-row Mean and (biased) Variance like the reference op."""
    x = one(inputs, "X")
    scale = maybe(inputs, "Scale")
    bias = maybe(inputs, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    stat_dtype = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(stat_dtype)
    var, mean = torch.var_mean(xf, dim=axes, correction=0, keepdim=True)
    y = (xf - mean) / torch.sqrt(var + eps)
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape)
    if bias is not None:
        y = y + bias.reshape(norm_shape)
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(x.shape[:begin]),
            "Variance": var.reshape(x.shape[:begin])}


@register_op("fused_attention", no_grad_set={"Mask"})
def fused_attention(inputs, attrs, device):
    """Fused scaled-dot-product attention: Q/K/V [N, H, S, D] -> ctx
    [N, H, S, D], with padding as ``Mask`` [N, S] (1 = token) and
    ``causal``.  On a card this is the hand-written kernel; the JAX
    package's opt-in switch between its branches does not carry over."""
    return {"Out": fused_attention_fwd(
        one(inputs, "Q"), one(inputs, "K"), one(inputs, "V"),
        maybe(inputs, "Mask"), bool(attrs.get("causal", False)),
        float(attrs.get("scale", 1.0)))}
