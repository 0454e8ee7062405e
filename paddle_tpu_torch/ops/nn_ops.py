"""NN ops (the ported subset of the JAX package's ``ops/nn_ops.py``).

Reference kernels: operators/activation_op.cc, softmax_op.cc,
conv_op.cc, pool_op.cc, batch_norm_op.cc, layer_norm_op.cc,
cross_entropy_op.cc, softmax_with_cross_entropy_op.cc,
sigmoid_cross_entropy_with_logits_op.cc, dropout_op.cc, and the fused
attention op.  The fused attention op's compute and
gradient are the hand-written CUDA kernels behind
``kernels/fused_attention.py``; dropout's training branch is the
hand-written kernel behind ``kernels/dropout.py``.

Convolution and pooling go through ``torch.nn.functional`` (cuDNN on a
card), as the JAX package left them to XLA.  ``data_format="NHWC"``
takes ``x.permute(0, 3, 1, 2)`` of the NHWC tensor: that view is a
channels-last NCHW tensor, so cuDNN runs its NHWC kernels on it without
a copy, and the result, channels-last too, permutes back to a
contiguous NHWC tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels.dropout import divisor, dropout_train
from paddle_tpu_torch.kernels.fused_attention import fused_attention_fwd
from paddle_tpu_torch.ops.common import maybe, one


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _as_nchw(x, fmt):
    return x.permute(0, 3, 1, 2) if fmt == "NHWC" else x


def _from_nchw(y, fmt):
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def _act(name, fn):
    @register_op(name)
    def kernel(inputs, attrs, device, _fn=fn):
        return {"Out": _fn(one(inputs, "X"), attrs)}

    return kernel


def _gelu(x, a):
    return F.gelu(x, approximate="tanh" if a.get("approximate", False) else "none")


def _softplus(x, a):
    return torch.logaddexp(x, torch.zeros_like(x))  # no linear cut-off, as jax.nn.softplus


def _soft_relu(x, a):
    t = a.get("threshold", 40.0)
    return torch.log1p(torch.exp(torch.clamp(x, -t, t)))


_act("relu", lambda x, a: torch.relu(x))
_act("relu6", lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)))
_act("sigmoid", lambda x, a: torch.sigmoid(x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("gelu", _gelu)
_act("leaky_relu", lambda x, a: torch.where(x >= 0, x, a.get("alpha", 0.02) * x))
_act("elu", lambda x, a: F.elu(x, a.get("alpha", 1.0)))
_act("softplus", _softplus)
_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_act("hard_sigmoid", lambda x, a: torch.clamp(a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_act("hard_swish", lambda x, a: x * torch.clamp(x + a.get("offset", 3.0), 0.0, a.get("threshold", 6.0))
     / a.get("scale", 6.0))
_act("thresholded_relu", lambda x, a: torch.where(x > a.get("threshold", 1.0), x, 0.0))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(a.get("scale_a", 0.67) * x))
_act("soft_relu", _soft_relu)
_act("brelu", lambda x, a: torch.clamp(x, a.get("t_min", 0.0), a.get("t_max", 24.0)))


@register_op("softmax")
def softmax(inputs, attrs, device):
    return {"Out": F.softmax(one(inputs, "X"), dim=attrs.get("axis", -1))}


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


# ---------------------------------------------------------------------------
# conv / pool
# ---------------------------------------------------------------------------
@register_op("conv2d")
def conv2d(inputs, attrs, device):
    """reference: conv_op.cc.  ``data_format`` NCHW or NHWC for Input and
    Output; the Filter is OIHW in both."""
    fmt = attrs.get("data_format", "NCHW")
    out = F.conv2d(_as_nchw(one(inputs, "Input"), fmt), one(inputs, "Filter"),
                   stride=_pair(attrs.get("strides", [1, 1])),
                   padding=_pair(attrs.get("paddings", [0, 0])),
                   dilation=_pair(attrs.get("dilations", [1, 1])),
                   groups=attrs.get("groups", 1))
    out = _from_nchw(out, fmt)
    b = maybe(inputs, "Bias")
    if b is not None:
        out = out + b.reshape((1, -1, 1, 1) if fmt == "NCHW" else (1, 1, 1, -1))
    return {"Output": out}


def _window_sum(x, ksize, strides, pads):
    """Sums over each window of ``x`` [N, C, H, W], zero padded by
    ``pads`` (low, high) per spatial axis."""
    xp = F.pad(x, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    return F.avg_pool2d(xp, ksize, strides, divisor_override=1)


@register_op("pool2d")
def pool2d(inputs, attrs, device):
    """reference: pool_op.cc.  Windows as the JAX op cuts them: ``ceil_mode``
    adds the high-side padding that makes the partial last windows whole
    (a last window may then lie wholly in the padding, where torch's own
    ``ceil_mode`` drops it), max pads with -inf, and an ``exclusive``
    average divides by the real cells of its window."""
    x = one(inputs, "X")
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [2, 2]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    fmt = attrs.get("data_format", "NCHW")
    if attrs.get("global_pooling", False) or (
            attrs.get("adaptive", False) and tuple(attrs.get("ksize")) == (1, 1)):
        sp = (2, 3) if fmt == "NCHW" else (1, 2)
        if ptype == "max":
            return {"Out": torch.amax(x, dim=sp, keepdim=True)}
        return {"Out": torch.mean(x, dim=sp, keepdim=True)}
    xc = _as_nchw(x, fmt)
    hw = tuple(xc.shape[2:])
    extra = [0, 0]
    if attrs.get("ceil_mode", False):
        for d in range(2):
            num = hw[d] + 2 * pads[d] - ksize[d]
            o_ceil = -(-num // strides[d]) + 1
            extra[d] = (o_ceil - 1) * strides[d] + ksize[d] - hw[d] - 2 * pads[d]
    exclusive = attrs.get("exclusive", True)
    if not any(extra) and all(p <= k // 2 for p, k in zip(pads, ksize)):
        # torch pads the same windows (its limit: a pad of at most half
        # the window)
        if ptype == "max":
            out = F.max_pool2d(xc, ksize, strides, pads)
        else:
            out = F.avg_pool2d(xc, ksize, strides, pads, count_include_pad=not exclusive)
    else:
        spans = [(pads[d], pads[d] + extra[d]) for d in range(2)]
        if ptype == "max":
            xp = F.pad(xc, (spans[1][0], spans[1][1], spans[0][0], spans[0][1]),
                       value=float("-inf"))
            out = F.max_pool2d(xp, ksize, strides)
        else:
            out = _window_sum(xc, ksize, strides, spans)
            if exclusive:
                ones = torch.ones((1, 1) + hw, dtype=xc.dtype, device=xc.device)
                out = out / _window_sum(ones, ksize, strides, spans)
            else:
                out = out / float(ksize[0] * ksize[1])
    return {"Out": _from_nchw(out, fmt)}


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
@register_op("batch_norm", no_grad_set={"Mean", "Variance"})
def batch_norm(inputs, attrs, device):
    """reference: batch_norm_op.cc.  The statistics and the normalisation
    run in fp32 (at least) whatever X's type, and Y comes back in X's
    type: the AMP rewrite keeps Scale, Bias and the running stats fp32
    (``contrib/mixed_precision`` ``_KEEP_FP32_IN``).  Training uses the
    batch's biased variance and updates the running stats as
    ``momentum * old + (1 - momentum) * batch``, as the JAX op does
    (torch's own running-stat update differs in both); ``MeanOut`` and
    ``VarianceOut`` name the same vars as ``Mean`` and ``Variance``."""
    if attrs.get("sync_bn", False):
        raise NotImplementedError(
            "batch_norm with sync_bn reduces its statistics across devices; "
            "the multi-device slice of paddle_tpu_torch is not ported yet")
    x = one(inputs, "X")
    scale, bias = one(inputs, "Scale"), one(inputs, "Bias")
    mean, var = one(inputs, "Mean"), one(inputs, "Variance")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    caxis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != caxis)
    cshape = tuple(-1 if i == caxis else 1 for i in range(x.dim()))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    if attrs.get("is_test", False):
        use_mean, use_var = mean, var
        new_mean, new_var = mean, var
    else:
        use_var, use_mean = torch.var_mean(xf, dim=axes, correction=0)
        new_mean = momentum * mean + (1 - momentum) * use_mean
        new_var = momentum * var + (1 - momentum) * use_var
    gain = scale / torch.sqrt(use_var + eps)
    y = torch.addcmul(bias.reshape(cshape), xf - use_mean.reshape(cshape), gain.reshape(cshape))
    return {"Y": y.to(x.dtype), "MeanOut": new_mean, "VarianceOut": new_var,
            "SavedMean": use_mean, "SavedVariance": use_var}


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------
@register_op("dropout")
def dropout(inputs, attrs, device):
    """reference: dropout_op.cc, with the JAX op's semantics.  In
    ``is_test`` (or at p = 0) Out is X times 1 - p under
    ``downgrade_in_infer`` (X itself in is_test under
    ``upscale_in_train``) and Mask is ones.  In training the kept
    elements pass (divided by 1 - p under ``upscale_in_train``) and the
    rest are 0; Mask says which, in X's type.  The mask is a pure function
    of the ``seed`` attr (``kernels/dropout.py``), so the op is not a
    random op to the executor: its plans are captured like any other."""
    x = one(inputs, "X")
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    is_test = attrs.get("is_test", False)
    if is_test or p == 0.0:
        out = x
        if impl == "downgrade_in_infer":
            out = x * divisor(p, x.dtype)  # 1 - p in X's type, as the JAX op's weak scalar
        return {"Out": out, "Mask": torch.ones_like(x)}
    out, mask = dropout_train(x, p, attrs.get("seed", 0), impl == "upscale_in_train")
    return {"Out": out, "Mask": mask}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@register_op("cross_entropy", no_grad_set={"Label"})
def cross_entropy(inputs, attrs, device):
    """-log of the label's probability (X holds probabilities, the last
    axis the classes), with the JAX op's 1e-8 inside the log."""
    x, label = one(inputs, "X"), one(inputs, "Label")
    eps = 1e-8
    if attrs.get("soft_label", False):
        return {"Y": -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)}
    lbl = label.squeeze(-1) if label.dim() == x.dim() and label.shape[-1] == 1 else label
    picked = torch.gather(x, -1, lbl[..., None].long())
    return {"Y": -torch.log(picked + eps)}


@register_op("softmax_with_cross_entropy", no_grad_set={"Label"})
def softmax_with_cross_entropy(inputs, attrs, device):
    """Log-softmax and the picked label's negative log-probability; the
    gradient reaches ``Logits`` only."""
    logits = one(inputs, "Logits")
    label = one(inputs, "Label")
    axis = attrs.get("axis", -1)
    logp = F.log_softmax(logits, dim=axis)
    softmax_out = torch.exp(logp)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        if label.dim() == logits.dim() and label.shape[axis] == 1:
            lbl = label.squeeze(axis)
        else:
            lbl = label
        loss = -torch.gather(logp, axis, lbl[..., None].long())
        ignore = attrs.get("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(lbl[..., None] == ignore, 0.0, loss)
    return {"Softmax": softmax_out, "Loss": loss}


@register_op("sigmoid_cross_entropy_with_logits", no_grad_set={"Label"})
def sigmoid_cross_entropy_with_logits(inputs, attrs, device):
    """max(x, 0) - x * label + log1p(exp(-|x|)), the JAX package's
    formula: zero where the label is ``ignore_index``, and with
    ``normalize`` divided by the count of labels that are not (at least
    1).  Its gradient is sigmoid(x) - label at every x: at a tie
    ``torch.maximum`` gives x half its gradient and ``abs`` has slope 0,
    so at x = 0 it is 0.5 - label.  The JAX package's ``jnp.abs`` takes
    slope 1 there, so its gradient at a logit of exactly 0 (a model whose
    logits start at 0) is -label (ROADMAP queue C); elsewhere the two
    agree."""
    x = one(inputs, "X")
    label = one(inputs, "Label")
    loss = torch.maximum(x, torch.zeros_like(x)) - x * label + torch.log1p(torch.exp(-x.abs()))
    ignore = attrs.get("ignore_index", -100)
    kept = label != ignore
    loss = torch.where(kept, loss, torch.zeros_like(loss))
    if attrs.get("normalize", False):
        loss = loss / torch.clamp(kept.sum().to(loss.dtype), min=1.0)
    return {"Out": loss}


@register_op("square_error_cost", no_grad_set={"Y"})
def square_error_cost(inputs, attrs, device):
    d = one(inputs, "X") - one(inputs, "Y")
    return {"Out": d * d}


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
