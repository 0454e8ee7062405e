"""NN ops (the ported subset of the JAX package's ``ops/nn_ops.py``).

Reference kernels: operators/activation_op.cc, prelu_op.cc,
softmax_op.cc, log_softmax_op.cc, conv_op.cc, conv_transpose_op.cc,
pool_op.cc, batch_norm_op.cc, layer_norm_op.cc, group_norm_op.cc,
data_norm_op.cc, spectral_norm_op.h, cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc, sigmoid_cross_entropy_with_logits_op.cc,
huber_loss_op.cc, smooth_l1_loss_op.cc, log_loss_op.cc, norm_op.cc,
maxout_op.cc, interpolate_op.cc, pixel_shuffle_op.cc,
shuffle_channel_op.cc, bilinear_tensor_product_op.h, dropout_op.cc,
im2sequence_op.cc, warpctc_op.cc, lstm_unit_op.cc, gru_unit_op.cc,
sequence_ops/sequence_conv_op.cc, nce_op.cc, hierarchical_sigmoid_op.cc,
row_conv_op.h, and the fused attention op.  The fused attention op's
compute and gradient are the hand-written CUDA kernels behind
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

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels.dropout import divisor, dropout_train, philox4x32_10
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
_act("prelu_channel", lambda x, a: x)  # the JAX package's placeholder: prelu below computes


@register_op("prelu")
def prelu(inputs, attrs, device):
    """x where x > 0, else Alpha * x; Alpha is one value (``all``), one per
    channel of an NCHW x (``channel``) or one per element of a sample
    (``element``)."""
    x, alpha = one(inputs, "X"), one(inputs, "Alpha")
    if attrs.get("mode", "all") == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(x > 0, x, alpha * x)}


@register_op("softmax")
def softmax(inputs, attrs, device):
    return {"Out": F.softmax(one(inputs, "X"), dim=attrs.get("axis", -1))}


@register_op("log_softmax")
def log_softmax(inputs, attrs, device):
    return {"Out": F.log_softmax(one(inputs, "X"), dim=attrs.get("axis", -1))}


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


@register_op("depthwise_conv2d")
def depthwise_conv2d(inputs, attrs, device):
    """conv2d with one group per input channel."""
    x = one(inputs, "Input")
    fmt = attrs.get("data_format", "NCHW")
    return conv2d(inputs, dict(attrs, groups=x.shape[1] if fmt == "NCHW" else x.shape[-1]), device)


@register_op("conv2d_transpose")
def conv2d_transpose(inputs, attrs, device):
    """reference: conv_transpose_op.cc.  NCHW; the Filter is [in_c,
    out_c / groups, kh, kw], torch's own layout for it; the output size
    is (in - 1) * stride - 2 * pad + dilation * (k - 1) + 1."""
    return {"Output": F.conv_transpose2d(
        one(inputs, "Input"), one(inputs, "Filter"),
        stride=_pair(attrs.get("strides", [1, 1])),
        padding=_pair(attrs.get("paddings", [0, 0])),
        dilation=_pair(attrs.get("dilations", [1, 1])),
        groups=attrs.get("groups", 1))}


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


@register_op("group_norm")
def group_norm(inputs, attrs, device):
    """reference: group_norm_op.cc.  NCHW; each sample's channels in
    ``groups`` groups normalised by the group's mean and biased variance,
    in fp32 (at least); Y in X's type, Mean and Variance [N, groups]."""
    x = one(inputs, "X")
    scale, bias = maybe(inputs, "Scale"), maybe(inputs, "Bias")
    g = attrs.get("groups", 1)
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    xg = xg.to(torch.promote_types(xg.dtype, torch.float32))
    var, mean = torch.var_mean(xg, dim=tuple(range(2, xg.dim())), correction=0, keepdim=True)
    y = ((xg - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * (x.dim() - 2)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(n, g), "Variance": var.reshape(n, g)}


@register_op("spectral_norm", no_grad_set={"U", "V"})
def spectral_norm(inputs, attrs, device):
    """reference: operators/spectral_norm_op.h.  Weight over its largest
    singular value sigma, found by ``power_iters`` steps of the power
    iteration from U and V (v = Wᵀu / |Wᵀu|, u = Wv / |Wv|, sigma = uᵀWv),
    W being Weight with dim ``dim`` first, as a matrix.  U and V and
    each step's vectors are constants to the gradient, which reaches
    Weight through W and sigma, as the JAX op's stop_gradient has it."""
    w = one(inputs, "Weight")
    u = one(inputs, "U").reshape(-1).detach()
    v = one(inputs, "V").reshape(-1).detach()
    dim = int(attrs.get("dim", 0))
    eps = attrs.get("eps", 1e-12)
    perm = (dim,) + tuple(i for i in range(w.dim()) if i != dim)
    wmat = w.permute(*perm).reshape(w.shape[dim], -1)
    for _ in range(int(attrs.get("power_iters", 1))):
        v = wmat.T @ u
        v = (v / (torch.linalg.vector_norm(v) + eps)).detach()
        u = wmat @ v
        u = (u / (torch.linalg.vector_norm(u) + eps)).detach()
    sigma = u @ (wmat @ v)
    out = (wmat / sigma).reshape(tuple(w.shape[p] for p in perm))
    return {"Out": out.permute(*[int(i) for i in np.argsort(perm)])}


class _DataNorm(torch.autograd.Function):
    """Y = (X - BatchSum / BatchSize) * sqrt(BatchSize / BatchSquareSum).
    Its backward gives X the gradient through the scale, and the three
    statistics the reference's DataNormGradKernel cotangents (the JAX
    op's custom_vjp): N, sum(X) and sum((X - mean)^2) + N * epsilon per
    channel, so that the optimizer folds each batch's statistics in."""

    @staticmethod
    def forward(ctx, x, bsize, bsum, bsqsum, cshape, red, eps):
        means = bsum / bsize
        scales = torch.sqrt(bsize / bsqsum)
        ctx.save_for_backward(x, means, scales)
        ctx.cshape, ctx.red, ctx.eps = cshape, red, eps
        return (x - means.reshape(cshape)) * scales.reshape(cshape)

    @staticmethod
    def backward(ctx, gy):
        x, means, scales = ctx.saved_tensors
        n = x.shape[0]
        d_bsize = torch.full(means.shape, float(n), dtype=x.dtype, device=x.device)
        d_bsum = torch.sum(x, dim=ctx.red)
        d_bsqsum = torch.sum((x - means.reshape(ctx.cshape)) ** 2, dim=ctx.red) + d_bsize * ctx.eps
        return gy * scales.reshape(ctx.cshape), d_bsize, d_bsum, d_bsqsum, None, None, None


@register_op("data_norm")
def data_norm(inputs, attrs, device):
    """reference: operators/data_norm_op.cc, CTR data normalisation by the
    accumulated BatchSize, BatchSum and BatchSquareSum (trainable: their
    gradients carry the batch's statistics, ``_DataNorm``); the channel
    is dim 1 of an NCHW X of rank > 2, else the last dim."""
    x = one(inputs, "X")
    bsize, bsum, bsqsum = one(inputs, "BatchSize"), one(inputs, "BatchSum"), one(inputs, "BatchSquareSum")
    caxis = 1 if (attrs.get("data_layout", "NCHW") == "NCHW" and x.dim() > 2) else x.dim() - 1
    cshape = tuple(-1 if i == caxis else 1 for i in range(x.dim()))
    red = tuple(i for i in range(x.dim()) if i != caxis)
    y = _DataNorm.apply(x, bsize, bsum, bsqsum, cshape, red, float(attrs.get("epsilon", 1e-4)))
    return {"Y": y, "Means": bsum / bsize, "Scales": torch.sqrt(bsize / bsqsum)}


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


@register_op("huber_loss", no_grad_set={"Y"})
def huber_loss(inputs, attrs, device):
    """0.5 r^2 where |r| <= delta, else delta (|r| - delta / 2), r = Y - X;
    with the Residual r."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    return {"Out": torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta)),
            "Residual": r}


@register_op("smooth_l1_loss", no_grad_set={"Y"})
def smooth_l1_loss(inputs, attrs, device):
    """Per row, the sum of 0.5 (sigma d)^2 where |d| < 1 / sigma^2, else
    |d| - 0.5 / sigma^2, d = X - Y, as [N, 1]; with Diff d.  The inside
    and outside weights are not read, as in the JAX op."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    sigma2 = attrs.get("sigma", 1.0) ** 2
    d = x - y
    ad = torch.abs(d)
    out = torch.where(ad < 1.0 / sigma2, 0.5 * d * d * sigma2, ad - 0.5 / sigma2)
    return {"Out": torch.sum(out, dim=tuple(range(1, out.dim())), keepdim=True).reshape(x.shape[0], 1),
            "Diff": d}


@register_op("log_loss", no_grad_set={"Labels"})
def log_loss(inputs, attrs, device):
    p, y = one(inputs, "Predicted"), one(inputs, "Labels")
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -y * torch.log(p + eps) - (1 - y) * torch.log(1 - p + eps)}


# ---------------------------------------------------------------------------
# norms, maxout, resize and the pixel reorderings
# ---------------------------------------------------------------------------
@register_op("l2_normalize")
def l2_normalize(inputs, attrs, device):
    """X over sqrt(sum(X^2) + epsilon) along ``axis``; with that Norm."""
    x = one(inputs, "X")
    norm = torch.sqrt(torch.sum(x * x, dim=attrs.get("axis", -1), keepdim=True)
                      + attrs.get("epsilon", 1e-10))
    return {"Out": x / norm, "Norm": norm}


@register_op("norm")
def norm(inputs, attrs, device):
    return l2_normalize(inputs, attrs, device)


@register_op("maxout")
def maxout(inputs, attrs, device):
    """The largest of each ``groups`` consecutive channels (NCHW)."""
    x = one(inputs, "X")
    g = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": torch.amax(x.reshape(n, c // g, g, h, w), dim=2)}


def _interp(inputs, attrs, method):
    """reference: operators/interpolate_op.cc, NCHW, to ``out_h`` x
    ``out_w`` (or ``scale`` times H and W).  ``align_corners`` (the
    default) maps corner to corner, src = dst (in - 1) / (out - 1), and an
    axis of output size 1 samples coordinate 0; nearest rounds half to
    even, as ``jnp.round``.  Without it, half-pixel sampling as
    ``jax.image.resize``'s (which antialiases when it shrinks a bilinear
    axis)."""
    x = one(inputs, "X")
    if maybe(inputs, "OutSize") is not None:
        raise NotImplementedError("dynamic OutSize tensor; pass out_h/out_w attrs")
    out_h, out_w = int(attrs.get("out_h", 0)), int(attrs.get("out_w", 0))
    scale = attrs.get("scale", 0)
    n, c, h, w = x.shape
    if out_h <= 0 or out_w <= 0:
        if not scale:
            raise ValueError("interpolate needs out_h/out_w or scale")
        out_h, out_w = int(h * scale), int(w * scale)
    if not attrs.get("align_corners", True):
        if method == "nearest":
            out = F.interpolate(x, size=(out_h, out_w), mode="nearest-exact")
        else:
            out = F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=False,
                                antialias=out_h < h or out_w < w)
        return {"Out": out.to(x.dtype)}
    ratio_h = (h - 1) / (out_h - 1) if out_h > 1 else 0.0
    ratio_w = (w - 1) / (out_w - 1) if out_w > 1 else 0.0
    ys = torch.arange(out_h, dtype=torch.float32, device=x.device) * ratio_h
    xs = torch.arange(out_w, dtype=torch.float32, device=x.device) * ratio_w
    if method == "nearest":
        out = x.index_select(2, torch.round(ys).long()).index_select(3, torch.round(xs).long())
        return {"Out": out}
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    y1, x1 = torch.clamp(y0 + 1, 0, h - 1), torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0).reshape(1, 1, -1, 1)
    wx = (xs - x0).reshape(1, 1, 1, -1)
    rows0, rows1 = x.index_select(2, y0), x.index_select(2, y1)
    out = (rows0.index_select(3, x0) * (1 - wy) * (1 - wx) + rows0.index_select(3, x1) * (1 - wy) * wx
           + rows1.index_select(3, x0) * wy * (1 - wx) + rows1.index_select(3, x1) * wy * wx)
    return {"Out": out.to(x.dtype)}


@register_op("bilinear_interp")
def bilinear_interp(inputs, attrs, device):
    return _interp(inputs, attrs, "bilinear")


@register_op("nearest_interp")
def nearest_interp(inputs, attrs, device):
    return _interp(inputs, attrs, "nearest")


@register_op("pixel_shuffle")
def pixel_shuffle(inputs, attrs, device):
    """reference: operators/pixel_shuffle_op.cc: [N, C r^2, H, W] to
    [N, C, H r, W r]."""
    x = one(inputs, "X")
    r = int(attrs.get("upscale_factor", 1))
    n, c, h, w = x.shape
    oc = c // (r * r)
    return {"Out": x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3).reshape(n, oc, h * r, w * r)}


@register_op("shuffle_channel")
def shuffle_channel(inputs, attrs, device):
    """reference: operators/shuffle_channel_op.cc: the channels as a
    [group, C / group] grid, transposed."""
    x = one(inputs, "X")
    g = int(attrs.get("group", 1))
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, g, c // g, h, w).transpose(1, 2).reshape(n, c, h, w)}


@register_op("bilinear_tensor_product")
def bilinear_tensor_product(inputs, attrs, device):
    """reference: operators/bilinear_tensor_product_op.h: out[b, k] =
    x[b]ᵀ W[k] y[b] (+ Bias [1, K])."""
    x, y, w = one(inputs, "X"), one(inputs, "Y"), one(inputs, "Weight")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    bias = maybe(inputs, "Bias")
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": out}


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


# ---------------------------------------------------------------------------
# the sequence, RNN-unit and sampled-loss ops (reference:
# operators/im2sequence_op.cc, warpctc_op.cc, lstm_unit_op.cc,
# gru_unit_op.cc, sequence_ops/sequence_conv_op.cc, nce_op.cc,
# hierarchical_sigmoid_op.cc, row_conv_op.h)
# ---------------------------------------------------------------------------
def _seq_mask(seq_len, T, device):
    """[B, T] validity of each padded position, from lengths [B]."""
    return torch.arange(T, device=device)[None, :] < seq_len.reshape(-1, 1)


@register_op("im2sequence")
def im2sequence(inputs, attrs, device):
    """Each ``kernels`` patch of X [N, C, H, W] at ``strides``, no
    padding, as a row [N·oh·ow, C·kh·kw] in (c, kh, kw) order:
    ``F.unfold``'s order, and ``conv_general_dilated_patches``'s."""
    x = one(inputs, "X")
    kh, kw = _pair(attrs.get("kernels", [1, 1]))
    sh, sw = _pair(attrs.get("strides", [1, 1]))
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))  # [N, C·kh·kw, oh·ow]
    return {"Out": patches.transpose(1, 2).reshape(-1, patches.shape[1])}


_CTC_NEG = -1e30  # log 0 that stays finite: an infeasible alignment costs ~1e30, not inf


class _LogAddExp(torch.autograd.Function):
    """log(e^a + e^b) with ``jnp.logaddexp``'s derivative, g·e^(a − out)
    and g·e^(b − out).  Where two "log 0"s of -1e30 meet, out rounds to
    them in fp32 and each side takes the whole g (torch's own rule gives
    each half): an infeasible alignment's gradient is the JAX op's."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


@register_op("warpctc", no_grad_set={"Label", "LogitsLength", "LabelLength"})
def warpctc(inputs, attrs, device):
    """CTC loss [B, 1] of padded logits [B, T, C] against labels [B, L]:
    the log-space alpha recursion over the blank-extended label, one step
    of torch ops per time step (nothing read on the host, so a plan
    holding it captures), differentiated through ``log_softmax`` by
    autograd.  ``LogitsLength`` / ``LabelLength`` [B] default to T and L;
    ``norm_by_times`` divides by the logit length.  ``F.ctc_loss`` gives
    ``inf`` on an infeasible alignment, where this op's log 0 is -1e30."""
    logits = one(inputs, "Logits")
    label = one(inputs, "Label").long()
    B, T, _ = logits.shape
    L = label.shape[1]
    logit_len, label_len = maybe(inputs, "LogitsLength"), maybe(inputs, "LabelLength")
    dev = logits.device
    logit_len = (torch.full((B,), T, dtype=torch.long, device=dev) if logit_len is None
                 else logit_len.reshape(B).long())
    label_len = (torch.full((B,), L, dtype=torch.long, device=dev) if label_len is None
                 else label_len.reshape(B).long())
    blank = int(attrs.get("blank", 0))
    logp = F.log_softmax(logits.float(), dim=-1)
    S = 2 * L + 1
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long, device=dev), ext[:, :-2]], 1)
    skip_ok = (ext != blank) & (ext != prev2)
    cols = [logp[:, 0, blank:blank + 1]]
    if S > 1:
        cols.append(torch.gather(logp[:, 0, :], 1, ext[:, 1:2]))
    cols.append(torch.full((B, S - len(cols)), _CTC_NEG, dtype=torch.float32, device=dev))
    alpha = torch.cat(cols, 1)

    def shift(a, k):
        return torch.cat([torch.full((B, k), _CTC_NEG, dtype=a.dtype, device=dev), a[:, :-k]], 1)

    for t in range(1, T):
        lp_t = torch.gather(logp[:, t, :], 1, ext)
        m = _LogAddExp.apply(alpha, shift(alpha, 1))
        m = torch.where(skip_ok, _LogAddExp.apply(m, shift(alpha, 2)), m)
        alpha = torch.where((t < logit_len)[:, None], m + lp_t, alpha)
    last = (2 * label_len)[:, None]
    a_last = torch.gather(alpha, 1, last)[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(last - 1, min=0))[:, 0]
    loss = -torch.where(label_len > 0, _LogAddExp.apply(a_last, a_prev), a_last)
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logit_len.float(), min=1.0)
    return {"Loss": loss.reshape(B, 1).to(logits.dtype)}


@register_op("lstm_unit")
def lstm_unit(inputs, attrs, device):
    """One LSTM step: X [B, 4H] the pre-activation gates (i, f, c, o),
    C_prev [B, H]; C = σ(f + forget_bias)·C_prev + σ(i)·tanh(c),
    H = σ(o)·tanh(C)."""
    x, c_prev = one(inputs, "X"), one(inputs, "C_prev")
    i, f, c_hat, o = torch.chunk(x, 4, dim=-1)
    c = (torch.sigmoid(f + attrs.get("forget_bias", 0.0)) * c_prev
         + torch.sigmoid(i) * torch.tanh(c_hat))
    return {"C": c, "H": torch.sigmoid(o) * torch.tanh(c)}


@register_op("gru_unit")
def gru_unit(inputs, attrs, device):
    """One GRU step: Input [B, 3H] (update, reset, candidate), HiddenPrev
    [B, H], Weight [H, 3H] (the first 2H columns for the gates, the last H
    for the candidate), Bias [1, 3H]; Gate = [u, r, c], ResetHiddenPrev =
    r·h_prev, Hidden = u·h_prev + (1 − u)·c.  That is the form upstream
    calls ``origin_mode=True``; the JAX package's layer passes no attrs, so
    the op always computes it (ROADMAP queue C)."""
    x, h_prev, w = one(inputs, "Input"), one(inputs, "HiddenPrev"), one(inputs, "Weight")
    b = maybe(inputs, "Bias")
    H = h_prev.shape[-1]
    if b is not None:
        x = x + b.reshape(1, 3 * H)
    u = torch.sigmoid(x[:, :H] + h_prev @ w[:, :H])
    r = torch.sigmoid(x[:, H:2 * H] + h_prev @ w[:, H:2 * H])
    c = torch.tanh(x[:, 2 * H:] + (r * h_prev) @ w[:, 2 * H:])
    return {"Gate": torch.cat([u, r, c], dim=-1), "ResetHiddenPrev": r * h_prev,
            "Hidden": u * h_prev + (1.0 - u) * c}


@register_op("sequence_conv", no_grad_set={"SeqLen"})
def sequence_conv(inputs, attrs, device):
    """Context-window convolution over padded sequences: X [B, T, D],
    Filter [ctx·D, F] -> [B, T, F].  The window is ``contextLength`` rows
    from ``contextStart`` on (defaults 3 and -1); rows past a sequence's
    end are zero before the window shifts and again on the output.  The
    [B, T, ctx·D] context is built with ``F.pad`` and slices and
    multiplied by the filter with ``torch.matmul``."""
    x, w = one(inputs, "X"), one(inputs, "Filter")
    seq_len = maybe(inputs, "SeqLen")
    start = int(attrs.get("contextStart", attrs.get("context_start", -1)))
    length = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    B, T, _ = x.shape
    valid = None
    if seq_len is not None:
        valid = _seq_mask(seq_len, T, x.device)[:, :, None]
        x = torch.where(valid, x, 0.0)
    cols = []
    for j in range(start, start + length):
        if j < 0:
            cols.append(F.pad(x, (0, 0, -j, 0))[:, :T])
        elif j > 0:
            cols.append(F.pad(x, (0, 0, 0, j))[:, j:])
        else:
            cols.append(x)
    out = torch.matmul(torch.cat(cols, dim=-1), w)
    if valid is not None:
        out = torch.where(valid, out, 0.0)
    return {"Out": out}


@register_op("row_conv", no_grad_set={"SeqLen"})
def row_conv(inputs, attrs, device):
    """Lookahead convolution (Deep Speech 2): out[t] = Σ_j x[t+j]·filter[j]
    over Filter [k, D], zero past each sequence's end."""
    x, filt = one(inputs, "X"), one(inputs, "Filter")
    seq_len = maybe(inputs, "SeqLen")
    k = filt.shape[0]
    B, T, _ = x.shape
    if seq_len is not None:
        x = x * _seq_mask(seq_len, T, x.device).to(x.dtype)[:, :, None]
    xpad = F.pad(x, (0, 0, 0, k))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + xpad[:, j:j + T, :] * filt[j][None, None, :]
    return {"Out": out}


@register_op("hierarchical_sigmoid", no_grad_set={"Label", "PathTable", "PathCode"})
def hierarchical_sigmoid(inputs, attrs, device):
    """Hierarchical sigmoid loss [B, 1] of X [B, D] over W's tree nodes
    (Bias optional).  Default tree: the complete binary tree of
    ``num_classes`` leaves in heap order, the leaf's code label + K, at
    each of ceil(log2 K) + 1 levels the node code // 2 − 1 and the bit
    code % 2.  Custom tree: PathTable [B, L] the nodes (-1 pads) and
    PathCode [B, L] the bits.  PreOut equals Out, as the JAX op gives it."""
    x, w = one(inputs, "X"), one(inputs, "W")
    b = maybe(inputs, "Bias")
    ptable, pcode = maybe(inputs, "PathTable"), maybe(inputs, "PathCode")
    if ptable is not None:
        if pcode is None:
            raise ValueError("hierarchical_sigmoid: PathTable without PathCode")
        node = torch.clamp(ptable, min=0).long()
        logit = torch.einsum("bd,bld->bl", x, w[node])
        if b is not None:
            logit = logit + b.reshape(-1)[node]
        sign = 2.0 * pcode.float() - 1.0
        total = torch.sum(torch.where(ptable >= 0, _softplus(-sign * logit, None), 0.0), dim=1)
        return {"Out": total.reshape(-1, 1), "PreOut": total.reshape(-1, 1)}
    code = one(inputs, "Label").reshape(-1).long()
    K = int(attrs["num_classes"])
    code = code + K  # the leaf's heap code
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for _ in range(max(1, int(np.ceil(np.log2(K))) + 1)):
        node = torch.clamp(code // 2 - 1, min=0)
        logit = torch.sum(x * w[node], dim=-1)
        if b is not None:
            logit = logit + b.reshape(-1)[node]
        sign = 2.0 * (code % 2).float() - 1.0  # bit 1 = the right child
        total = total + torch.where(code > 1, _softplus(-sign * logit, None), 0.0)
        code = code // 2
    return {"Out": total.reshape(-1, 1), "PreOut": total.reshape(-1, 1)}


_DIST_CACHE = {}


def _custom_dist(dist, device):
    """``custom_dist`` normalised, on ``device``.  Kept per (values,
    device), so that only the first run copies it there: a capture
    refuses a host copy."""
    arr = np.ascontiguousarray(np.asarray(dist, dtype=np.float32).reshape(-1))
    key = (str(device), arr.tobytes())
    probs = _DIST_CACHE.get(key)
    if probs is None:
        probs = torch.from_numpy(arr).to(device)
        probs = probs / torch.sum(probs)
        _DIST_CACHE[key] = probs
    return probs


def nce_negatives(label_sum, seed, k, V, sampler="uniform", probs=None):
    """The ``k`` negative ids [..., k] (int64) that ``nce`` draws for a
    batch whose labels sum to ``label_sum`` (an int64 tensor; one draw for
    each of its elements).  The words are Philox4x32-10 (the dropout
    kernel's generator) with key (the ``seed`` attr, 12345 where it is 0;
    ``label_sum`` mod 2**32) and counter (i // 4, 0, 0, 0), so the same
    labels give the same negatives, on either device, and nothing is read
    on the host.  ``uniform``: (word·V) >> 32; ``log_uniform``:
    floor(exp(u·log(V + 1))) − 1 with u the word's top 24 bits over 2**24
    (the reference's LogUniformSampler); ``custom_dist``: the inverse CDF
    of ``probs`` at u."""
    key1 = (label_sum.long() & 0xFFFFFFFF)[..., None]
    ctr = torch.arange((k + 3) // 4, dtype=torch.int64, device=label_sum.device)
    zero = torch.zeros_like(ctr)
    words = philox4x32_10([ctr, zero, zero, zero], ((int(seed) or 12345) & 0xFFFFFFFF, key1))
    words = torch.stack([torch.broadcast_to(w, key1.shape[:-1] + ctr.shape) for w in words],
                        dim=-1).reshape(key1.shape[:-1] + (-1,))[..., :k]
    if sampler == "uniform":
        return (words * V) >> 32
    # float64, so that the card's and the CPU's roundings of exp and of the
    # CDF's sums (1e-16 apart) flip no id at a class boundary
    u = (words >> 8).double() * (1.0 / (1 << 24))
    if sampler == "log_uniform":
        return torch.clamp(torch.exp(u * math.log(V + 1.0)).long() - 1, 0, V - 1)
    return torch.clamp(torch.searchsorted(torch.cumsum(probs.double(), 0), u), 0, V - 1)


def nce_cost(x, label, w, b, sample_weight, neg, k, sampler="uniform", probs=None):
    """NCE's cost [B, 1] given its negatives ``neg`` [k], term for term the
    JAX op's: softplus(−(s_true − log kP(true))) + Σ softplus(s_neg −
    log kP(neg)), scaled by ``sample_weight``; s = x·w[id] (+ b[id])."""
    V = w.shape[0]
    if sampler == "custom_dist":
        logp_all = torch.log(torch.clamp(probs, min=1e-30))
        log_kp_true = math.log(k) + logp_all[label]
        log_kp_neg = math.log(k) + logp_all[neg]
    elif sampler == "log_uniform":
        def logp(c):  # log1p keeps precision once c + 1 passes 2**24
            return torch.log(torch.log1p(1.0 / (c.float() + 1.0)) / math.log(V + 1.0))

        log_kp_true = math.log(k) + logp(label)
        log_kp_neg = math.log(k) + logp(neg)
    else:
        log_kp_true = torch.full(label.shape, math.log(k / V), device=x.device)
        log_kp_neg = torch.full(neg.shape, math.log(k / V), device=x.device)
    true_logit = torch.sum(x * w[label], dim=-1)
    neg_logit = x @ w[neg].T  # [B, k]
    if b is not None:
        true_logit = true_logit + b.reshape(-1)[label]
        neg_logit = neg_logit + b.reshape(-1)[neg][None, :]
    cost = (_softplus(-(true_logit - log_kp_true), None)
            + torch.sum(_softplus(neg_logit - log_kp_neg[None, :], None), dim=-1))
    if sample_weight is not None:
        cost = cost * sample_weight.reshape(-1)
    return cost.reshape(-1, 1)


@register_op("nce", no_grad_set={"Label", "SampleWeight"})
def nce(inputs, attrs, device):
    """Noise-contrastive estimation: Input [B, D], Label [B, 1], Weight
    [V, D], Bias [V], SampleWeight [B, 1] -> Cost [B, 1]; ``num_neg_samples``
    negatives from ``sampler`` (``nce_negatives``), costed by ``nce_cost``.
    The draw is a pure function of the seed attr and the labels' sum, as the
    JAX op's (whose bits, jax.random's, differ): so the op is not a random
    op, a plan holding it captures, and the generic vjp's recompute sees
    the forward's negatives."""
    x, w = one(inputs, "Input"), one(inputs, "Weight")
    label = one(inputs, "Label").reshape(-1).long()
    k = int(attrs.get("num_neg_samples", 10))
    sampler = attrs.get("sampler", "uniform")
    probs = _custom_dist(attrs["custom_dist"], x.device) if sampler == "custom_dist" else None
    neg = nce_negatives(label.sum(), attrs.get("seed", 0), k, w.shape[0], sampler, probs)
    return {"Cost": nce_cost(x, label, w, maybe(inputs, "Bias"), maybe(inputs, "SampleWeight"),
                             neg, k, sampler, probs)}
