"""Math ops, as the JAX package's ``ops/math_ops.py`` has them.

Reference kernels: paddle/fluid/operators/mul_op.cc, matmul_op.cc,
sum_op.cc, mean_op.cc, scale_op.cc, clip_op.cc, clip_by_norm_op.cc,
operators/elementwise/*, reduce_ops/*, activation_op.cc (the unary
math and pow), controlflow/compare_op.cc, logical_op.cc and
isfinite_op.cc.  ``mul`` and
``matmul`` are plain matrix products through ``torch.matmul``; on the
TPU they were XLA's, not Pallas kernels, as every op here was.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one


@register_op("matmul")
def matmul(inputs, attrs, device):
    x, y = one(inputs, "X"), one(inputs, "Y")
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("mul")
def mul(inputs, attrs, device):
    """FC matmul: flattens X/Y to 2-D (reference: mul_op.cc)."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape(int(np.prod(xs[:xnc])), int(np.prod(xs[xnc:])))
    y2 = y.reshape(int(np.prod(ys[:ync])), int(np.prod(ys[ync:])))
    out = x2 @ y2
    return {"Out": out.reshape(xs[:xnc] + ys[ync:])}


# ---------------------------------------------------------------------------
# elementwise with axis-based broadcasting (reference: elementwise_op_function.h:
# the operand with fewer dims aligns to the other starting at `axis`)
# ---------------------------------------------------------------------------
def _align(small, big, axis):
    if small.dim() == big.dim() or small.dim() == 0:
        return small
    if axis == -1:
        axis = big.dim() - small.dim()
    shape = [1] * big.dim()
    for i, s in enumerate(small.shape):
        shape[axis + i] = s
    return small.reshape(shape)


def _ew(name, fn):
    """Y's dims align to X's from ``axis`` (-1: X's trailing dims).  Where
    X has fewer dims than Y, X aligns to Y the same way, as the
    reference's elementwise_op_function.h does; the JAX package's kernel
    aligns only Y and raises there (``GradientClipByGlobalNorm``'s
    0-d norm against its [1] clip constant, or ``scalar / x``)."""
    @register_op(name)
    def kernel(inputs, attrs, device, _fn=fn):
        x, y = one(inputs, "X"), one(inputs, "Y")
        axis = attrs.get("axis", -1)
        if x.dim() < y.dim():
            return {"Out": _fn(_align(x, y, axis), y)}
        return {"Out": _fn(x, _align(y, x, axis))}

    return kernel


_ew("elementwise_add", lambda x, y: x + y)
_ew("elementwise_sub", lambda x, y: x - y)
_ew("elementwise_mul", lambda x, y: x * y)
_ew("elementwise_div", lambda x, y: x / y)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_pow", lambda x, y: x ** y)
class _FloorDiv(torch.autograd.Function):
    """torch.floor_divide with the zero gradient jnp's floor_divide has
    (torch gives the op no derivative)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.shapes = (x.shape, y.shape)
        return torch.floor_divide(x, y)

    @staticmethod
    def backward(ctx, g):
        return g.new_zeros(ctx.shapes[0]), g.new_zeros(ctx.shapes[1])


# the sign rules of Python's % and // (the divisor's sign; rounding to
# -inf), as jnp's
_ew("elementwise_mod", torch.remainder)
_ew("elementwise_floordiv", _FloorDiv.apply)


@register_op("scale")
def scale(inputs, attrs, device):
    """x * scale + bias (or (x + bias) * scale), in X's dtype.  For a
    bf16 X, scale and bias are first rounded to bf16 and each step rounds
    to bf16, as the JAX package's weakly typed scalars do."""
    x = one(inputs, "X")
    s = float(attrs.get("scale", 1.0))
    b = float(attrs.get("bias", 0.0))
    if x.dtype in (torch.bfloat16, torch.float16):
        s, b = (float(torch.tensor(v, dtype=x.dtype)) for v in (s, b))
    out = x * s + b if attrs.get("bias_after_scale", True) else (x + b) * s
    return {"Out": out.to(x.dtype)}


@register_op("sum")
def sum_op(inputs, attrs, device):
    """N-ary add: the grad-aggregation op (reference: operators/sum_op.cc)."""
    vals = inputs["X"]
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return {"Out": out}


@register_op("clip")
def clip(inputs, attrs, device):
    return {"Out": torch.clamp(one(inputs, "X"), attrs.get("min"), attrs.get("max"))}


@register_op("clip_by_norm")
def clip_by_norm(inputs, attrs, device):
    """X scaled down to an L2 norm of at most ``max_norm``."""
    x = one(inputs, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(x * x))
    return {"Out": x * (max_norm / torch.clamp(norm, min=max_norm))}


# ---------------------------------------------------------------------------
# unary math (reference: operators/activation_op.cc registers these too)
# ---------------------------------------------------------------------------
def _unary(name, fn):
    @register_op(name)
    def kernel(inputs, attrs, device, _fn=fn):
        return {"Out": _fn(one(inputs, "X"))}

    return kernel


_unary("sqrt", torch.sqrt)
_unary("rsqrt", lambda x: 1.0 / torch.sqrt(x))
_unary("square", lambda x: x * x)
_unary("exp", torch.exp)
_unary("log", torch.log)
_unary("abs", torch.abs)
_unary("ceil", torch.ceil)
_unary("floor", torch.floor)
_unary("round", torch.round)  # half to even, as jnp.round
_unary("reciprocal", lambda x: 1.0 / x)
_unary("sign", torch.sign)
_unary("cos", torch.cos)
_unary("sin", torch.sin)
_unary("logsigmoid", lambda x: -torch.logaddexp(torch.zeros_like(x), -x))


@register_op("pow")
def pow_op(inputs, attrs, device):
    return {"Out": one(inputs, "X") ** attrs.get("factor", 1.0)}


# ---------------------------------------------------------------------------
# reductions (reference: operators/reduce_ops/)
# ---------------------------------------------------------------------------
def _prod(x, dims, keep):
    # torch.prod takes one dim at a time; an integer product keeps X's type
    out = x
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keep)
    return out.to(x.dtype)


def _reduce(name, fn):
    """Over ``dim`` (negative dims count from the end), or every dim
    with ``reduce_all``; ``keep_dim`` keeps the reduced dims as 1."""
    @register_op(name)
    def kernel(inputs, attrs, device, _fn=fn):
        x = one(inputs, "X")
        dims = attrs.get("dim", [0])
        if attrs.get("reduce_all", False) or dims is None:
            dims = range(x.dim())
        elif isinstance(dims, int):
            dims = [dims]
        return {"Out": _fn(x, tuple(d % x.dim() for d in dims), attrs.get("keep_dim", False))}

    return kernel


_reduce("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
_reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
# amax / amin share the gradient equally among tied maxima, as jnp.max's
_reduce("reduce_max", lambda x, d, k: torch.amax(x, dim=d, keepdim=k))
_reduce("reduce_min", lambda x, d, k: torch.amin(x, dim=d, keepdim=k))
_reduce("reduce_prod", _prod)
_reduce("reduce_all", lambda x, d, k: torch.all(x, dim=d, keepdim=k))
_reduce("reduce_any", lambda x, d, k: torch.any(x, dim=d, keepdim=k))


@register_op("mean")
def mean(inputs, attrs, device):
    return {"Out": torch.mean(one(inputs, "X"))}


# ---------------------------------------------------------------------------
# comparisons / logical (reference: operators/controlflow/compare_op.cc)
# ---------------------------------------------------------------------------
def _cmp(name, fn):
    @register_op(name, differentiable=False)
    def kernel(inputs, attrs, device, _fn=fn):
        return {"Out": _fn(one(inputs, "X"), one(inputs, "Y"))}

    return kernel


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)


@register_op("logical_not", differentiable=False)
def logical_not(inputs, attrs, device):
    return {"Out": torch.logical_not(one(inputs, "X"))}


@register_op("isfinite", differentiable=False)
def isfinite(inputs, attrs, device):
    """Whether every element of X is finite, as a [1] bool."""
    return {"Out": torch.isfinite(one(inputs, "X")).all().reshape(1)}
