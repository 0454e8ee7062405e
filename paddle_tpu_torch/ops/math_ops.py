"""Math ops (the slice's subset of the JAX package's ``ops/math_ops.py``).

Reference kernels: paddle/fluid/operators/mul_op.cc, matmul_op.cc,
sum_op.cc, mean_op.cc, scale_op.cc, operators/elementwise/*.  ``mul`` and ``matmul``
are plain matrix products through ``torch.matmul``; on the TPU they were
XLA's, not Pallas kernels.
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
# Y's dims align to X starting at `axis`)
# ---------------------------------------------------------------------------
def _bcast_y(x, y, attrs):
    axis = attrs.get("axis", -1)
    if x.dim() == y.dim() or y.dim() == 0:
        return y
    if axis == -1:
        axis = x.dim() - y.dim()
    shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        shape[axis + i] = s
    return y.reshape(shape)


@register_op("elementwise_add")
def elementwise_add(inputs, attrs, device):
    x, y = one(inputs, "X"), one(inputs, "Y")
    return {"Out": x + _bcast_y(x, y, attrs)}


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


@register_op("mean")
def mean(inputs, attrs, device):
    return {"Out": torch.mean(one(inputs, "X"))}
