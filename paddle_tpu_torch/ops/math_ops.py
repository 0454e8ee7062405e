"""Math ops (the slice's subset of the JAX package's ``ops/math_ops.py``).

Reference kernels: paddle/fluid/operators/mul_op.cc,
operators/elementwise/*.  ``mul`` is a plain matrix product through
``torch.matmul``; on the TPU it was XLA's, not a Pallas kernel.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one


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
