"""Optimizer update ops (the slice's subset of the JAX package's
``ops/optimizer_ops.py``).

Reference kernels: paddle/fluid/operators/optimizers/{sgd,adam}_op.cc.
Each is a pure function of its inputs, like the JAX op: the outputs name
the same vars as the state inputs (``ParamOut`` is ``Param``), and the
executor writes them back to the scope after the block has run.  Both
are non-differentiable.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one


@register_op("sgd", differentiable=False)
def sgd(inputs, attrs, device):
    p = one(inputs, "Param")
    g = one(inputs, "Grad")
    lr = one(inputs, "LearningRate")
    return {"ParamOut": p - lr.reshape(()).to(p.dtype) * g}


@register_op("adam", differentiable=False)
def adam(inputs, attrs, device):
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m, v = one(inputs, "Moment1"), one(inputs, "Moment2")
    b1p = one(inputs, "Beta1Pow").reshape(())
    b2p = one(inputs, "Beta2Pow").reshape(())
    lr = one(inputs, "LearningRate").reshape(()).to(p.dtype)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    return {
        "ParamOut": p_new,
        "Moment1Out": m_new,
        "Moment2Out": v_new,
        "Beta1PowOut": b1p * b1,
        "Beta2PowOut": b2p * b2,
    }
