"""Optimizer update ops (the slice's subset of the JAX package's
``ops/optimizer_ops.py``).

Reference kernels:
paddle/fluid/operators/optimizers/{sgd,momentum,adam}_op.cc.
Each is a pure function of its inputs, like the JAX op: the outputs name
the same vars as the state inputs (``ParamOut`` is ``Param``), and the
executor writes them back to the scope after the block has run.  All
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


@register_op("momentum", differentiable=False)
def momentum(inputs, attrs, device):
    """v = mu * v + g; p -= lr * v, or with Nesterov p -= lr * (g + mu * v)."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    v = one(inputs, "Velocity")
    lr = one(inputs, "LearningRate").reshape(()).to(p.dtype)
    mu = attrs.get("mu", 0.9)
    v_new = mu * v + g
    if attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


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
