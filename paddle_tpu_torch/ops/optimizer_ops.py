"""Optimizer update ops: the port of the JAX package's
``ops/optimizer_ops.py``.

Reference kernels: paddle/fluid/operators/optimizers/{sgd,momentum,adam,
adamax,adagrad,decayed_adagrad,adadelta,rmsprop,ftrl,lamb,
lars_momentum}_op.cc, operators/average_accumulates_op.cc and
operators/dgc_op.cc.  Each is a pure function of its inputs with the
JAX op's formula: the outputs name the same vars as the state inputs
(``ParamOut`` is ``Param``), and the executor writes them back to the
scope after the block has run.  All are non-differentiable.  A choice
that depends on the data (a norm that is zero, a window that restarts,
DGC's dense phase) is a ``torch.where``, never a Python branch on a
tensor: a captured step cannot read a value back to the host.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one


def _lr(inputs, p):
    return one(inputs, "LearningRate").reshape(()).to(p.dtype)


@register_op("sgd", differentiable=False)
def sgd(inputs, attrs, device):
    p = one(inputs, "Param")
    g = one(inputs, "Grad")
    return {"ParamOut": p - _lr(inputs, p) * g}


@register_op("momentum", differentiable=False)
def momentum(inputs, attrs, device):
    """v = mu * v + g; p -= lr * v, or with Nesterov p -= lr * (g + mu * v)."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    v = one(inputs, "Velocity")
    lr = _lr(inputs, p)
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
    lr = _lr(inputs, p)
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


@register_op("lars_momentum", differentiable=False)
def lars_momentum(inputs, attrs, device):
    """Momentum with a layer-wise rate: local_lr = coeff * |p| / (|g| +
    decay * |p|), 1 where a norm is 0; v = mu * v + lr * local_lr * (g +
    decay * p); p -= v."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    v = one(inputs, "Velocity")
    lr = _lr(inputs, p)
    mu = attrs.get("mu", 0.9)
    coeff = attrs.get("lars_coeff", 0.001)
    decay = attrs.get("lars_weight_decay", 0.0005)
    pn = torch.sqrt(torch.sum(p * p))
    gn = torch.sqrt(torch.sum(g * g))
    local_lr = torch.where(pn > 0, torch.where(gn > 0, coeff * pn / (gn + decay * pn), 1.0), 1.0)
    v_new = mu * v + lr * local_lr * (g + decay * p)
    return {"ParamOut": p - v_new, "VelocityOut": v_new}


@register_op("adamax", differentiable=False)
def adamax(inputs, attrs, device):
    """m = b1 * m + (1 - b1) * g; u = max(b2 * u, |g|);
    p -= lr / (1 - b1^t) * m / (u + eps).  Beta1Pow advances in a scale
    op the optimizer appends after all the updates."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m, inf = one(inputs, "Moment"), one(inputs, "InfNorm")
    b1p = one(inputs, "Beta1Pow").reshape(())
    lr = _lr(inputs, p)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_new = b1 * m + (1 - b1) * g
    inf_new = torch.maximum(b2 * inf, torch.abs(g))
    p_new = p - (lr / (1 - b1p)) * (m_new / (inf_new + eps))
    return {"ParamOut": p_new, "MomentOut": m_new, "InfNormOut": inf_new}


@register_op("adagrad", differentiable=False)
def adagrad(inputs, attrs, device):
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m = one(inputs, "Moment")
    lr = _lr(inputs, p)
    eps = attrs.get("epsilon", 1e-6)
    m_new = m + g * g
    return {"ParamOut": p - lr * g / (torch.sqrt(m_new) + eps), "MomentOut": m_new}


@register_op("decayed_adagrad", differentiable=False)
def decayed_adagrad(inputs, attrs, device):
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m = one(inputs, "Moment")
    lr = _lr(inputs, p)
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_new = decay * m + (1 - decay) * g * g
    return {"ParamOut": p - lr * g / (torch.sqrt(m_new) + eps), "MomentOut": m_new}


@register_op("adadelta", differentiable=False)
def adadelta(inputs, attrs, device):
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    avg_sq_grad = one(inputs, "AvgSquaredGrad")
    avg_sq_upd = one(inputs, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    asg_new = rho * avg_sq_grad + (1 - rho) * g * g
    update = -torch.sqrt((avg_sq_upd + eps) / (asg_new + eps)) * g
    asu_new = rho * avg_sq_upd + (1 - rho) * update * update
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg_new,
            "AvgSquaredUpdateOut": asu_new}


@register_op("rmsprop", differentiable=False)
def rmsprop(inputs, attrs, device):
    """ms = rho * ms + (1 - rho) * g^2; centered: mg = rho * mg + (1 -
    rho) * g and the denominator sqrt(ms - mg^2 + eps), else sqrt(ms +
    eps); mom = mu * mom + lr * g / denom; p -= mom."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    ms = one(inputs, "MeanSquare")
    mg = one(inputs, "MeanGrad")
    mom = one(inputs, "Moment")
    lr = _lr(inputs, p)
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mu = attrs.get("momentum", 0.0)
    ms_new = rho * ms + (1 - rho) * g * g
    if attrs.get("centered", False):
        mg_new = rho * mg + (1 - rho) * g
        denom = torch.sqrt(ms_new - mg_new * mg_new + eps)
    else:
        mg_new = mg
        denom = torch.sqrt(ms_new + eps)
    mom_new = mu * mom + lr * g / denom
    return {"ParamOut": p - mom_new, "MeanSquareOut": ms_new, "MeanGradOut": mg_new,
            "MomentOut": mom_new}


@register_op("ftrl", differentiable=False)
def ftrl(inputs, attrs, device):
    """Follow-the-regularized-leader (operators/optimizers/ftrl_op.h):
    with lr_power -0.5 a zero accumulator's power is 0, not nan.  Where the
    squared accumulator is 0 while the linear one is not (a gradient too
    small for its square to be a float: 1e-23 in fp32), the reference's
    x / y is an infinity that turns every later step to nan; here such an
    element takes the closed form's value for no gradient seen, 0."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    sq = one(inputs, "SquaredAccumulator")
    lin = one(inputs, "LinearAccumulator")
    lr = _lr(inputs, p)
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    sigma = (new_sq ** -power - sq ** -power) / lr
    new_lin = lin + g - sigma * p
    x = l1 * torch.sign(new_lin) - new_lin
    y = new_sq ** -power / lr + 2 * l2
    p_new = torch.where((torch.abs(new_lin) > l1) & (y > 0), x / y, torch.zeros_like(p))
    return {"ParamOut": p_new, "SquaredAccumOut": new_sq, "LinearAccumOut": new_lin}


@register_op("lamb", differentiable=False)
def lamb(inputs, attrs, device):
    """Adam's moments with bias correction, r = m_hat / (sqrt(v_hat) +
    eps) + wd * p, and a trust ratio |p| / |r| over the whole parameter
    (1 where a norm is 0): p -= lr * ratio * r (You et al. 2019)."""
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    m, v = one(inputs, "Moment1"), one(inputs, "Moment2")
    b1p = one(inputs, "Beta1Pow").reshape(())
    b2p = one(inputs, "Beta2Pow").reshape(())
    lr = _lr(inputs, p)
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-6)
    wd = attrs.get("weight_decay", 0.01)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    m_hat = m_new / (1 - b1p)
    v_hat = v_new / (1 - b2p)
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * p
    p_norm = torch.sqrt(torch.sum(p * p))
    r_norm = torch.sqrt(torch.sum(r * r))
    ratio = torch.where(p_norm > 0, torch.where(r_norm > 0, p_norm / r_norm, 1.0), 1.0)
    return {
        "ParamOut": p - lr * ratio * r,
        "Moment1Out": m_new,
        "Moment2Out": v_new,
        "Beta1PowOut": b1p * b1,
        "Beta2PowOut": b2p * b2,
    }


@register_op("average_accumulates", differentiable=False)
def average_accumulates(inputs, attrs, device):
    """Windowed parameter-average accumulators (used by ModelAverage).
    Per step:

      sum_1 += param; num_accumulates += 1; num_updates += 1
      every max_num_accumulates steps: sum_2 += sum_1; sum_1 = 0
      when num_accumulates >= min_average_window and
           num_accumulates >= min(max_average_window,
                                  num_updates * average_window_rate):
        sum_3 = sum_1 + sum_2; sum_1 = sum_2 = 0
        old_num_accumulates = num_accumulates; num_accumulates = 0

    The counters are int64 (the JAX package's are int32: it runs with
    x64 off)."""
    p = one(inputs, "Param")
    s1, s2, s3 = one(inputs, "Sum1"), one(inputs, "Sum2"), one(inputs, "Sum3")
    num_acc = one(inputs, "NumAccumulates").reshape(())
    old_num = one(inputs, "OldNumAccumulates").reshape(())
    num_upd = one(inputs, "NumUpdates").reshape(())
    rate = attrs.get("average_window", 0.15)
    max_acc = int(attrs.get("max_num_accumulates", 16384))
    min_win = int(attrs.get("min_average_window", 10000))
    max_win = int(attrs.get("max_average_window", 10000))

    s1 = s1 + p.to(s1.dtype)
    num_acc = num_acc + 1
    num_upd = num_upd + 1

    spill = torch.remainder(num_upd, max_acc) == 0
    s2 = torch.where(spill, s2 + s1, s2)
    s1 = torch.where(spill, torch.zeros_like(s1), s1)

    window = torch.clamp(num_upd.to(torch.float32) * rate, max=float(max_win))
    restart = (num_acc >= min_win) & (num_acc.to(torch.float32) >= window)
    s3 = torch.where(restart, s1 + s2, s3)
    s1 = torch.where(restart, torch.zeros_like(s1), s1)
    s2 = torch.where(restart, torch.zeros_like(s2), s2)
    old_num = torch.where(restart, num_acc, old_num)
    num_acc = torch.where(restart, torch.zeros_like(num_acc), num_acc)

    return {
        "Sum1Out": s1, "Sum2Out": s2, "Sum3Out": s3,
        "NumAccumulatesOut": num_acc.reshape((1,)),
        "OldNumAccumulatesOut": old_num.reshape((1,)),
        "NumUpdatesOut": num_upd.reshape((1,)),
    }


@register_op("dgc_momentum", differentiable=False)
def dgc_momentum(inputs, attrs, device):
    """Deep Gradient Compression momentum update (reference:
    operators/dgc_op.cc:23, optimizer.py:787 DGCMomentumOptimizer).

    Local momentum correction (u = mu * u + g), gradient accumulation
    (v += u), top-k on |v| with k = max(1, round(n * (1 - sparsity)))
    from the final sparsity, the accumulators cleared where selected;
    the parameter steps with the selected values.  Before
    ``rampup_begin_step`` it is dense momentum with u as the velocity and
    v left alone.  The sparse allreduce across devices
    (``use_collective``) comes with ROADMAP A10 part 4."""
    if attrs.get("use_collective", False):
        raise NotImplementedError(
            "dgc_momentum with use_collective allreduces the sparse gradient across "
            "devices; it comes with ROADMAP A10 part 4, not ported to paddle_tpu_torch yet")
    p, g = one(inputs, "Param"), one(inputs, "Grad")
    u, v = one(inputs, "U"), one(inputs, "V")
    step = one(inputs, "CurrentStep").reshape(())
    lr = _lr(inputs, p)
    mu = attrs.get("mu", 0.9)
    sparsity = float(attrs.get("sparsity", 0.999))
    rampup = float(attrs.get("rampup_begin_step", 0.0))

    u_new = mu * u + g
    v_new = v + u_new
    flat_v = v_new.reshape(-1)
    n = flat_v.shape[0]
    k = max(1, int(round(n * (1.0 - sparsity))))
    _, idx = torch.topk(torch.abs(flat_v), k)
    sparse_grad = torch.zeros_like(flat_v).scatter(0, idx, flat_v[idx]).reshape(v_new.shape)
    mask = torch.zeros(n, dtype=torch.bool, device=flat_v.device).scatter(0, idx, True)
    mask = mask.reshape(v_new.shape)

    dense = step < rampup
    update = torch.where(dense, u_new, sparse_grad)
    u_out = torch.where(dense, u_new, torch.where(mask, 0.0, u_new))
    v_out = torch.where(dense, v, torch.where(mask, 0.0, v_new))
    return {"ParamOut": p - lr * update, "UOut": u_out, "VOut": v_out}
