"""In-graph LR schedules (reference: python/paddle/fluid/layers/
learning_rate_scheduler.py — noam/exponential/natural_exp/inverse_time/
polynomial/piecewise/cosine decay + linear warmup).

A copy of the JAX package's module with its imports pointed at this
package.  Each schedule creates a persistable global step counter that
a ``scale`` op of the step increments in place, and computes the LR
from it inside the step, with no host round trip.  On a card the
counter is captured graph state, like batch_norm's running statistics:
the graph reads and writes the scope's own tensor at each replay.
"""
from __future__ import annotations

import math

from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = [
    "noam_decay",
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "cosine_decay",
    "linear_lr_warmup",
]


def _decay_step_counter(begin=0):
    from paddle_tpu_torch import initializer
    from paddle_tpu_torch.layers import tensor as ltensor

    helper = LayerHelper("global_step_counter")
    counter = framework.default_main_program().global_block().create_var(
        name=unique_name.generate("@LR_DECAY_COUNTER@"),
        shape=[1],
        dtype="float32",
        persistable=True,
        stop_gradient=True,
    )
    helper.set_variable_initializer(counter, initializer.Constant(float(begin - 1)))
    helper.append_op(
        type="scale",
        inputs={"X": [counter]},
        outputs={"Out": [counter]},
        attrs={"scale": 1.0, "bias": 1.0},
    )
    return counter


def noam_decay(d_model, warmup_steps):
    from paddle_tpu_torch.layers import ops as lops
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter(1)
    a = lops.rsqrt(step)
    b = lt.scale(step, scale=float(warmup_steps) ** -1.5)
    lr = lt.elementwise_min(a, b)
    return lt.scale(lr, scale=float(d_model) ** -0.5)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch.layers import ops as lops
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    div = lt.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = lops.floor(div)
    factor = lt.elementwise_pow(
        lt.fill_constant([1], "float32", decay_rate), div
    )
    return lt.scale(factor, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch.layers import ops as lops
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    div = lt.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = lops.floor(div)
    return lt.scale(lops.exp(lt.scale(div, scale=-decay_rate)), scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    from paddle_tpu_torch.layers import ops as lops
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    div = lt.scale(step, scale=1.0 / float(decay_steps))
    if staircase:
        div = lops.floor(div)
    denom = lt.scale(div, scale=float(decay_rate), bias=1.0)
    return lt.elementwise_div(lt.fill_constant([1], "float32", float(learning_rate)), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False):
    from paddle_tpu_torch.layers import ops as lops
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    capped = lt.elementwise_min(step, lt.fill_constant([1], "float32", float(decay_steps)))
    frac = lt.scale(capped, scale=1.0 / float(decay_steps))
    one_minus = lt.scale(frac, scale=-1.0, bias=1.0)
    poly = lt.elementwise_pow(one_minus, lt.fill_constant([1], "float32", float(power)))
    return lt.scale(poly, scale=float(learning_rate) - float(end_learning_rate), bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    lr = lt.fill_constant([1], "float32", float(values[-1]))
    # build nested where: smallest boundary first
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = lt.less_than(step, lt.fill_constant([1], "float32", float(b)))
        lr = lt.where(cond, lt.fill_constant([1], "float32", float(v)), lr)
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    from paddle_tpu_torch.layers import ops as lops
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    epoch = lops.floor(lt.scale(step, scale=1.0 / float(step_each_epoch)))
    cosv = lops.cos(lt.scale(epoch, scale=math.pi / float(epochs)))
    return lt.scale(lt.scale(cosv, scale=0.5, bias=0.5), scale=float(learning_rate))


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    from paddle_tpu_torch.layers import tensor as lt

    step = _decay_step_counter()
    if isinstance(learning_rate, (int, float)):
        learning_rate = lt.fill_constant([1], "float32", float(learning_rate))
    frac = lt.scale(step, scale=1.0 / float(warmup_steps))
    warm = lt.scale(frac, scale=float(end_lr) - float(start_lr), bias=float(start_lr))
    cond = lt.less_than(step, lt.fill_constant([1], "float32", float(warmup_steps)))
    return lt.where(cond, warm, learning_rate)
