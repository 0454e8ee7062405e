"""Gradient clipping (reference: python/paddle/fluid/clip.py —
GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
ErrorClipByValue, set_gradient_clip).

A copy of the JAX package's ``clip.py`` with its imports pointed at this
package, so both append the same ops: ``clip``, ``clip_by_norm``, and
for a global norm ``square``, ``reduce_sum``, ``sum``, ``sqrt``,
``fill_constant``, ``elementwise_max``, ``elementwise_div`` and one
``elementwise_mul`` a gradient.  ``Optimizer.apply_gradients`` calls
``append_gradient_clip_ops``; with no clip set it hands the grads
through unchanged."""
from __future__ import annotations

from typing import List, Optional, Tuple

from paddle_tpu_torch import framework

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "ErrorClipByValue",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]

_global_clip = None


class BaseGradientClipAttr:
    def _create_operators(self, param, grad):
        raise NotImplementedError

    def _process_context(self, context, param, grad):
        pass


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _create_operators(self, param, grad):
        from paddle_tpu_torch.layers import nn

        return param, nn.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        from paddle_tpu_torch.layers import nn

        return param, nn.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        ctx = context.setdefault(self.group_name, [])
        ctx.append((param, grad))

    @staticmethod
    def _apply_group(pairs, clip_norm):
        from paddle_tpu_torch.layers import ops as lops
        from paddle_tpu_torch.layers import tensor as ltensor

        sq_sums = []
        for _, g in pairs:
            sq = lops.square(g)
            sq_sums.append(ltensor.reduce_sum(sq))
        global_norm = lops.sqrt(ltensor.sums(sq_sums))
        clip_var = ltensor.fill_constant([1], "float32", clip_norm)
        scale = ltensor.elementwise_div(clip_var, ltensor.elementwise_max(global_norm, clip_var))
        out = []
        for p, g in pairs:
            out.append((p, ltensor.elementwise_mul(g, scale)))
        return out


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_clip
    _global_clip = clip
    if param_list:
        for p in param_list:
            if isinstance(p, str):
                p = framework.default_main_program().global_block().var(p)
            p.gradient_clip_attr = clip


def append_gradient_clip_ops(params_grads) -> List[Tuple]:
    """reference: clip.py append_gradient_clip_ops."""
    clips = {}
    has_clip = False
    for p, g in params_grads:
        c = getattr(p, "gradient_clip_attr", None) or _global_clip
        if c is not None:
            has_clip = True
        clips[p.name] = c
    if not has_clip:
        return params_grads

    # global-norm groups first
    context = {}
    simple = []
    for p, g in params_grads:
        c = clips[p.name]
        if isinstance(c, GradientClipByGlobalNorm) and g is not None:
            c._process_context(context, p, g)
        else:
            simple.append((p, g, c))
    out = []
    for group_name, pairs in context.items():
        clip_norm = None
        for p, _ in pairs:
            c = clips[p.name]
            clip_norm = c.clip_norm
        out.extend(GradientClipByGlobalNorm._apply_group(pairs, clip_norm))
    for p, g, c in simple:
        if g is None or c is None:
            out.append((p, g))
        else:
            out.append(c._create_operators(p, g))
    return out
