"""Gradient clipping (reference: python/paddle/fluid/clip.py).

Port of the JAX package's ``clip.py``.  ``Optimizer.apply_gradients``
calls ``append_gradient_clip_ops``; with no clip set (globally by
``set_gradient_clip`` or on a parameter) it hands the grads through
unchanged.  The clip ops themselves (``clip``, ``clip_by_norm``, the
global-norm reduction) come with a later slice of the port, so asking
for a clip raises at build time.
"""
from __future__ import annotations

from typing import List, Tuple

from paddle_tpu_torch import framework

__all__ = [
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
]

_global_clip = None


class BaseGradientClipAttr:
    pass


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name


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
    for p, g in params_grads:
        c = getattr(p, "gradient_clip_attr", None) or _global_clip
        if g is not None and c is not None:
            raise NotImplementedError(
                "%s on %r needs the clip ops, not ported yet" % (type(c).__name__, p.name))
    return list(params_grads)
