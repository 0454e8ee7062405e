"""Weight-decay regularizers appended as grad ops
(reference: python/paddle/fluid/regularizer.py).

A copy of the JAX package's ``regularizer.py`` with its imports pointed
at this package: L2 decay appends ``scale``, L1 decay ``sign`` and
``scale``, and each adds the decay to the gradient with ``sum``."""
from __future__ import annotations

from paddle_tpu_torch import framework

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=grad.name + "@L2DECAY", shape=param.shape, dtype=param.dtype, stop_gradient=True
        )
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._coeff, "op_role": "backward"},
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=grad.name + "@L1SIGN", shape=param.shape, dtype=param.dtype, stop_gradient=True
        )
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]}, attrs={"op_role": "backward"})
        decay = block.create_var(
            name=grad.name + "@L1DECAY", shape=param.shape, dtype=param.dtype, stop_gradient=True
        )
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={"scale": self._coeff, "op_role": "backward"},
        )
        return decay


def append_regularization_ops(params_grads, regularization=None):
    """reference: regularizer.py append_regularization_ops — grad += decay."""
    out = []
    for param, grad in params_grads:
        if grad is None:
            out.append((param, grad))
            continue
        reg = param.regularizer if getattr(param, "regularizer", None) is not None else regularization
        if reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        decay = reg(param, grad, block)
        new_grad = block.create_var(
            name=grad.name + "@REGULARIZED", shape=param.shape, dtype=param.dtype, stop_gradient=True
        )
        block.append_op(
            type="sum",
            inputs={"X": [grad, decay]},
            outputs={"Out": [new_grad]},
            attrs={"op_role": "backward"},
        )
        out.append((param, new_grad))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
