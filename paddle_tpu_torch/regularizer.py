"""Weight-decay regularizers (reference: python/paddle/fluid/regularizer.py).

Port of the JAX package's ``regularizer.py``.  ``Optimizer.apply_gradients``
calls ``append_regularization_ops``; with no regularizer on the optimizer
or a parameter it hands the grads through unchanged.  Decay itself
appends ``scale`` and ``sign`` ops, which come with a later slice of the
port, so asking for it raises at build time.
"""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff


class L2DecayRegularizer(WeightDecayRegularizer):
    pass


class L1DecayRegularizer(WeightDecayRegularizer):
    pass


def append_regularization_ops(params_grads, regularization=None):
    """reference: regularizer.py append_regularization_ops — grad += decay."""
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        if grad is not None and reg is not None:
            raise NotImplementedError(
                "%s on %r needs the scale/sign ops, not ported yet"
                % (type(reg).__name__, param.name))
    return list(params_grads)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
