"""Optimizers: append the update ops to the program.

Port of the JAX package's ``optimizer.py`` (reference:
python/paddle/fluid/optimizer.py:50 Optimizer, SGD:609, Momentum:679,
Adam:1249): ``Optimizer`` with the global learning-rate var and the
accumulators (persistable vars initialised in the startup program),
``SGDOptimizer``, ``MomentumOptimizer`` and ``AdamOptimizer``. The
update ops (``ops/optimizer_ops.py``) run in the same block as forward
and backward, and the executor writes what they update back to the
scope. The other optimizers come with later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Optional

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer", "Adam",
           "AdamOptimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None

    # ------------------------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if self._lr_var is not None:
            return
        from paddle_tpu_torch.layers import tensor as ltensor

        self._lr_var = ltensor.create_global_var(
            shape=[1],
            value=float(self._learning_rate),
            dtype="float32",
            persistable=True,
            name=unique_name.generate("learning_rate"),
        )

    def _create_param_lr(self, param):
        """Per-param LR multiplier (ParamAttr.learning_rate)."""
        mult = param.optimize_attr.get("learning_rate", 1.0) if param.optimize_attr else 1.0
        if mult == 1.0:
            return self._lr_var
        from paddle_tpu_torch.layers import tensor as ltensor

        return ltensor.scale(self._lr_var, scale=float(mult))

    # ------------------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None, dtype=None):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(self.__class__.__name__.lower())
        shape = shape if shape is not None else list(param.shape)
        var_name = unique_name.generate("%s_%s" % (param.name, name))
        block = framework.default_main_program().global_block()
        var = block.create_var(
            name=var_name,
            shape=shape,
            dtype=dtype or param.dtype,
            persistable=True,
            stop_gradient=True,
        )
        helper.set_variable_initializer(var, initializer.Constant(fill_value))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # ------------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        from paddle_tpu_torch import clip as clip_mod
        from paddle_tpu_torch import regularizer as reg_mod

        block = framework.default_main_program().global_block()
        self._create_global_learning_rate()
        params_grads = clip_mod.append_gradient_clip_ops(params_grads)
        params_grads = reg_mod.append_regularization_ops(params_grads, self.regularization)
        self._create_accumulators(block, [p for p, _ in params_grads])
        ops = []
        for pg in params_grads:
            if pg[1] is None:
                continue
            ops.append(self._append_optimize_op(block, pg))
        block.program.version += 1
        return ops

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        optimize_ops = self.apply_gradients(params_grads)
        return optimize_ops, params_grads


# ---------------------------------------------------------------------------
class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p]},
            attrs={"op_role": "optimize"},
        )


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov,
                   "op_role": "optimize"},
        )


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="adam",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment1": [m1],
                "Moment2": [m2],
                "Beta1Pow": [b1p],
                "Beta2Pow": [b2p],
                "LearningRate": [self._create_param_lr(p)],
            },
            outputs={
                "ParamOut": [p],
                "Moment1Out": [m1],
                "Moment2Out": [m2],
                "Beta1PowOut": [b1p],
                "Beta2PowOut": [b2p],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
                "op_role": "optimize",
            },
        )


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
