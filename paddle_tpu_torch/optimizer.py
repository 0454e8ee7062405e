"""Optimizers: append the update ops to the program.

Port of the JAX package's ``optimizer.py`` (reference:
python/paddle/fluid/optimizer.py:50 Optimizer, SGD:609, Momentum:679,
LarsMomentum:1046, Adagrad:1146, Adam:1249, Adamax:1430,
DecayedAdagrad:1584, Adadelta:1676, RMSProp:1774, Ftrl:1947, Lamb:2091,
DGCMomentum:787, ModelAverage:2245, ExponentialMovingAverage:2435,
PipelineOptimizer:2665): ``Optimizer`` with the global learning-rate var
and the accumulators (persistable vars initialised in the startup
program), and each optimizer's update op (``ops/optimizer_ops.py``), desc
for desc the JAX package's.  The update ops run in the same block as
forward and backward, and the executor writes what they update back to
the scope.

``ModelAverage.apply`` and ``ExponentialMovingAverage.apply`` swap the
averaged weights into the scope on the host and keep *copies* of the
trained ones for ``restore``.  The JAX package keeps references, which
JAX's immutable arrays make snapshots; here a captured step that runs
under ``apply`` copies the averages into the graph's buffer, which is
the tensor a reference would hold (``executor.py`` ``_replay``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.backward import append_backward
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.scope import global_scope

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum", "MomentumOptimizer",
           "LarsMomentum", "LarsMomentumOptimizer", "Adagrad", "AdagradOptimizer",
           "DecayedAdagrad", "DecayedAdagradOptimizer", "Adam", "AdamOptimizer", "Adamax",
           "AdamaxOptimizer", "Adadelta", "AdadeltaOptimizer", "RMSProp", "RMSPropOptimizer",
           "Ftrl", "FtrlOptimizer", "Lamb", "LambOptimizer", "DGCMomentumOptimizer",
           "ModelAverage", "ExponentialMovingAverage", "PipelineOptimizer"]


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

    def accumulator_map(self) -> Dict[str, tuple]:
        """``{accumulator var name: (param name, accumulator kind)}`` for
        every optimizer-state var this optimizer created (populated by
        ``minimize``): the name↔param surface the sharded-training rules
        read (``sharding.train.train_rules``), as the JAX package's."""
        out: Dict[str, tuple] = {}
        for kind, per_param in self._accumulators.items():
            for pname, var in per_param.items():
                out[var.name] = (pname, kind)
        return out

    # ------------------------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, params_grads):
        pass

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
        self._finish_update(block, params_grads)
        block.program.version += 1
        return ops

    def apply_optimize(self, loss, startup_program, params_grads):
        return self.apply_gradients(params_grads)

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
    _op = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kwargs):
        # lazy_mode (update only the rows a sparse gradient touches) is
        # accepted and ignored, as in the JAX package: gradients are dense
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
            type=self._op,
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




class LarsMomentumOptimizer(MomentumOptimizer):
    def __init__(self, learning_rate, momentum, lars_coeff=0.001, lars_weight_decay=0.0005,
                 **kwargs):
        super().__init__(learning_rate, momentum, **kwargs)
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay, "op_role": "optimize"},
        )


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._init_acc)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon, "op_role": "optimize"},
        )


class DecayedAdagradOptimizer(AdagradOptimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, epsilon=epsilon, **kwargs)
        self._decay = decay

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._create_param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon, "decay": self._decay, "op_role": "optimize"},
        )


class LambOptimizer(AdamOptimizer):
    """Adam's accumulators and a ``lamb`` op with the trust ratio (You et
    al. 2019); under ``contrib.mixed_precision.decorate`` the op sees the
    fp32 master weights and gradients."""

    _op = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kwargs)
        self._weight_decay = lamb_weight_decay

    def _append_optimize_op(self, block, param_and_grad):
        op = super()._append_optimize_op(block, param_and_grad)
        op.attrs["weight_decay"] = self._weight_decay
        return op


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment": [self._get_accumulator("moment", p)],
                "InfNorm": [self._get_accumulator("inf_norm", p)],
                "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                "LearningRate": [self._create_param_lr(p)],
            },
            outputs={
                "ParamOut": [p],
                "MomentOut": [self._get_accumulator("moment", p)],
                "InfNormOut": [self._get_accumulator("inf_norm", p)],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon,
                   "op_role": "optimize"},
        )

    def _finish_update(self, block, params_grads):
        # beta1 pow update (reference: optimizer.py Adamax._finish_update)
        for p, _ in params_grads:
            b1p = self._get_accumulator("beta1_pow_acc", p)
            block.append_op(
                type="scale",
                inputs={"X": [b1p]},
                outputs={"Out": [b1p]},
                attrs={"scale": self._beta1, "op_role": "optimize"},
            )


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("__avg_squared_grad", p)
            self._add_accumulator("__avg_squared_update", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        asg = self._get_accumulator("__avg_squared_grad", p)
        asu = self._get_accumulator("__avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg], "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho, "op_role": "optimize"},
        )


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0, centered=False,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._rho, self._epsilon, self._momentum, self._centered = rho, epsilon, momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("momentum", p)
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [p],
                "Grad": [g],
                "Moment": [self._get_accumulator("momentum", p)],
                "MeanSquare": [self._get_accumulator("mean_square", p)],
                "MeanGrad": [self._get_accumulator("mean_grad", p)],
                "LearningRate": [self._create_param_lr(p)],
            },
            outputs={
                "ParamOut": [p],
                "MomentOut": [self._get_accumulator("momentum", p)],
                "MeanSquareOut": [self._get_accumulator("mean_square", p)],
                "MeanGradOut": [self._get_accumulator("mean_grad", p)],
            },
            attrs={"decay": self._rho, "epsilon": self._epsilon, "momentum": self._momentum,
                   "centered": self._centered, "op_role": "optimize"},
        )


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [p],
                "Grad": [g],
                "SquaredAccumulator": [self._get_accumulator("squared", p)],
                "LinearAccumulator": [self._get_accumulator("linear", p)],
                "LearningRate": [self._create_param_lr(p)],
            },
            outputs={
                "ParamOut": [p],
                "SquaredAccumOut": [self._get_accumulator("squared", p)],
                "LinearAccumOut": [self._get_accumulator("linear", p)],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power,
                   "op_role": "optimize"},
        )


class DGCMomentumOptimizer(MomentumOptimizer):
    """Deep Gradient Compression (reference: optimizer.py:787,
    operators/dgc_op.cc): one ``dgc_momentum`` op per parameter and a
    step counter.  ``sparsity`` takes the FINAL value of the reference's
    schedule, as the JAX package does (a static k)."""

    def __init__(self, learning_rate, momentum, rampup_begin_step=0, rampup_step=1,
                 sparsity=None, **kwargs):
        super().__init__(learning_rate, momentum, **kwargs)
        self._rampup_begin_step = float(rampup_begin_step)
        self._sparsity = float((sparsity or [0.999])[-1])
        if rampup_step != 1 or (sparsity is not None and len(sparsity) > 1):
            import warnings

            warnings.warn(
                "DGCMomentumOptimizer uses the FINAL sparsity (%.4f) from "
                "step rampup_begin_step on: the reference's gradual "
                "rampup_step schedule is not applied" % self._sparsity,
                stacklevel=2,
            )
        self._dgc_step_var = None

    def _create_accumulators(self, block, parameters):
        helper = LayerHelper("dgc_momentum")
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
        if self._dgc_step_var is None:
            self._dgc_step_var = block.create_var(
                name=unique_name.generate("@DGC_STEP@"),
                shape=[1], dtype="float32", persistable=True, stop_gradient=True,
            )
            helper.set_variable_initializer(self._dgc_step_var, initializer.Constant(0.0))

    def _append_optimize_op(self, block, param_and_grad):
        p, g = param_and_grad
        return block.append_op(
            type="dgc_momentum",
            inputs={
                "Param": [p], "Grad": [g],
                "U": [self._get_accumulator("dgc_u", p)],
                "V": [self._get_accumulator("dgc_v", p)],
                "CurrentStep": [self._dgc_step_var],
                "LearningRate": [self._create_param_lr(p)],
            },
            outputs={
                "ParamOut": [p],
                "UOut": [self._get_accumulator("dgc_u", p)],
                "VOut": [self._get_accumulator("dgc_v", p)],
            },
            attrs={"mu": self._momentum, "sparsity": self._sparsity,
                   "rampup_begin_step": self._rampup_begin_step, "op_role": "optimize"},
        )

    def _finish_update(self, block, params_grads):
        block.append_op(
            type="scale",
            inputs={"X": [self._dgc_step_var]},
            outputs={"Out": [self._dgc_step_var]},
            attrs={"scale": 1.0, "bias": 1.0, "op_role": "optimize"},
        )


class _WeightSwap:
    """``apply``/``restore`` of ModelAverage and ExponentialMovingAverage:
    put averaged weights into the current global scope and keep a copy of
    each trained weight for ``restore``."""

    _params: list
    _backup: Optional[dict] = None

    def _averaged(self, scope) -> Dict[str, object]:
        raise NotImplementedError

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        scope = global_scope()
        averaged = self._averaged(scope)
        self._backup = {}
        for p in self._params:
            cur = scope.get(p.name)
            self._backup[p.name] = cur.clone()
            scope.set(p.name, averaged[p.name].to(cur.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor=None):
        if self._backup:
            scope = global_scope()
            for name, val in self._backup.items():
                scope.set(name, val)
            self._backup = None


class ModelAverage(_WeightSwap):
    """Sliding-window parameter average for evaluation (reference:
    optimizer.py:2245 + operators/average_accumulates_op.cc).

    Construction appends one ``average_accumulates`` op per parameter;
    ``apply`` swaps (sum_1 + sum_2 + sum_3) / (num_accumulates +
    old_num_accumulates) into the scope."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        self.average_window_rate = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        block = framework.default_main_program().global_block()
        helper = LayerHelper("model_average")
        self._params = [p for p in block.all_parameters() if getattr(p, "trainable", True)]
        self._accs = {}

        def _state(name, shape, dtype="float32"):
            v = block.create_var(
                name=unique_name.generate(name), shape=shape, dtype=dtype,
                persistable=True, stop_gradient=True,
            )
            helper.set_variable_initializer(v, initializer.Constant(0.0))
            return v

        for p in self._params:
            s1 = _state(p.name + "@MA_SUM1@", p.shape)
            s2 = _state(p.name + "@MA_SUM2@", p.shape)
            s3 = _state(p.name + "@MA_SUM3@", p.shape)
            na = _state(p.name + "@MA_NACC@", [1], "int64")
            no = _state(p.name + "@MA_OLDN@", [1], "int64")
            nu = _state(p.name + "@MA_NUPD@", [1], "int64")
            block.append_op(
                type="average_accumulates",
                inputs={"Param": [p.name], "Sum1": [s1.name], "Sum2": [s2.name],
                        "Sum3": [s3.name], "NumAccumulates": [na.name],
                        "OldNumAccumulates": [no.name], "NumUpdates": [nu.name]},
                outputs={"Sum1Out": [s1.name], "Sum2Out": [s2.name],
                         "Sum3Out": [s3.name], "NumAccumulatesOut": [na.name],
                         "OldNumAccumulatesOut": [no.name], "NumUpdatesOut": [nu.name]},
                attrs={"average_window": self.average_window_rate,
                       "min_average_window": self.min_average_window,
                       "max_average_window": self.max_average_window,
                       "op_role": "optimize"},
            )
            self._accs[p.name] = (s1, s2, s3, na, no)
        block.program.version += 1

    def _averaged(self, scope):
        out = {}
        for p in self._params:
            s1, s2, s3, na, no = self._accs[p.name]
            total = max(int(scope.get(na.name).reshape(())) + int(scope.get(no.name).reshape(())),
                        1)
            out[p.name] = (scope.get(s1.name) + scope.get(s2.name) + scope.get(s3.name)) / total
        return out


class ExponentialMovingAverage(_WeightSwap):
    """EMA of parameters (reference: optimizer.py:2435).

    ``update()`` appends the in-graph decay ops plus a step counter and a
    decay-power accumulator; ``apply()`` installs the *bias-corrected*
    EMA, ema / (1 - prod(decay_t)), as the reference's apply-time
    correction does.  ``thres_steps`` schedules the decay as
    min(decay, (1 + step) / (10 + step))."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._ema = {}
        self._params = []
        self._step_var = None
        self._dpow_var = None

    def update(self):
        """Append ema = decay_t * ema + (1 - decay_t) * param for every
        trainable param in the default main program (call after
        minimize)."""
        block = framework.default_main_program().global_block()
        helper = LayerHelper("ema")
        self._params = [p for p in block.all_parameters() if getattr(p, "trainable", True)]

        def _state(name, init):
            v = block.create_var(
                name=unique_name.generate(name), shape=[1], dtype="float32",
                persistable=True, stop_gradient=True,
            )
            helper.set_variable_initializer(v, initializer.Constant(init))
            return v

        def _tmp(name, shape=(1,), dtype="float32"):
            return block.create_var(name=unique_name.generate(name), shape=list(shape),
                                    dtype=dtype)

        def _op(type, ins, outs, **attrs):
            attrs.setdefault("op_role", "optimize")
            block.append_op(type=type, inputs=ins, outputs=outs, attrs=attrs)

        if self._step_var is None:
            self._step_var = _state("@EMA_STEP@", 0.0)
            self._dpow_var = _state("@EMA_DPOW@", 1.0)
            _op("scale", {"X": [self._step_var.name]}, {"Out": [self._step_var.name]},
                scale=1.0, bias=1.0)
            # decay_t: scheduled min(decay, (1+t)/(10+t)) or constant;
            # thres_steps may be the user's global-step Variable
            decay_t = _tmp("@EMA_DECAY@")
            if self._thres_steps is not None:
                if isinstance(self._thres_steps, framework.Variable):
                    step_src = _tmp("@EMA_TSRC@")
                    _op("cast", {"X": [self._thres_steps.name]}, {"Out": [step_src.name]},
                        in_dtype=self._thres_steps.dtype, out_dtype="float32")
                    step_name = step_src.name
                else:
                    step_name = self._step_var.name
                num = _tmp("@EMA_NUM@")
                den = _tmp("@EMA_DEN@")
                cst = _tmp("@EMA_CST@")
                _op("scale", {"X": [step_name]}, {"Out": [num.name]}, scale=1.0, bias=1.0)
                _op("scale", {"X": [step_name]}, {"Out": [den.name]}, scale=1.0, bias=10.0)
                _op("elementwise_div", {"X": [num.name], "Y": [den.name]}, {"Out": [cst.name]})
                sched = _tmp("@EMA_SCHED@")
                _op("scale", {"X": [self._step_var.name]}, {"Out": [sched.name]},
                    scale=0.0, bias=self._decay)
                _op("elementwise_min", {"X": [cst.name], "Y": [sched.name]},
                    {"Out": [decay_t.name]})
            else:
                _op("scale", {"X": [self._step_var.name]}, {"Out": [decay_t.name]},
                    scale=0.0, bias=self._decay)
            _op("elementwise_mul", {"X": [self._dpow_var.name], "Y": [decay_t.name]},
                {"Out": [self._dpow_var.name]})
            self._decay_var = decay_t

        one_minus = _tmp("@EMA_1MD@")
        _op("scale", {"X": [self._decay_var.name]}, {"Out": [one_minus.name]},
            scale=-1.0, bias=1.0)
        for p in self._params:
            if p.name in self._ema:
                continue
            e = block.create_var(
                name=unique_name.generate(p.name + "@EMA@"),
                shape=p.shape, dtype=p.dtype, persistable=True, stop_gradient=True,
            )
            helper.set_variable_initializer(e, initializer.Constant(0.0))
            scaled_e = _tmp(p.name + "@EMA_T@", p.shape, p.dtype)
            scaled_p = _tmp(p.name + "@EMA_P@", p.shape, p.dtype)
            _op("elementwise_mul", {"X": [e.name], "Y": [self._decay_var.name]},
                {"Out": [scaled_e.name]})
            _op("elementwise_mul", {"X": [p.name], "Y": [one_minus.name]},
                {"Out": [scaled_p.name]})
            _op("elementwise_add", {"X": [scaled_e.name], "Y": [scaled_p.name]},
                {"Out": [e.name]})
            self._ema[p.name] = e
        block.program.version += 1

    def _averaged(self, scope):
        dpow = (float(scope.get(self._dpow_var.name).reshape(()))
                if self._dpow_var is not None else 0.0)
        corr = max(1.0 - dpow, 1e-12)
        return {p.name: scope.get(self._ema[p.name].name) / corr for p in self._params}


class PipelineOptimizer:
    """Pipeline-parallel optimizer (reference: optimizer.py:2665).

    Without a ``cut_list`` it is the wrapped optimizer plus a recorded
    microbatch plan (``program._pipeline_config``), as in the JAX
    package.  A ``cut_list`` cuts the program into stages across
    devices, which comes with ROADMAP A10 part 3 (the pipelined programs)."""

    def __init__(self, optimizer, cut_list=None, place_list=None, concurrency_list=None,
                 queue_size=30, sync_steps=1, start_cpu_core_id=0, num_microbatches=None):
        if cut_list:
            raise NotImplementedError(
                "PipelineOptimizer with a cut_list runs its stages across devices; the "
                "pipelined programs (ROADMAP A10 part 3) are not ported to paddle_tpu_torch yet")
        self._optimizer = optimizer
        self._num_microbatches = num_microbatches or 1

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        ops, pgs = self._optimizer.minimize(loss, startup_program, parameter_list, no_grad_set)
        loss.block.program._pipeline_config = {
            "num_microbatches": self._num_microbatches,
            "cut_vars": [],
        }
        return ops, pgs


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
