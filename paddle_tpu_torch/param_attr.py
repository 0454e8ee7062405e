"""ParamAttr (reference: python/paddle/fluid/param_attr.py)."""
from __future__ import annotations

from paddle_tpu_torch import initializer as init

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        gradient_clip=None,
        do_model_average=False,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, init.Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        raise TypeError("cannot convert %r to ParamAttr" % (arg,))

    def _to_kwargs(self):
        return {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }


class WeightNormParamAttr(ParamAttr):
    """A ParamAttr that also names the weight-norm ``dim`` (the JAX
    package's ``param_attr.py``: the dim is kept, the parameter is
    made as any other)."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
