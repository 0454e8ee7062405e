"""Parameter initializers — append init ops to the startup program.

Port of the JAX package's ``initializer.py`` (reference:
python/paddle/fluid/initializer.py), the initializers the BERT,
LeNet and ResNet slices use.  RNG ops take deterministic seeds from the
program (framework.Program.next_seed), the same seed sequence as the
JAX package; the bits drawn from them differ (torch.Generator vs
jax.random).
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier"]


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        seed = self.seed or block.program.next_seed()
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self.low,
                "max": self.high,
                "seed": seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        seed = self.seed or block.program.next_seed()
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self.loc,
                "std": self.scale,
                "seed": seed,
            },
        )


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    # conv filter OIHW
    rf = int(np.prod(shape[2:]))
    return shape[1] * rf, shape[0] * rf


class XavierInitializer(Initializer):
    """Glorot (reference: initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        seed = self.seed or block.program.next_seed()
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            attrs = {"min": -limit, "max": limit}
            op = "uniform_random"
        else:
            std = math.sqrt(2.0 / (fi + fo))
            attrs = {"mean": 0.0, "std": std}
            op = "gaussian_random"
        attrs.update({"shape": list(var.shape), "dtype": var.dtype, "seed": seed})
        return block.append_op(type=op, outputs={"Out": [var.name]}, attrs=attrs)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
