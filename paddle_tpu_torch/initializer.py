"""Parameter initializers — append init ops to the startup program.

Port of the JAX package's ``initializer.py`` (reference:
python/paddle/fluid/initializer.py): Constant, Uniform, Normal,
TruncatedNormal, Xavier, MSRA, NumpyArray and Bilinear.  RNG ops take
deterministic seeds from the program (framework.Program.next_seed), the
same seed sequence as the JAX package; the bits drawn from them differ
(torch.Generator vs jax.random).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np

__all__ = ["Bilinear", "BilinearInitializer", "init_on_cpu", "Constant", "Uniform", "Normal",
           "TruncatedNormal", "Xavier", "MSRA", "NumpyArrayInitializer", "force_init_on_cpu"]


def force_init_on_cpu():
    return False


@contextlib.contextmanager
def init_on_cpu():
    """reference: initializer.py init_on_cpu, a placement hint; a scope
    holds its tensors on one device here, so this is a no-op context."""
    yield


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


class TruncatedNormalInitializer(NormalInitializer):
    """A normal truncated at two standard deviations."""

    def __call__(self, var, block):
        seed = self.seed or block.program.next_seed()
        return block.append_op(
            type="truncated_gaussian_random",
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


class MSRAInitializer(Initializer):
    """He init (reference: initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        seed = self.seed or block.program.next_seed()
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            attrs = {"min": -limit, "max": limit}
            op = "uniform_random"
        else:
            std = math.sqrt(2.0 / fi)
            attrs = {"mean": 0.0, "std": std}
            op = "gaussian_random"
        attrs.update({"shape": list(var.shape), "dtype": var.dtype, "seed": seed})
        return block.append_op(type=op, outputs={"Out": [var.name]}, attrs=attrs)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(self.value.shape),
                "dtype": var.dtype,
                "values": self.value.flatten().tolist(),
            },
        )


class BilinearInitializer(Initializer):
    """reference: initializer.py BilinearInitializer: a conv_transpose
    filter [C_out, C_in, kh, kw] of bilinear upsampling kernels."""

    def __call__(self, var, block):
        shape = [int(s) for s in var.shape]
        if len(shape) != 4:
            raise ValueError("Bilinear initializer needs a 4-D filter")
        weight = np.zeros(shape, dtype="float32")
        kh, kw = shape[2], shape[3]
        f_h, f_w = np.ceil(kh / 2.0), np.ceil(kw / 2.0)
        c_h, c_w = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h), (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        yy, xx = np.meshgrid(np.arange(kh), np.arange(kw), indexing="ij")
        kern = (1 - np.abs(yy / f_h - c_h)) * (1 - np.abs(xx / f_w - c_w))
        weight[:, :] = kern
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={"shape": shape, "dtype": "float32", "values": weight.flatten().tolist()},
        )


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
