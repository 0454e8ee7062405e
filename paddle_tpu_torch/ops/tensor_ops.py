"""Tensor creation / manipulation ops (the slice's subset of
the JAX package's ``ops/tensor_ops.py``).

Reference kernels: operators/fill_constant_op.cc, uniform_random_op.cc,
gaussian_random_op.cc, truncated_gaussian_random_op.cc,
assign_value_op.cc, range_op.cc, reshape_op.cc, transpose_op.cc,
slice_op.cc, cast_op.cc, gather_op.cc, lookup_table_op.cc, where_op.cc,
top_k_op.cc.
The random ops draw from a ``torch.Generator`` seeded with the op's
``seed`` attr (assigned by the program, framework.Program.next_seed).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import generator, one


def _static_infer(op, block):
    """Output shape and dtype from the ``shape``/``dtype`` attrs."""
    shape = tuple(int(s) for s in op.attrs.get("shape", ()))
    for n in op.output("Out"):
        v = block._find_var_recursive(n)
        if v is not None:
            v.shape = shape
            v.dtype = op.attrs.get("dtype", "float32")


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------
@register_op("fill_constant", differentiable=False, infer_shape=_static_infer)
def fill_constant(inputs, attrs, device):
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    dt = core_types.torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": torch.full(shape, attrs.get("value", 0.0), dtype=dt, device=device)}


@register_op("uniform_random", differentiable=False, infer_shape=_static_infer, random=True)
def uniform_random(inputs, attrs, device):
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    u = torch.rand(shape, generator=generator(attrs.get("seed", 0), device),
                   dtype=torch.float32, device=device)
    out = u * (hi - lo) + lo
    return {"Out": out.to(core_types.torch_dtype(attrs.get("dtype", "float32")))}


@register_op("gaussian_random", differentiable=False, infer_shape=_static_infer, random=True)
def gaussian_random(inputs, attrs, device):
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    z = torch.randn(shape, generator=generator(attrs.get("seed", 0), device),
                    dtype=torch.float32, device=device)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": out.to(core_types.torch_dtype(attrs.get("dtype", "float32")))}


@register_op("truncated_gaussian_random", differentiable=False, infer_shape=_static_infer,
             random=True)
def truncated_gaussian_random(inputs, attrs, device):
    """mean + std * z, z a standard normal truncated to [-2, 2] (as
    jax.random.truncated_normal draws it): the inverse normal CDF of a
    uniform draw between the CDF's values at -2 and 2."""
    shape = tuple(int(s) for s in attrs.get("shape", ()))
    lo, hi = (0.5 * (1.0 + math.erf(b / math.sqrt(2.0))) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator(attrs.get("seed", 0), device),
                   dtype=torch.float32, device=device)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)).clamp(-2.0, 2.0)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": out.to(core_types.torch_dtype(attrs.get("dtype", "float32")))}


@register_op("assign_value", differentiable=False, infer_shape=_static_infer)
def assign_value(inputs, attrs, device):
    """The ``values`` attr (a flat list) as a tensor of ``shape``."""
    dt = core_types.canonical_dtype(attrs.get("dtype", "float32"))
    values = np.asarray(attrs["values"], dtype=core_types.np_dtype(dt))
    shape = tuple(int(s) for s in attrs["shape"])
    return {"Out": torch.from_numpy(values.reshape(shape)).to(
        device=device, dtype=core_types.torch_dtype(dt))}


@register_op("range", differentiable=False)
def range_op(inputs, attrs, device):
    dt = core_types.torch_dtype(attrs.get("dtype", "int64"))
    start, end, step = int(attrs["start"]), int(attrs["end"]), int(attrs["step"])
    return {"Out": torch.arange(start, end, step, dtype=dt, device=device)}


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------
def _reshape(x, shape):
    shape = [int(s) for s in shape]
    if 0 in shape:
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return x.reshape(tuple(shape))


def _xshape(x):
    # the reference's shape-carrying companion output: no data
    return torch.empty((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


def _reshape_infer(op, block):
    """Compile-time shape for reshape (the JAX package's
    ops/tensor_ops.py ``_reshape_infer``): a -1 target dim resolves statically only when
    every -1 input dim is copied through by a ``0`` target at the same
    position; otherwise it stays dynamic."""
    x = block.var(op.inputs["X"][0])
    if x.shape is None:
        return
    xshape = list(x.shape)
    tgt = [int(s) for s in op.attrs["shape"]]
    out = [xshape[i] if s == 0 and i < len(xshape) else s for i, s in enumerate(tgt)]
    if -1 in out:
        dyn_in = [i for i, s in enumerate(xshape) if s == -1]
        copied = all(i < len(tgt) and tgt[i] == 0 for i in dyn_in)
        if copied:
            neg = [i for i, s in enumerate(tgt) if s == -1]
            if len(neg) == 1:
                known_in = int(np.prod([s for s in xshape if s != -1])) or 1
                known_out = int(np.prod(
                    [s for i, s in enumerate(out) if s > 0 and i != neg[0]])) or 1
                out[neg[0]] = known_in // known_out
    v = block._find_var_recursive(op.outputs["Out"][0])
    if v is not None:
        v.shape = tuple(out)
        v.dtype = x.dtype
    if "XShape" in op.outputs:
        xs = block._find_var_recursive(op.outputs["XShape"][0])
        if xs is not None:
            xs.shape = (0,) + tuple(xshape)
            xs.dtype = x.dtype


@register_op("reshape2", infer_shape=_reshape_infer)
def reshape2(inputs, attrs, device):
    x = one(inputs, "X")
    return {"Out": _reshape(x, attrs["shape"]), "XShape": _xshape(x)}


@register_op("transpose2")
def transpose2(inputs, attrs, device):
    # a strided view: the consumer reads through its strides or copies
    x = one(inputs, "X")
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("slice")
def slice_op(inputs, attrs, device):
    x = one(inputs, "Input")
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register_op("cast")
def cast(inputs, attrs, device):
    """X in ``out_dtype`` (reference: operators/cast_op.cc).  Its vjp
    casts the gradient back to X's dtype, so fp32 master weights get
    fp32 gradients through the AMP rewrite's casts."""
    return {"Out": one(inputs, "X").to(core_types.torch_dtype(attrs["out_dtype"]))}


# ---------------------------------------------------------------------------
# indexing / embedding
# ---------------------------------------------------------------------------
@register_op("lookup_table", no_grad_set={"Ids"})
def lookup_table(inputs, attrs, device):
    """Embedding lookup (reference: operators/lookup_table_op.cc).  Ids
    may carry a trailing [..., 1] dim like the reference's LoDTensor ids."""
    w = one(inputs, "W")
    ids = one(inputs, "Ids")
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    out = w.index_select(0, ids.reshape(-1)).reshape(tuple(ids.shape) + tuple(w.shape[1:]))
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out * (ids != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": out}


@register_op("gather", no_grad_set={"Index"})
def gather(inputs, attrs, device):
    """Rows of X at Index (reference: operators/gather_op.cc)."""
    x, idx = one(inputs, "X"), one(inputs, "Index")
    return {"Out": x[idx.long()]}


@register_op("where", no_grad_set={"Condition"})
def where(inputs, attrs, device):
    return {"Out": torch.where(one(inputs, "Condition"), one(inputs, "X"), one(inputs, "Y"))}


@register_op("top_k", differentiable=False)
def top_k(inputs, attrs, device):
    vals, idx = torch.topk(one(inputs, "X"), attrs["k"])
    return {"Out": vals, "Indices": idx}
