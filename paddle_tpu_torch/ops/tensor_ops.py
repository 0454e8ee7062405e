"""Tensor creation / manipulation ops (the JAX package's
``ops/tensor_ops.py``; ``sampling_id`` is registered by ``extended_ops``,
whose registration is the one the JAX package keeps).

Reference kernels: operators/fill_constant_op.cc, fill_zeros_like_op.cc,
fill_constant_batch_size_like_op.cc, assign_op.cc, concat_op.cc,
expand_op.cc, arg_max_op.cc, uniform_random_op.cc,
gaussian_random_op.cc, truncated_gaussian_random_op.cc,
assign_value_op.cc, range_op.cc, reshape_op.cc, transpose_op.cc,
slice_op.cc, cast_op.cc, gather_op.cc, lookup_table_op.cc, where_op.cc,
top_k_op.cc, squeeze_op.cc, unsqueeze_op.cc, flatten_op.cc, split_op.cc,
stack_op.cc, unstack_op.cc, strided_slice_op.cc, shape_op.cc, pad_op.cc,
pad2d_op.cc, one_hot_op.cc, gather_nd_op.cc, scatter_op.cc,
arg_min_op.cc, argsort_op.cc, cumsum_op.cc, crop_op.cc, linspace_op.cc,
meshgrid_op.cc, roll_op.cc, py_func_op.cc, and
distributed/parameter_prefetch.cc (the distributed lookup table's
gather).
The random ops draw from a ``torch.Generator`` seeded with the op's
``seed`` attr (assigned by the program, framework.Program.next_seed).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops import common
from paddle_tpu_torch.ops.common import generator, maybe, one


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


@register_op("fill_zeros_like", differentiable=False)
def fill_zeros_like(inputs, attrs, device):
    return {"Out": torch.zeros_like(one(inputs, "X"))}


@register_op("fill_constant_batch_size_like", differentiable=False)
def fill_constant_batch_size_like(inputs, attrs, device):
    """``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx`` (reference: fill_constant_batch_size_like_op.cc)."""
    x = one(inputs, "Input")
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = x.shape[attrs.get("input_dim_idx", 0)]
    dt = core_types.torch_dtype(attrs.get("dtype", "float32"))
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0), dtype=dt, device=x.device)}


@register_op("assign")
def assign(inputs, attrs, device):
    """X under a new name (reference: assign_op.cc).  Kernels never write
    their inputs in place, so the value is shared, not copied."""
    return {"Out": one(inputs, "X")}


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


@register_op("reshape", infer_shape=_reshape_infer)
def reshape(inputs, attrs, device):
    """The v1 reshape: no XShape output."""
    return {"Out": _reshape(one(inputs, "X"), attrs["shape"])}


@register_op("concat")
def concat(inputs, attrs, device):
    return {"Out": torch.cat(list(inputs["X"]), dim=attrs.get("axis", 0))}


@register_op("expand")
def expand(inputs, attrs, device):
    """X tiled ``expand_times`` along each dim (reference: expand_op.cc;
    ``jnp.tile``'s rule where the counts are fewer than the dims)."""
    x = one(inputs, "X")
    times = [int(t) for t in attrs["expand_times"]]
    times = [1] * (x.dim() - len(times)) + times
    return {"Out": x.repeat(*times)}


@register_op("transpose2")
def transpose2(inputs, attrs, device):
    # a strided view: the consumer reads through its strides or copies
    x = one(inputs, "X")
    return {"Out": x.permute(*attrs["axis"]), "XShape": _xshape(x)}


@register_op("transpose")
def transpose(inputs, attrs, device):
    """The v1 transpose: no XShape output."""
    return {"Out": one(inputs, "X").permute(*attrs["axis"])}


@register_op("squeeze2")
def squeeze2(inputs, attrs, device):
    """The ``axes`` of size 1 dropped (the others are kept, as the JAX
    op keeps them); no ``axes``: every dim of size 1."""
    x = one(inputs, "X")
    axes = attrs.get("axes", [])
    if axes:
        keep = {a % x.dim() for a in axes if x.shape[a % x.dim()] == 1}
        out = x.reshape(tuple(s for i, s in enumerate(x.shape) if i not in keep))
    else:
        out = x.reshape(tuple(s for s in x.shape if s != 1))
    return {"Out": out, "XShape": _xshape(x)}


@register_op("unsqueeze2")
def unsqueeze2(inputs, attrs, device):
    x = one(inputs, "X")
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": out, "XShape": _xshape(x)}


@register_op("flatten2")
def flatten2(inputs, attrs, device):
    """X as a matrix: the dims before ``axis`` are its rows."""
    x = one(inputs, "X")
    axis = attrs.get("axis", 1)
    rows = int(np.prod(tuple(x.shape[:axis])))
    return {"Out": x.reshape(rows, int(np.prod(tuple(x.shape[axis:])))), "XShape": _xshape(x)}


@register_op("split")
def split(inputs, attrs, device):
    """``num`` equal parts, or parts of the ``sections`` sizes, along ``axis``."""
    x = one(inputs, "X")
    axis = attrs.get("axis", 0)
    num = attrs.get("num", 0)
    if num:
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of size %d is not a multiple of num=%d"
                             % (axis, x.shape[axis], num))
        return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}
    idx = np.cumsum(attrs.get("sections", []))[:-1].tolist()
    return {"Out": list(torch.tensor_split(x, [int(i) for i in idx], dim=axis))}


@register_op("stack")
def stack(inputs, attrs, device):
    return {"Y": torch.stack(list(inputs["X"]), dim=attrs.get("axis", 0))}


@register_op("unstack")
def unstack(inputs, attrs, device):
    return {"Y": list(torch.unbind(one(inputs, "X"), dim=attrs.get("axis", 0)))}


@register_op("strided_slice")
def strided_slice(inputs, attrs, device):
    """Python's ``x[s:e:st]`` on each of ``axes``.  A negative stride (which
    torch's slicing does not take) gathers the indices Python's slice
    names, an arithmetic progression made by ``arange``."""
    x = one(inputs, "Input")
    for a, s, e, st in zip(attrs["axes"], attrs["starts"], attrs["ends"], attrs["strides"]):
        if st > 0:
            idx = [slice(None)] * x.dim()
            idx[a] = slice(s, e, st)
            x = x[tuple(idx)]
        else:
            picked = range(x.shape[a])[slice(s, e, st)]
            x = x.index_select(a, torch.arange(picked.start, picked.stop, picked.step,
                                               device=x.device))
    return {"Out": x}


@register_op("pad")
def pad(inputs, attrs, device):
    """``paddings`` as (before, after) pairs, one per dim, with ``pad_value``."""
    x = one(inputs, "X")
    p = [int(v) for v in attrs["paddings"]]
    flat = [v for i in reversed(range(x.dim())) for v in (p[2 * i], p[2 * i + 1])]
    return {"Out": F.pad(x, flat, value=float(attrs.get("pad_value", 0.0)))}


@register_op("pad2d")
def pad2d(inputs, attrs, device):
    """H and W of an NCHW tensor padded by (top, bottom, left, right):
    ``constant`` with ``pad_value``, ``reflect`` or ``edge``."""
    x = one(inputs, "X")
    t, b, l, r = (int(v) for v in attrs["paddings"])
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return {"Out": F.pad(x, (l, r, t, b), value=float(attrs.get("pad_value", 0.0)))}
    return {"Out": F.pad(x, (l, r, t, b), mode={"reflect": "reflect", "edge": "replicate"}[mode])}


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


@register_op("distributed_lookup_table", no_grad_set={"Ids", "OrigIds"})
def distributed_lookup_table(inputs, attrs, device):
    """Lookup over host-prefetched rows (reference:
    operators/distributed/parameter_prefetch.cc + prefetch_op).

    The executor pulls the batch's unique rows from the parameter server
    before the step and feeds them as ``Rows``, with the int32 ids-to-row
    map ``Ids`` (index_select takes it as it is, on the card too); the
    op is a gather, so its vjp is the scatter-add (``index_add_``) whose
    result is the sparse gradient pushed back after the step
    (executor.py ``_prefetch_distributed_tables``).  ``OrigIds`` and
    ``padding_idx`` mask pad tokens to zero rows (and, through the vjp,
    zero their pushed gradients) as ``lookup_table`` does."""
    rows = one(inputs, "Rows")
    ids = one(inputs, "Ids")
    out = rows.index_select(0, ids.reshape(-1)).reshape(tuple(ids.shape) + tuple(rows.shape[1:]))
    padding_idx = attrs.get("padding_idx", -1)
    orig = one(inputs, "OrigIds")
    if padding_idx is not None and padding_idx >= 0 and orig is not None:
        if orig.dim() >= 2 and orig.shape[-1] == 1:
            orig = orig.squeeze(-1)
        out = out * (orig != padding_idx).unsqueeze(-1).to(out.dtype)
    return {"Out": out}


@register_op("lookup_table_v2", no_grad_set={"Ids"})
def lookup_table_v2(inputs, attrs, device):
    return lookup_table(inputs, attrs, device)


@register_op("one_hot", differentiable=False)
def one_hot(inputs, attrs, device):
    """float32 rows with a 1 at each id (a trailing [..., 1] dim of the
    ids is dropped); an id outside [0, depth) gives a row of zeros, as
    ``jax.nn.one_hot`` (``F.one_hot`` would check the ids on the host)."""
    x = one(inputs, "X")
    if x.dim() >= 2 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    classes = torch.arange(int(attrs["depth"]), device=x.device)
    return {"Out": (x.unsqueeze(-1) == classes).to(torch.float32)}


@register_op("gather_nd", no_grad_set={"Index"})
def gather_nd(inputs, attrs, device):
    """X at each index tuple of Index's last dim."""
    x, idx = one(inputs, "X"), one(inputs, "Index").long()
    return {"Out": x[tuple(idx[..., i] for i in range(idx.shape[-1]))]}


@register_op("scatter", no_grad_set={"Ids"})
def scatter(inputs, attrs, device):
    """X with rows Ids set to (``overwrite``) or added by Updates."""
    x, ids, upd = one(inputs, "X"), one(inputs, "Ids").long(), one(inputs, "Updates")
    return {"Out": x.index_put((ids,), upd, accumulate=not attrs.get("overwrite", True))}


@register_op("gather", no_grad_set={"Index"})
def gather(inputs, attrs, device):
    """Rows of X at Index (reference: operators/gather_op.cc)."""
    x, idx = one(inputs, "X"), one(inputs, "Index")
    return {"Out": x[idx.long()]}


@register_op("where", no_grad_set={"Condition"})
def where(inputs, attrs, device):
    return {"Out": torch.where(one(inputs, "Condition"), one(inputs, "X"), one(inputs, "Y"))}


@register_op("arg_max", differentiable=False)
def arg_max(inputs, attrs, device):
    """The first index of the largest value (as ``jnp.argmax``)."""
    return {"Out": torch.argmax(one(inputs, "X"), dim=attrs.get("axis", -1))}


@register_op("top_k", differentiable=False)
def top_k(inputs, attrs, device):
    vals, idx = common.top_k(one(inputs, "X"), attrs["k"])
    return {"Out": vals, "Indices": idx}


@register_op("arg_min", differentiable=False)
def arg_min(inputs, attrs, device):
    """The first index of the smallest value (as ``jnp.argmin``)."""
    return {"Out": torch.argmin(one(inputs, "X"), dim=attrs.get("axis", -1))}


@register_op("argsort", differentiable=False)
def argsort(inputs, attrs, device):
    """The stable ascending order along ``axis``; ``descending`` reverses
    it (so ties come last index first), as the JAX op does."""
    x = one(inputs, "X")
    axis = attrs.get("axis", -1)
    idx = torch.argsort(x, dim=axis, stable=True)
    if attrs.get("descending", False):
        idx = torch.flip(idx, dims=(axis,))
    return {"Out": torch.take_along_dim(x, idx, dim=axis), "Indices": idx}


@register_op("cumsum")
def cumsum(inputs, attrs, device):
    """Running sums along ``axis`` (over the flattened X with ``flatten``),
    from the end with ``reverse``, each leaving out its own element with
    ``exclusive``; in X's type."""
    x = one(inputs, "X")
    axis = attrs.get("axis", -1)
    if attrs.get("flatten", False):
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    if attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), dim=axis, dtype=x.dtype), (axis,))
    else:
        out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get("exclusive", False):
        # the JAX op shifts the sums one place along the axis, with a 0 in front
        out = F.pad(out.movedim(axis, -1), (1, 0)).narrow(-1, 0, x.shape[axis]).movedim(-1, axis)
    return {"Out": out}


@register_op("uniform_random_batch_size_like", differentiable=False, random=True)
def uniform_random_batch_size_like(inputs, attrs, device):
    """Uniform in [min, max) of ``shape``, its dim ``output_dim_idx`` taken
    from Input's dim ``input_dim_idx``."""
    x = one(inputs, "Input")
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = x.shape[attrs.get("input_dim_idx", 0)]
    dt = core_types.torch_dtype(attrs.get("dtype", "float32"))
    if x.device.type == "meta":  # shape inference: no generator there
        return {"Out": torch.empty(tuple(shape), dtype=dt, device=x.device)}
    lo, hi = float(attrs.get("min", -1.0)), float(attrs.get("max", 1.0))
    u = torch.rand(tuple(shape), generator=generator(attrs.get("seed", 0), x.device),
                   dtype=torch.float32, device=x.device)
    return {"Out": (u * (hi - lo) + lo).to(dt)}


@register_op("crop", no_grad_set={"Offsets"})
def crop(inputs, attrs, device):
    """reference: operators/crop_op.cc.  The block of Y's shape (or the
    ``shape`` attr) at ``offsets``; an offset is clamped so that the block
    fits, as ``jax.lax.dynamic_slice`` clamps it."""
    x = one(inputs, "X")
    offs = attrs.get("offsets") or [0] * x.dim()
    y = maybe(inputs, "Y")
    shape = list(y.shape) if y is not None else [int(v) for v in attrs.get("shape")]
    for d, (o, n) in enumerate(zip(offs, shape)):
        x = x.narrow(d, min(max(int(o), 0), x.shape[d] - n), n)
    return {"Out": x}


@register_op("crop_tensor", no_grad_set={"Shape", "Offsets"})
def crop_tensor(inputs, attrs, device):
    return crop(inputs, attrs, device)


@register_op("pad_constant_like", no_grad_set={"X"})
def pad_constant_like(inputs, attrs, device):
    """reference: operators/pad_constant_like_op.cc: Y padded at the end of
    each dim up to X's shape with ``pad_value``."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    flat = [v for i in reversed(range(y.dim())) for v in (0, int(x.shape[i] - y.shape[i]))]
    return {"Out": F.pad(y, flat, value=float(attrs.get("pad_value", 0.0)))}


@register_op("linspace", differentiable=False, host_read=True)
def linspace(inputs, attrs, device):
    """``Num`` evenly spaced values from Start to Stop (both included).
    The count is read on the host, so a plan holding the op stays on the
    interpreter."""
    start = one(inputs, "Start").reshape(()).to(torch.float32)
    stop = one(inputs, "Stop").reshape(()).to(torch.float32)
    num = int(one(inputs, "Num").reshape(()).item())
    dt = core_types.torch_dtype(attrs.get("dtype", "float32"))
    if num == 1:
        return {"Out": start.reshape(1).to(dt)}
    step = (stop - start) / (num - 1)
    out = start + torch.arange(num, dtype=torch.float32, device=start.device) * step
    out = torch.cat([out[:-1], stop.reshape(1)])  # the last value is Stop itself
    return {"Out": out.to(dt)}


@register_op("meshgrid")
def meshgrid(inputs, attrs, device):
    return {"Out": list(torch.meshgrid(*inputs["X"], indexing="ij"))}


@register_op("roll")
def roll(inputs, attrs, device):
    """X shifted by ``shifts`` along ``axis`` (``dims``), elements leaving
    one end entering at the other; with no axis, over the flattened X."""
    x = one(inputs, "X")
    shifts = [int(v) for v in attrs.get("shifts", [0])]
    dims = attrs.get("axis", attrs.get("dims", None))
    if dims is None:
        return {"Out": torch.roll(x.reshape(-1), shifts[0]).reshape(x.shape)}
    return {"Out": torch.roll(x, shifts, dims=tuple(dims))}


@register_op("shape", differentiable=False)
def shape_op(inputs, attrs, device):
    """Input's shape as an int32 [rank] tensor."""
    x = one(inputs, "Input")
    return {"Out": _host_ints(tuple(x.shape), torch.int32, x.device)}


@register_op("py_func", differentiable=False, host_read=True)
def py_func(inputs, attrs, device):
    """reference: operators/py_func_op.cc.  The host function registered by
    ``layers.py_func`` runs at the op's place in the step, on numpy copies
    of the inputs; its results go to the inputs' device.  That is a host
    read, so a plan holding the op stays on the interpreter.  The output
    shapes follow the JAX op's rules: a -1 only in position 0, the first
    input's batch, or ``out_shape_fn`` of the input shapes."""
    from paddle_tpu_torch.layers import nn as nn_layers
    from paddle_tpu_torch.scope import to_numpy

    fn, out_specs, out_shape_fn = nn_layers._PY_FUNC_REGISTRY[int(attrs["func_id"])]
    xs = inputs.get("X", [])
    if out_shape_fn is not None:
        shapes = [tuple(int(v) for v in s) for s in out_shape_fn([tuple(x.shape) for x in xs])]
        if any(d < 0 for s in shapes for d in s):
            raise ValueError("py_func out_shape_fn returned a non-static shape: %r" % (shapes,))
    else:
        batch = int(xs[0].shape[0]) if xs and xs[0].dim() else None
        shapes = []
        for s, _ in out_specs:
            shape = []
            for i, d in enumerate(s):
                if d >= 0:
                    shape.append(d)
                elif i == 0 and batch is not None:
                    shape.append(batch)
                else:
                    raise ValueError(
                        "py_func output shape %r has a dynamic dim outside position 0: "
                        "pass out_shape_fn to py_func" % (s,))
            shapes.append(tuple(shape))
    dtypes = [core_types.torch_dtype(core_types.canonical_dtype(d)) for _, d in out_specs]
    if device.type == "meta":  # shape inference: the function is not called
        return {"Out": [torch.empty(s, dtype=d, device=device) for s, d in zip(shapes, dtypes)]}
    out = fn(*[to_numpy(x) for x in xs])
    if not isinstance(out, (list, tuple)):
        out = (out,)
    dev = xs[0].device if xs else device
    res = []
    for o, shape, dt in zip(out, shapes, dtypes):
        arr = np.asarray(o).reshape(shape)
        res.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device=dev, dtype=dt))
    return {"Out": res}


def _host_ints(values, dtype, device):
    """A 1-d tensor of host integers on ``device``, made by fills (a copy
    from pageable host memory is not allowed while a CUDA graph is being
    captured)."""
    if device.type != "cuda":
        return torch.tensor(list(values), dtype=dtype, device=device)
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out.narrow(0, i, 1).fill_(int(v))  # a fill kernel with the value as its argument
    return out
