"""Control-flow ops: while / cond / static_rnn over sub-blocks, and the
tensor arrays.

PyTorch port of the JAX package's ``ops/control_flow_ops.py``
(reference: paddle/fluid/operators/controlflow/while_op.cc,
conditional_block_op.cc, recurrent_op.cc).  The layers
(``layers/control_flow.py``) make the loop-carried variables explicit at
build time, as in the JAX package; there a body was traced into
``lax.while_loop`` / ``lax.cond`` / ``lax.scan``.  Here a body is run by
the interpreter (``core/lowering.run_sub_block``) once a step, in a
Python loop over tensors, so a CUDA graph captured over the plan holds
every step's launches.

Two kinds of op, by what a capture can hold:

* ``while``, ``conditional_block`` and ``select_branch`` read their
  predicate on the host (``bool(t)``), which synchronises the stream and
  cannot be captured.  They are registered ``host_read=True``: a plan
  that holds one, at any depth, stays on the interpreter.
* ``bounded_while``, ``static_rnn`` and ``dynamic_rnn`` have static trip
  counts and read nothing on the host: a finished carry is held by
  ``torch.where`` on a device-side mask.  Their plans are captured, and
  the generic vjp (``core/registry.py`` ``make_vjp_grad_kernel``) re-runs
  the loop under autograd, which gives the gradient through every step.

A tensor array is a stacked ``[A, ...]`` tensor, as in the JAX package.
``write_to_array`` returns a new array (``index_copy``) with its index
on the device: writing in place would change the value the vjp's
recompute and a captured graph read.  Indices are clamped to the array,
as ``jax.lax.dynamic_update_index_in_dim`` clamps them.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one


def _pred(x) -> bool:
    """The predicate's value, read on the host."""
    return bool(x.reshape(()))


def _split(xs, sizes):
    out, i = [], 0
    for n in sizes:
        out.append(list(xs[i: i + n]))
        i += n
    out.append(list(xs[i:]))
    return out


@register_op("while", differentiable=False, host_read=True)
def while_op(inputs, attrs, device):
    """inputs X = carried vars (ordered carry_names) + externals
    (ordered external_names); outputs Out = final carried values."""
    block = attrs["sub_block"]
    carry_names = list(attrs["carry_names"])
    carry, ext = _split(inputs.get("X", []), [len(carry_names)])
    ext = dict(zip(attrs["external_names"], ext))
    ci = carry_names.index(attrs["cond_name"])
    while _pred(carry[ci]):
        env = dict(zip(carry_names, carry))
        env.update(ext)
        lowering.run_sub_block(block, env, device)
        carry = [env[n] for n in carry_names]
    return {"Out": carry}


@register_op("conditional_block", host_read=True)
def conditional_block(inputs, attrs, device):
    """Run the sub-block iff Cond is true; carried vars pass through
    unchanged otherwise."""
    carry_names = list(attrs["carry_names"])
    carry, ext = _split(inputs.get("X", []), [len(carry_names)])
    if not _pred(one(inputs, "Cond")):
        return {"Out": carry}
    env = dict(zip(carry_names, carry))
    env.update(zip(attrs["external_names"], ext))
    lowering.run_sub_block(attrs["sub_block"], env, device)
    return {"Out": [env[n] for n in carry_names]}


@register_op("select_branch", host_read=True)
def select_branch(inputs, attrs, device):
    """Two-armed cond (``layers.cond``): the chosen block produces the
    vars in out_names."""
    block = attrs["true_block"] if _pred(one(inputs, "Cond")) else attrs["false_block"]
    env = dict(zip(attrs["external_names"], inputs.get("X", [])))
    lowering.run_sub_block(block, env, device)
    return {"Out": [env[n] for n in attrs["out_names"]]}


@register_op("static_rnn")
def static_rnn(inputs, attrs, device):
    """A step of the sub-block per time step of the [T, ...] inputs.

    inputs X = step inputs (ordered x_names) + memory inits (ordered
    mem_names) + externals (ordered external_names); outputs Out =
    stacked step outputs [T, ...] (ordered out_names), then the final
    memories."""
    block = attrs["sub_block"]
    x_names, mem_names = list(attrs["x_names"]), list(attrs["mem_names"])
    seqs, mem, ext = _split(inputs["X"], [len(x_names), len(mem_names)])
    ext = dict(zip(attrs["external_names"], ext))
    out_names, mem_out_names = list(attrs["out_names"]), list(attrs["mem_out_names"])
    outs = [[] for _ in out_names]
    for t in range(seqs[0].shape[0]):
        env = dict(zip(mem_names, mem))
        env.update(zip(x_names, [s[t] for s in seqs]))
        env.update(ext)
        lowering.run_sub_block(block, env, device)
        mem = [env[n] for n in mem_out_names]
        for o, n in zip(outs, out_names):
            o.append(env[n])
    return {"Out": [torch.stack(o) for o in outs] + mem}


@register_op("bounded_while")
def bounded_while(inputs, attrs, device):
    """A While with a static trip bound: ``max_trip_count`` steps, each
    carry held by ``torch.where`` once the condition is false, so the
    result is the dynamic while's for any trip count up to the bound,
    with no host read."""
    block = attrs["sub_block"]
    carry_names = list(attrs["carry_names"])
    carry, ext = _split(inputs["X"], [len(carry_names)])
    ext = dict(zip(attrs["external_names"], ext))
    ci = carry_names.index(attrs["cond_name"])
    for _ in range(int(attrs["max_trip_count"])):
        active = carry[ci].reshape(()).to(torch.bool)
        env = dict(zip(carry_names, carry))
        env.update(ext)
        lowering.run_sub_block(block, env, device)
        carry = [torch.where(active, env[n], c) for n, c in zip(carry_names, carry)]
    return {"Out": carry}


@register_op("dynamic_rnn", no_grad_set={"SeqLen"})
def dynamic_rnn(inputs, attrs, device):
    """Variable-length recurrence on the padded encoding: X holds step
    inputs [B, T, ...], memory inits and statics, SeqLen [B].  Each step
    is masked by ``t < SeqLen`` on the device: a finished sequence holds
    its memories and emits zeros.  Outputs Out = stacked step outputs
    [B, T, ...], then the final memories."""
    block = attrs["sub_block"]
    x_names, mem_names = list(attrs["x_names"]), list(attrs["mem_names"])
    seqs, mem, statics = _split(inputs["X"], [len(x_names), len(mem_names)])
    statics = dict(zip(attrs["static_names"], statics))
    seq_len = one(inputs, "SeqLen")
    out_names, mem_out_names = list(attrs["out_names"]), list(attrs["mem_out_names"])
    T = seqs[0].shape[1] if seqs else int(attrs.get("max_len"))
    outs = [[] for _ in out_names]

    def mask(active, v):
        return active.reshape((-1,) + (1,) * (v.dim() - 1))

    for t in range(T):
        env = dict(zip(mem_names, mem))
        env.update(zip(x_names, [s[:, t] for s in seqs]))
        env.update(statics)
        lowering.run_sub_block(block, env, device)
        active = seq_len > t  # [B] bool, on the device
        mem = [torch.where(mask(active, env[n]), env[n], c) for n, c in zip(mem_out_names, mem)]
        for o, n in zip(outs, out_names):
            v = env[n]
            o.append(torch.where(mask(active, v), v, torch.zeros_like(v)))
    return {"Out": [torch.stack(o, dim=1) for o in outs] + mem}


# ---------------------------------------------------------------------------
# tensor arrays: a stacked [A, ...] tensor
# ---------------------------------------------------------------------------
def _index(inputs, arr):
    """The array index, on the device, clamped to [0, A - 1]."""
    return one(inputs, "I").reshape(1).long().clamp(0, arr.shape[0] - 1)


@register_op("write_to_array", no_grad_set={"I"})
def write_to_array(inputs, attrs, device):
    """Array [A, ...], I scalar index, X value -> a new array with slot I
    replaced."""
    arr = one(inputs, "Array")
    x = one(inputs, "X").to(arr.dtype)
    return {"Out": arr.index_copy(0, _index(inputs, arr), x.unsqueeze(0))}


@register_op("read_from_array", no_grad_set={"I"})
def read_from_array(inputs, attrs, device):
    arr = one(inputs, "X")
    return {"Out": arr.index_select(0, _index(inputs, arr)).squeeze(0)}


@register_op("lod_array_length", differentiable=False)
def lod_array_length(inputs, attrs, device):
    arr = one(inputs, "X")
    return {"Out": torch.full((1,), arr.shape[0], dtype=torch.int64, device=arr.device)}
