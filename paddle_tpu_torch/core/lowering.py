"""Block interpreter: runs a block's ops one by one over torch kernels.

PyTorch port of the JAX package's ``core/lowering.py``.  The JAX package
traces the whole block into one XLA module; PyTorch runs eagerly, so
here ``trace_ops`` is an interpreter that calls each op's kernel on
real tensors in block order, and ``lower_block`` wraps it in the same
``fn(state, feed) -> (fetches, new_state)`` contract the executor
calls.  On a CUDA device each kernel launches asynchronously on the
current stream; nothing here synchronises.

``lower_block`` drops each value from the env after the last op that
reads or writes it, unless it is fetched or is state the caller stores
back, so a block holds only its live values: what XLA's buffer
assignment did for the JAX package.  A CUDA graph captured over the
block then keeps a memory pool of its peak live set, not of every
value it made.

A control-flow op holds its bodies as ``Block`` attrs and runs them
through ``run_sub_block``.  A body reads the values its op lists as
inputs, and any other name through the enclosing env, as the
reference's sub-scope reads its parent scope: ``op_reads`` counts those
reads at the op, at any depth, so a value stays alive until the last op
whose body reads it has run.
"""
from __future__ import annotations

import threading
from collections import ChainMap
from typing import Any, Dict, Iterator, List, Optional, Sequence, Set, Tuple

import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.registry import EMPTY_VAR_NAME

__all__ = ["lower_block", "trace_ops", "run_sub_block", "sub_blocks", "op_reads", "op_types"]

# the env of the innermost trace_ops on this thread: a sub-block's
# reads that its op does not list resolve there
_TRACE = threading.local()


def sub_blocks(op) -> List[Any]:
    """The blocks an op's attrs hold (a control-flow op's bodies)."""
    from paddle_tpu_torch.framework import Block

    return [v for v in op.attrs.values() if isinstance(v, Block)]


def _outer_reads(block) -> Set[str]:
    """Names a block's ops read before any op of the block writes them."""
    read: Set[str] = set()
    written: Set[str] = set()
    for op in block.ops:
        read.update(n for n in op_reads(op) if n not in written)
        written.update(op.output_arg_names)
    return read


def op_reads(op) -> List[str]:
    """The names an op reads: its inputs and, for a control-flow op, what
    its bodies read from outside them, at any depth."""
    names = list(op.input_arg_names)
    for blk in sub_blocks(op):
        names.extend(sorted(_outer_reads(blk) - set(names)))
    return names


def op_types(ops) -> Iterator[str]:
    """The op types of ``ops`` and of every body they hold, at any depth."""
    for op in ops:
        yield op.type
        for blk in sub_blocks(op):
            yield from op_types(blk.ops)


def _dead_after(ops, keep) -> List[Tuple[str, ...]]:
    """For each op, the names it is the last op to read or write, less
    ``keep``: their values are dead once it has run.  A control-flow op
    reads what its bodies read."""
    last: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for n in op_reads(op) + op.output_arg_names:
            last[n] = i
    dead: List[List[str]] = [[] for _ in ops]
    for n, i in last.items():
        if n not in keep and n != EMPTY_VAR_NAME:
            dead[i].append(n)
    return [tuple(d) for d in dead]


def trace_ops(ops, env: Dict[str, Any], device: torch.device, block=None,
              dead: Optional[Sequence[Tuple[str, ...]]] = None) -> Dict[str, Any]:
    """Run a sequence of Operators over an env of name -> tensor; with
    ``dead`` (``_dead_after``), drop each op's dead names after it."""
    outer = getattr(_TRACE, "env", None)
    _TRACE.env = env
    try:
        return _trace(ops, env, device, block, dead)
    finally:
        _TRACE.env = outer


def run_sub_block(block, local: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Run a control-flow op's body over ``local`` (its carries, step
    inputs and listed externals); a name not in ``local`` resolves in
    the enclosing trace's env.  Writes land in ``local``."""
    outer = getattr(_TRACE, "env", None)
    env = ChainMap(local, outer) if outer is not None else local
    try:
        trace_ops(block.ops, env, device, block)
    except KeyError as e:
        if device.type == "meta":  # shape inference has no enclosing env
            raise NotImplementedError(str(e)) from e
        raise
    return local


def _trace(ops, env, device, block, dead):
    for i, op in enumerate(ops):
        kernel = registry.get_kernel(op.type)
        ins: Dict[str, List[Any]] = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if n == EMPTY_VAR_NAME:
                    continue
                if n not in env:
                    raise KeyError(
                        "op %s input %s=%r not produced/fed (block %s)"
                        % (op.type, slot, n, getattr(block, "idx", "?"))
                    )
                vals.append(env[n])
            if vals:
                ins[slot] = vals
        outs = kernel(ins, op.attrs, device)
        if outs is None:
            continue
        for slot, names in op.outputs.items():
            vals = outs.get(slot)
            if vals is None:
                continue
            if not isinstance(vals, (list, tuple)):
                vals = [vals]
            for n, v in zip(names, vals):
                if n != EMPTY_VAR_NAME and v is not None:
                    env[n] = v
        if dead is not None:
            for n in dead[i]:
                env.pop(n, None)
    return env


def lower_block(
    block,
    feed_names: Sequence[str],
    fetch_names: Sequence[str],
    state_names: Sequence[str],
    device: torch.device,
):
    """Build ``fn(state_dict, feed_dict) -> (fetch_list, new_state_dict)``.

    ``state_names``: persistable vars the block writes (params, and in
    the training slice optimizer state), returned so the caller can
    store them back in the scope.
    """
    fetch_names = tuple(fetch_names)
    state_names = tuple(state_names)
    ops = list(block.ops)
    dead = _dead_after(ops, set(fetch_names) | set(state_names))

    def fn(state: Dict[str, Any], feed: Dict[str, Any]):
        env = dict(state)
        env.update(feed)
        trace_ops(ops, env, device, block, dead)
        fetches = [env[n] for n in fetch_names]
        new_state = {n: env[n] for n in state_names if n in env}
        return fetches, new_state

    return fn
