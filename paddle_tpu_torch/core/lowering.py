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
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.registry import EMPTY_VAR_NAME

__all__ = ["lower_block", "trace_ops"]


def _dead_after(ops, keep) -> List[Tuple[str, ...]]:
    """For each op, the names it is the last op to read or write, less
    ``keep``: their values are dead once it has run."""
    last: Dict[str, int] = {}
    for i, op in enumerate(ops):
        for n in op.input_arg_names + op.output_arg_names:
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
