"""Block interpreter: runs a block's ops one by one over torch kernels.

PyTorch port of the JAX package's ``core/lowering.py``.  The JAX package
traces the whole block into one XLA module; PyTorch runs eagerly, so
here ``trace_ops`` is an interpreter that calls each op's kernel on
real tensors in block order, and ``lower_block`` wraps it in the same
``fn(state, feed) -> (fetches, new_state)`` contract the executor
calls.  On a CUDA device each kernel launches asynchronously on the
current stream; nothing here synchronises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core.registry import EMPTY_VAR_NAME

__all__ = ["lower_block", "trace_ops"]


def trace_ops(ops, env: Dict[str, Any], device: torch.device, block=None) -> Dict[str, Any]:
    """Run a sequence of Operators over an env of name -> tensor."""
    for op in ops:
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

    def fn(state: Dict[str, Any], feed: Dict[str, Any]):
        env = dict(state)
        env.update(feed)
        trace_ops(ops, env, device, block)
        fetches = [env[n] for n in fetch_names]
        new_state = {n: env[n] for n in state_names if n in env}
        return fetches, new_state

    return fn
