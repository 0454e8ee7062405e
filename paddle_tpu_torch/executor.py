"""Executor: runs a Program's global block on one device.

Port of the JAX package's ``executor.py``'s single-device ``Executor.run``
(reference: python/paddle/fluid/executor.py).  The JAX package compiles
the block into one XLA step per feed signature; PyTorch runs eagerly,
so ``run`` interprets the block op by op (``core/lowering.py``) on the
executor's ``torch.device``, reading persistable state from the scope
and writing back what the block updates.  One ``run`` serves both the
startup program (which writes the initialised parameters) and the main
program.  Multi-step runs, plan and compile caches and the parameter
server paths come with later slices of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.scope import Scope, global_scope, to_numpy

__all__ = ["Executor"]


def _as_fetch_name(f) -> str:
    return f.name if isinstance(f, framework.Variable) else str(f)


class Executor:
    """``Executor()`` and ``Executor(CUDAPlace(0))`` run on ``cuda:0``
    and raise when there is no CUDA device; ``Executor(CPUPlace())``
    runs on the CPU."""

    def __init__(self, place: Optional[framework.Place] = None):
        self.place = place if place is not None else framework.CUDAPlace(0)
        self.device: torch.device = framework.device_of(place)

    def _feed_tensor(self, name: str, val, block) -> torch.Tensor:
        """Feed value -> tensor on the device, in the program var's dtype."""
        var = block._find_var_recursive(name)
        dt = core_types.torch_dtype(var.dtype) if var is not None else None
        if isinstance(val, torch.Tensor):
            return val.to(device=self.device, dtype=dt or val.dtype)
        arr = np.asarray(val)
        if dt is not None and dt != torch.bfloat16:
            arr = arr.astype(core_types.np_dtype(var.dtype), copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if dt is not None:
            t = t.to(dt)
        return t.to(self.device, non_blocking=True)

    def run(
        self,
        program: Optional[framework.Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        program = program if program is not None else framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        scope.bind_device(self.device)
        feed = dict(feed or {})
        block = program.global_block()
        fetch_names = [_as_fetch_name(f) for f in (fetch_list or [])]

        # true dataflow reads: a name is read from outside only when some
        # op reads it before any op writes it
        persistable = {v.name for v in program.list_vars() if v.persistable}
        read, written = set(), set()
        for op in block.ops:
            for n in op.input_arg_names:
                if n not in written:
                    read.add(n)
            written.update(op.output_arg_names)
        for n in fetch_names:
            if n in persistable and n not in written:
                read.add(n)
        state_in = sorted((read & persistable) - set(feed))
        state_out = sorted(written & persistable)

        state, missing = {}, []
        for n in state_in:
            v = scope.get(n)
            if v is None:
                missing.append(n)
            else:
                state[n] = v
        if missing:
            raise RuntimeError(
                "Variables %s are not initialized in scope — run the startup "
                "program first (reference: executor.py run startup)" % missing)
        feed_tensors = {n: self._feed_tensor(n, v, block) for n, v in feed.items()}

        fn = lowering.lower_block(block, list(feed_tensors), fetch_names, state_out, self.device)
        with torch.no_grad():
            fetches, new_state = fn(state, feed_tensors)
        for n, v in new_state.items():
            scope.vars[n] = v
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches
