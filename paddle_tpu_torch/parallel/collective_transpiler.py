"""Collective program rewriters: GradAllReduce / LocalSGD.

The port's own copy of the JAX package's ``parallel/collective_transpiler.py``
(reference: python/paddle/fluid/transpiler/collective.py — Collective:36,
GradAllReduce:178 (insert c_allreduce_sum on each grad between backward
and optimize), LocalSGD:269 (periodic parameter averaging instead of
per-step allreduce)).  The rewritten Program is the JAX package's, op for
op, but for one repair: where a parameter's update reads an accumulation
of its gradient (a parameter used twice, as BERT's word embedding is by
its tied MLM output: ``sum`` writes ``<param>@GRAD@SUM``), GradAllReduce
reduces that accumulation, as Fluid's collective.py reduces the gradient
its ``op_role_var`` names.  The JAX package reduces the first partial
after the ``sum`` has read it, so such a parameter trains on its rank's
own gradient there.

The inserted ``c_allreduce_sum`` ops call ``torch.distributed`` on the
process group bound to their ring_id (``ops/collective_ops.py``,
``parallel/env.py``); they are identities on a ring with no group bound,
so the same rewritten program runs in one process and in several.
"""
from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import Program

__all__ = ["Collective", "GradAllReduce", "LocalSGD"]


class Collective:
    """Base rewriter (reference: transpiler/collective.py:36).  The NCCL
    bootstrap ops (c_gen_nccl_id/c_comm_init) are appended to startup;
    here c_comm_init checks that the ring's process group has the ranks
    the program was rewritten for."""

    def __init__(self, nrings: int = 1):
        self.nrings = nrings
        self.nranks = 1
        self.rank = 0

    def transpile(self, startup_program: Program, main_program: Program,
                  rank: int, endpoints: List[str], current_endpoint: str,
                  wait_port: bool = True):
        self.rank = rank
        self.nranks = max(1, len(endpoints))
        self.startup_program = startup_program or framework.default_startup_program()
        self.main_program = main_program or framework.default_main_program()
        self._transpile_startup_program()
        self._transpile_main_program()
        self.main_program.version += 1
        return self

    def _transpile_startup_program(self):
        block = self.startup_program.global_block()
        for ring_id in range(self.nrings):
            block.append_op(type="c_gen_nccl_id", inputs={}, outputs={}, attrs={"ring_id": ring_id})
            block.append_op(
                type="c_comm_init",
                inputs={},
                outputs={},
                attrs={"ring_id": ring_id, "nranks": self.nranks, "rank": self.rank},
            )

    def _transpile_main_program(self):
        raise NotImplementedError

    # --- helpers ---
    def _grad_vars(self, block):
        """(param, grad_name, insert_idx): grads written by backward ops."""
        out = []
        params = {p.name for p in block.all_parameters() if getattr(p, "trainable", True)}
        for idx, op in enumerate(block.ops):
            if op.attrs.get("op_role") != "backward":
                continue
            for n in op.output_arg_names:
                if n.endswith(framework.GRAD_SUFFIX) and n[: -len(framework.GRAD_SUFFIX)] in params:
                    out.append((n[: -len(framework.GRAD_SUFFIX)], n, idx))
        return out

    def _update_grads(self, block):
        """param -> the gradient name its update op reads."""
        return {op.inputs["Param"][0]: op.inputs["Grad"][0] for op in block.ops
                if op.attrs.get("op_role") == "optimize" and op.inputs.get("Param")
                and op.inputs.get("Grad")}

    def _first_optimize_idx(self, block):
        for idx, op in enumerate(block.ops):
            if op.attrs.get("op_role") == "optimize":
                return idx
        return len(block.ops)


class GradAllReduce(Collective):
    """reference: transpiler/collective.py:178."""

    def _transpile_main_program(self):
        block = self.main_program.global_block()
        grads = self._grad_vars(block)
        insert_at = self._first_optimize_idx(block)
        update_grads = self._update_grads(block)
        ring = 0
        ops = []
        accumulated = set()
        for param, gname, _ in grads:
            target = update_grads.get(param, gname)
            if target != gname:  # the update reads an accumulation: reduce it, once
                if target in accumulated:
                    continue
                accumulated.add(target)
            ops.append(("c_allreduce_sum", target, ring))
            ring = (ring + 1) % self.nrings
        # insert in reverse so indices stay valid
        for op_type, gname, ring_id in reversed(ops):
            block._insert_op(
                insert_at,
                type="scale",
                inputs={"X": [gname]},
                outputs={"Out": [gname]},
                attrs={"scale": 1.0 / self.nranks, "op_role": "backward"},
            )
            block._insert_op(
                insert_at,
                type=op_type,
                inputs={"X": [gname]},
                outputs={"Out": [gname]},
                attrs={"ring_id": ring_id, "op_role": "backward"},
            )


class LocalSGD(Collective):
    """reference: transpiler/collective.py:269 — every ``k_steps`` the
    params are averaged across ranks instead of per-step grad allreduce."""

    def __init__(self, nrings: int = 1, k_steps: int = 4):
        super().__init__(nrings)
        self.k_steps = k_steps

    def _transpile_main_program(self):
        from paddle_tpu_torch import unique_name

        block = self.main_program.global_block()
        # step counter
        counter = block.create_var(
            name=unique_name.generate("@LOCAL_SGD_COUNTER@"),
            shape=[1], dtype="float32", persistable=True, stop_gradient=True,
        )
        sblock = self.startup_program.global_block()
        sblock.create_var(name=counter.name, shape=[1], dtype="float32", persistable=True)
        sblock.append_op(
            type="fill_constant",
            inputs={},
            outputs={"Out": [counter.name]},
            attrs={"shape": [1], "dtype": "float32", "value": 0.0},
        )
        block.append_op(
            type="scale",
            inputs={"X": [counter]},
            outputs={"Out": [counter]},
            attrs={"scale": 1.0, "bias": 1.0, "op_role": "optimize"},
        )
        # every k steps: param <- psum(param)/nranks  (gated in-graph)
        for p in block.all_parameters():
            if not getattr(p, "trainable", True):
                continue
            summed = block.create_var(
                name=unique_name.generate(p.name + "@LOCAL_SGD_AVG@"),
                shape=p.shape, dtype=p.dtype,
            )
            block.append_op(
                type="c_allreduce_sum",
                inputs={"X": [p]},
                outputs={"Out": [summed]},
                attrs={"ring_id": 0, "op_role": "optimize"},
            )
            block.append_op(
                type="local_sgd_select",
                inputs={"Param": [p], "Avg": [summed], "Step": [counter]},
                outputs={"Out": [p]},
                attrs={"k_steps": self.k_steps, "nranks": self.nranks, "op_role": "optimize"},
            )
