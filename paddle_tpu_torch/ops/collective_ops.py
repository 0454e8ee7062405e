"""Collective ops: c_allreduce_* / c_broadcast / c_allgather / c_reducescatter.

The port's own copy of the JAX package's ``ops/collective_ops.py``
(reference: paddle/fluid/operators/collective/c_allreduce_op.h:57-110 and
friends, CUDA kernels calling ncclAllReduce on a ring_id-keyed comm).
Here each op calls ``torch.distributed`` on the process group bound to
its ``ring_id`` (``parallel/env.py``).  On a ring with no group bound, and
on ``meta`` tensors (shape inference), each op is the identity: the JAX
package's behaviour outside a mapped axis, and the reference's with one
trainer.

A collective blocks the host until its peers join, so a plan that holds
one on a ring of more than one rank stays on the interpreter
(``live_collectives``, read into the executor plan's ``eager_ops``); at
one rank the plan captures.  Over gloo, which reduces CUDA tensors
through host copies but gathers only CPU tensors, ``c_allgather`` moves
a CUDA tensor to the host and back.
"""
from __future__ import annotations

from typing import Iterable, Set

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import one
from paddle_tpu_torch.parallel import env as penv

# the op types whose kernels call torch.distributed on their ring
COLLECTIVE_OPS = frozenset((
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
    "allreduce", "c_broadcast", "c_allgather", "c_reducescatter"))


def live_collectives(ops) -> Set[str]:
    """The collective op types of ``ops`` (and of their bodies, at any
    depth) whose ring has a group of more than one rank bound."""
    from paddle_tpu_torch.core import lowering

    live = set()

    def walk(ops_: Iterable):
        for op in ops_:
            if op.type in COLLECTIVE_OPS and penv.ring_size(op.attrs.get("ring_id", 0)) > 1:
                live.add(op.type)
            for blk in lowering.sub_blocks(op):
                walk(blk.ops)

    walk(ops)
    return live


def _group(x, attrs):
    """The op's process group, or None where the op is the identity."""
    if x.device.type == "meta":
        return None
    group = penv.group_for_ring(attrs.get("ring_id", 0))
    if group is None:
        return None
    import torch.distributed as dist

    return group if dist.get_world_size(group) > 1 else None


def _allreduce(op_name, reduce_op):
    @register_op(op_name, differentiable=False)
    def kernel(inputs, attrs, device, _red=reduce_op):
        import torch.distributed as dist

        x = one(inputs, "X")
        group = _group(x, attrs)
        if group is None:
            return {"Out": x}
        out = x.clone()
        dist.all_reduce(out, op=getattr(dist.ReduceOp, _red), group=group)
        return {"Out": out}

    return kernel


_allreduce("c_allreduce_sum", "SUM")
_allreduce("c_allreduce_max", "MAX")
_allreduce("c_allreduce_min", "MIN")
# the product of the ranks' values, signs and zeros included: torch's
# PRODUCT reduction multiplies, where the JAX package must build it from
# sums of logs, negative counts and a zero flag (c_allreduce_op.h:57-110)
_allreduce("c_allreduce_prod", "PRODUCT")
# the legacy nccl-style allreduce op (reference: operators/distributed_ops/allreduce_op.cc)
_allreduce("allreduce", "SUM")


@register_op("c_broadcast", differentiable=False)
def c_broadcast(inputs, attrs, device):
    """Every rank takes the value of the ring's rank ``root``."""
    import torch.distributed as dist

    x = one(inputs, "X")
    group = _group(x, attrs)
    if group is None:
        return {"Out": x}
    out = x.clone()
    dist.broadcast(out, src=dist.get_global_rank(group, int(attrs.get("root", 0))), group=group)
    return {"Out": out}


@register_op("c_allgather", differentiable=False)
def c_allgather(inputs, attrs, device):
    """The ranks' values concatenated along axis 0, in rank order."""
    from paddle_tpu_torch.parallel.mesh import all_gather_cat

    x = one(inputs, "X")
    group = _group(x, attrs)
    if group is None:
        return {"Out": x}
    return {"Out": all_gather_cat(x, group)}


@register_op("c_reducescatter", differentiable=False)
def c_reducescatter(inputs, attrs, device):
    """The sum over the ranks, split along axis 0 into one chunk a rank;
    each rank keeps its own (the JAX package's ``psum_scatter(tiled=
    True)``).  gloo has no reduce-scatter, so this is an all-reduce
    followed by taking this rank's chunk."""
    import torch.distributed as dist

    x = one(inputs, "X")
    group = _group(x, attrs)
    if group is None:
        return {"Out": x}
    total = x.clone()
    dist.all_reduce(total, group=group)
    n = dist.get_world_size(group)
    return {"Out": total.chunk(n, 0)[dist.get_rank(group)].clone()}


@register_op("c_sync_calc_stream", differentiable=False)
def c_sync_calc_stream(inputs, attrs, device):
    # torch.distributed orders its collectives after the work already on
    # the caller's stream (reference: collective/c_sync_calc_stream_op.cc):
    # identity
    return {"Out": one(inputs, "X")}


@register_op("c_sync_comm_stream", differentiable=False)
def c_sync_comm_stream(inputs, attrs, device):
    return {"Out": one(inputs, "X")}


@register_op("c_comm_init", differentiable=False)
def c_comm_init(inputs, attrs, device):
    """Check that the ring's group has the ``nranks`` the program was
    rewritten for.  A ring with no group bound takes the world group of an
    initialised ``torch.distributed`` of that size; with ``nranks > 1`` and
    no such group it raises: a rank never trains alone on a program
    rewritten for several."""
    nranks = int(attrs.get("nranks", 1))
    ring = int(attrs.get("ring_id", 0))
    if nranks <= 1 or device.type == "meta":  # shape inference runs no check
        return {}
    import torch.distributed as dist

    if penv.group_for_ring(ring) is None and dist.is_initialized():
        if dist.get_world_size() == nranks:
            penv.bind_ring(ring)
    size = penv.ring_size(ring)
    if size != nranks:
        raise RuntimeError(
            "c_comm_init: ring %d was rewritten for %d ranks and has %s; bind its "
            "process group first (paddle_tpu_torch.parallel.env.init_from_env or "
            "bind_ring)" % (ring, nranks, "no group" if penv.group_for_ring(ring) is None
                            else "%d" % size))
    return {}


@register_op("c_gen_nccl_id", differentiable=False)
def c_gen_nccl_id(inputs, attrs, device):
    # the process group's rendezvous exchanges what ncclUniqueId carries
    # (reference: collective/c_gen_nccl_id_op.cc); no-op
    return {}


@register_op("local_sgd_select", differentiable=False)
def local_sgd_select(inputs, attrs, device):
    """Every k steps take the cross-rank average, else keep the local
    param (transpiler/collective.py LocalSGD analog; the allreduce feeding
    Avg is a separate c_allreduce_sum op)."""
    p = one(inputs, "Param")
    avg = one(inputs, "Avg") / float(attrs.get("nranks", 1))
    step = one(inputs, "Step")
    k = float(attrs.get("k_steps", 1))
    take_avg = torch.remainder(step.reshape(()), k) == 0.0
    return {"Out": torch.where(take_avg, avg, p)}
