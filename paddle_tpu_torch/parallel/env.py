"""The ring registry: ``ring_id`` -> ``torch.distributed`` process group.

The reference keys its NCCL communicators by ring id
(platform/collective_helper.h:63); the JAX package maps a ring to a mesh
axis bound while tracing under ``shard_map``.  Here a ring is a process
group that the caller binds (``bind_ring``) or that ``init_from_env``
builds from the launcher's ``PADDLE_*`` variables
(``distributed/launch.py``).  A ring with no group bound has one rank, and
the collective ops on it are the identity, as the JAX package's are
outside a mapped axis.

The backend is the caller's choice.  NCCL refuses two ranks on one card,
so ranks that share a device use gloo, which reduces CUDA tensors through
host copies.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, Optional

__all__ = ["bind_ring", "group_for_ring", "ring_size", "init_from_env", "generation"]

_rings: Dict[int, object] = {}
_generation = 0  # bumped by every bind: run plans keyed on it re-read the rings


def generation() -> int:
    """A counter of the registry's changes (the executor keys its run
    plans on it, since whether a collective runs decides a plan's
    ``eager_ops``)."""
    return _generation


def bind_ring(ring_id: int, group=None) -> None:
    """Bind ``ring_id`` to a process group (default: the world group of an
    initialised ``torch.distributed``)."""
    global _generation
    import torch.distributed as dist

    if group is None:
        if not dist.is_initialized():
            raise RuntimeError(
                "bind_ring(%d): torch.distributed is not initialised; call "
                "init_from_env() or torch.distributed.init_process_group first" % ring_id)
        group = dist.group.WORLD
    _rings[int(ring_id)] = group
    _generation += 1


def group_for_ring(ring_id: int):
    """The ring's process group, or None when none is bound."""
    return _rings.get(int(ring_id))


def ring_size(ring_id: int) -> int:
    """The ring's rank count: 1 when no group is bound."""
    group = group_for_ring(ring_id)
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def init_from_env(backend: str = "gloo", ring_id: int = 0,
                  timeout_s: float = 300.0) -> Optional[object]:
    """Initialise ``torch.distributed`` from the launcher's environment
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_TRAINER_ENDPOINTS``; trainer 0's endpoint hosts the
    rendezvous store) and bind the world group to ``ring_id``.  One
    trainer needs no group: nothing is initialised and None is returned."""
    import torch.distributed as dist

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    world = int(os.environ["PADDLE_TRAINERS_NUM"])
    if world <= 1:
        return None
    if not dist.is_initialized():
        endpoints = [e for e in os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",") if e]
        dist.init_process_group(backend, init_method="tcp://" + endpoints[0], rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
    bind_ring(ring_id)
    return dist.group.WORLD
