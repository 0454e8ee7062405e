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

A device mesh (``parallel/mesh.py``) binds each of its axes' process
groups here by name (``bind_axis``).  A ring resolves to an axis as in the
JAX package (``set_ring_axis``, ``axis_for_ring``; ring 0 is ``"data"``),
and a collective on a ring with no group of its own runs over that axis's
group while the axis is active (``active_axes``: the port's ``shard_map``
and a ``CompiledProgram``'s step), as the JAX package's ``psum`` runs only
inside a mapped axis.  ``batch_axis`` names the axis a compiled step
slices its batch over: ``batch_norm`` then reduces its statistics over it,
as the JAX package's compiled program normalises over the global batch.
"""
from __future__ import annotations

import atexit
import contextlib
import datetime
import os
from typing import Dict, List, Optional

__all__ = ["bind_ring", "group_for_ring", "ring_size", "init_from_env", "generation",
           "bind_axis", "group_for_axis", "axis_for_ring", "set_ring_axis", "axis_active",
           "active_axes", "batch_axis", "batch_axis_guard"]

_rings: Dict[int, object] = {}
_generation = 0  # bumped by every bind: run plans keyed on it re-read the rings
_axes: Dict[str, object] = {}  # mesh axis name -> its process group (None: one rank)
_ring_to_axis: Dict[int, str] = {0: "data"}
_active_axes: List[str] = []
_batch_axis: List[str] = []


def bind_axis(name: str, group) -> None:
    """Bind mesh axis ``name`` to this rank's process group along it
    (None for an axis of one rank)."""
    global _generation
    _axes[str(name)] = group
    _generation += 1


def group_for_axis(name: str):
    """The axis's process group, or None (unbound, or one rank)."""
    return _axes.get(str(name))


def axis_for_ring(ring_id: int) -> str:
    return _ring_to_axis.get(int(ring_id), "data")


def set_ring_axis(ring_id: int, axis: str) -> None:
    global _generation
    _ring_to_axis[int(ring_id)] = axis
    _generation += 1


def axis_active(name: str) -> bool:
    return name in _active_axes


@contextlib.contextmanager
def active_axes(names):
    """Make ``names`` the mapped axes while the body runs."""
    added = list(names)
    _active_axes.extend(added)
    try:
        yield
    finally:
        for n in added:
            _active_axes.remove(n)


def batch_axis() -> Optional[str]:
    """The axis the running compiled step slices its batch over, or None."""
    return _batch_axis[-1] if _batch_axis else None


@contextlib.contextmanager
def batch_axis_guard(name: Optional[str]):
    _batch_axis.append(name)
    try:
        yield
    finally:
        _batch_axis.pop()


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
    """The ring's process group: its own, else while the ring's axis is
    active that axis's group; None when neither is bound."""
    group = _rings.get(int(ring_id))
    if group is None:
        axis = axis_for_ring(ring_id)
        if axis in _active_axes:
            group = _axes.get(axis)
    return group


def ring_size(ring_id: int) -> int:
    """The ring's rank count: 1 when no group is bound."""
    group = group_for_ring(ring_id)
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def _destroy_group() -> None:
    """At exit: drop the groups this registry and the mesh cache hold, and
    destroy torch.distributed's, so each group's C++ threads are joined
    while the interpreter still runs."""
    import gc

    import torch.distributed as dist

    from paddle_tpu_torch.parallel import mesh

    _rings.clear()
    _axes.clear()
    mesh._mesh_cache.clear()
    mesh._current_mesh = None
    if dist.is_initialized():
        dist.destroy_process_group()
    gc.collect()


def init_from_env(backend: str = "gloo", ring_id: int = 0,
                  timeout_s: float = 300.0) -> Optional[object]:
    """Initialise ``torch.distributed`` from the launcher's environment
    (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
    ``PADDLE_TRAINER_ENDPOINTS``; trainer 0's endpoint hosts the
    rendezvous store) and bind the world group to ``ring_id``.  One
    trainer needs no group: nothing is initialised and None is returned.
    A group started here is destroyed when the process exits
    (``_destroy_group``): left to the interpreter's teardown, the C++
    threads of a gloo group still referenced can abort the process
    (``terminate called without an active exception``, exit code -6) after
    its work is done."""
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
        atexit.register(_destroy_group)
    bind_ring(ring_id)
    return dist.group.WORLD
