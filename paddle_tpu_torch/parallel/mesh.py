"""Device meshes and sharding helpers.

The port's counterpart of the JAX package's ``parallel/mesh.py``.  The
JAX package runs one process over a ``jax.sharding.Mesh`` of its local
devices and lets GSPMD partition the program.  torch has no such single
controller: the port is SPMD across processes, one rank a mesh device.
``make_mesh({"fsdp": 2, "tp": 2})`` lays the world's ranks out on the
named axes (rank-major, the first axis outermost, as ``np.reshape``
does), builds a ``torch.distributed.device_mesh.DeviceMesh`` over them,
and makes one process group for every set of axes: the ranks that share
this rank's coordinates on the other axes.  It binds each axis's group in
``parallel/env.py``, so a ring id or an ``axis_name`` resolves to a group
as it resolves to a mesh axis in the JAX package.

A mesh needs exactly the world's ranks: a larger one raises the JAX
package's ``ValueError`` ("mesh %r needs %d devices, have %d").  A world
of one rank (no ``torch.distributed`` group) is a mesh whose axes all
have size 1; nothing is spawned and no collective runs.

Axis conventions are the JAX package's: ``dp`` (data parallel, the batch
dim), ``tp`` (tensor parallel), ``fsdp`` (fully sharded parameters),
``pp``, ``sp`` and ``ep``.

``NamedSharding(mesh, spec)`` is the placement of one tensor: the box
(``((start, stop), ...)`` per dim) each rank holds of the global shape,
as jax's ``NamedSharding.devices_indices_map`` gives it.  ``gather`` and
``gather_many`` rebuild full tensors from the ranks' shards with one
``all_gather`` a group of axes and dtype; over gloo, which gathers only
host tensors, a CUDA buffer goes through the host and back.

The collectives a mapped function calls (``psum``, ``pmean``,
``ppermute``, ``all_gather``) run over the group of the active axes they
name, and are differentiable.  Each backward is the collective that the
JAX package's ``shard_map(check_rep=False)`` transposes it to (its
``pre_vma`` route, ``parallel/hybrid.py``): ``psum``'s is ``psum``,
``ppermute``'s the inverse permutation, a tiled ``all_gather``'s the sum
over the group of the cotangent, cut to this rank's block.  So a rank's
gradient is that of the sum of every rank's output, and a caller whose
ranks all seed the same replicated loss with 1 divides by the mesh's size
(``hybrid.make_train_step``'s ``reduce_grads``).  A backward's collectives
run on autograd's thread, in its order: every rank must build the same
graph, or the group deadlocks.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.parallel import env as penv

__all__ = ["Mesh", "NamedSharding", "make_mesh", "default_mesh", "data_parallel_mesh",
           "MeshGuard", "local_devices", "shard_map", "psum", "pmean", "ppermute",
           "all_gather", "world"]

_current_mesh = None
_mapped: List["Mesh"] = []  # the meshes of the running shard_map calls, innermost last
_mesh_cache: Dict[tuple, "Mesh"] = {}


def world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices(backend: Optional[str] = None) -> List[torch.device]:
    """The mesh's devices, one a rank: rank ``r`` runs on
    ``cuda:(r % device_count)`` (``backend`` "cuda" or "gpu", or None where
    there is a card), or on the CPU (``backend="cpu"``, or None where there
    is none).  Ranks of one card share it (over gloo).  Another backend
    name, or "cuda" where there is no card, raises ``ValueError``."""
    _, n = world()
    if backend not in (None, "cpu", "cuda", "gpu"):
        raise ValueError("backend %r: a mesh's ranks run on 'cpu' or 'cuda'" % (backend,))
    if backend == "cpu" or (backend is None and not torch.cuda.is_available()):
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise ValueError("backend %r: this process sees no CUDA device" % (backend,))
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(n)]


class Mesh:
    """Named axes over the world's ranks.  ``devices`` is the array of
    ranks in the mesh's shape (``devices.shape`` as jax's), ``shape`` the
    axis sizes, ``coords`` this rank's coordinate on each axis, ``device``
    the device this rank computes on."""

    def __init__(self, axes: Dict[str, int], rank: int, groups: Dict[tuple, object],
                 device_mesh=None, device: Optional[torch.device] = None):
        self.axis_names: Tuple[str, ...] = tuple(str(a) for a in axes)
        self.shape: Dict[str, int] = {str(a): int(n) for a, n in axes.items()}
        sizes = [self.shape[a] for a in self.axis_names]
        self.devices = np.arange(int(np.prod(sizes)) if sizes else 1).reshape(sizes)
        self.size = int(self.devices.size)
        self.rank = int(rank)
        self.coords: Dict[str, int] = self.rank_coords(self.rank)
        self._groups = groups  # axes tuple -> process group (None: one rank)
        self.device_mesh = device_mesh
        self.device = torch.device("cpu") if device is None else torch.device(device)

    def rank_coords(self, rank: int) -> Dict[str, int]:
        if not self.axis_names:
            return {}
        idx = np.unravel_index(int(rank), self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def _axes_key(self, axes) -> tuple:
        return tuple(a for a in self.axis_names if a in set(axes) and self.shape[a] > 1)

    def group(self, axes) -> Tuple[object, List[int]]:
        """(process group, member ranks in ascending order) of the ranks
        that differ from this one only on ``axes``; the group is None where
        they number one."""
        key = self._axes_key(axes)
        members = [r for r in range(self.size)
                   if all(self.rank_coords(r)[a] == self.coords[a]
                          for a in self.axis_names if a not in key)]
        return self._groups.get(key), members

    def __repr__(self):
        return "Mesh(%s, rank=%d)" % (self.shape, self.rank)


def _build_groups(axes: Dict[str, int], rank: int) -> Dict[tuple, object]:
    """One process group for every set of axes of more than one rank, made
    by every rank in the same order (``new_group`` is collective); this
    rank keeps the groups it belongs to."""
    import torch.distributed as dist

    names = [a for a in axes if int(axes[a]) > 1]
    sizes = [int(axes[a]) for a in axes]
    coords = lambda r: dict(zip(axes, np.unravel_index(r, sizes)))  # noqa: E731
    n = int(np.prod(sizes))
    groups: Dict[tuple, object] = {}
    for k in range(1, len(names) + 1):
        for key in itertools.combinations(names, k):
            cosets: Dict[tuple, List[int]] = {}
            for r in range(n):
                c = coords(r)
                cosets.setdefault(tuple(c[a] for a in axes if a not in key), []).append(r)
            for members in cosets.values():
                if len(members) == n:
                    g = dist.group.WORLD
                else:
                    g = dist.new_group(ranks=members)
                if rank in members:
                    groups[key] = g
    return groups


def make_mesh(axes: Dict[str, int], devices=None, backend: Optional[str] = None) -> Mesh:
    """A mesh with named axes over the world's ranks; the sizes must
    multiply to the number of ranks (a larger mesh raises the JAX
    package's ``ValueError``).  ``devices``, where given, is the list of
    ranks (or devices, one a rank) the mesh may use; else they are
    ``local_devices(backend)``, so a backend the port has no device for
    raises.  ``mesh.device`` is this rank's entry of ``devices`` where it
    is a device, else of ``local_devices(backend)``; a program compiled
    over the mesh runs on its Executor's place."""
    import torch.distributed as dist

    axes = {str(a): int(n) for a, n in dict(axes).items()}
    sizes = list(axes.values())
    n = int(np.prod(sizes)) if sizes else 1
    rank, size = world()
    if devices is None:
        devices = local_devices(backend)
    have = min(size, len(devices))
    if n > have:
        raise ValueError("mesh %r needs %d devices, have %d" % (axes, n, have))
    if n < size:
        raise ValueError(
            "mesh %r spans %d ranks but the world has %d: each rank is one mesh device, "
            "so start as many ranks as the mesh has devices" % (axes, n, size))
    mine = devices[rank]
    device = (torch.device(mine) if isinstance(mine, (str, torch.device))
              else local_devices(backend)[rank])
    key = (tuple(axes.items()), rank, size,
           id(dist.group.WORLD) if size > 1 else None, str(device))
    mesh = _mesh_cache.get(key)
    if mesh is None:
        groups, device_mesh = {}, None
        if size > 1:
            from torch.distributed.device_mesh import DeviceMesh

            # "cpu": the groups are the default backend's (gloo on a shared
            # card); a "cuda" DeviceMesh would set a device a rank
            device_mesh = DeviceMesh("cpu", torch.arange(n).reshape(sizes),
                                     mesh_dim_names=tuple(axes))
            groups = _build_groups(axes, rank)
        mesh = _mesh_cache[key] = Mesh(axes, rank, groups, device_mesh, device)
    for a in mesh.axis_names:
        penv.bind_axis(a, mesh.group((a,))[0])
    return mesh


def data_parallel_mesh(num_devices: Optional[int] = None, backend: Optional[str] = None) -> Mesh:
    _, size = world()
    return make_mesh({"dp": size if num_devices is None else int(num_devices)},
                     backend=backend)


def default_mesh() -> Mesh:
    """The mesh bound by MeshGuard, or a fresh all-ranks dp mesh."""
    if _current_mesh is not None:
        return _current_mesh
    return data_parallel_mesh()


class MeshGuard:
    """Bind a mesh as the process-wide default (the reference's
    ``ParallelExecutor`` holding its NCCLContextMap for the run)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _current_mesh
        self._prev = _current_mesh
        _current_mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _current_mesh
        _current_mesh = self._prev
        return False


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------
def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A PartitionSpec on a mesh: which box of a global shape each rank
    holds.  A dim sharded over several axes splits with the first axis
    outermost (jax's order)."""

    def __init__(self, mesh: Mesh, spec):
        from paddle_tpu_torch.sharding.rules import PartitionSpec

        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*(spec or ()))
        self.axes: Tuple[str, ...] = tuple(
            a for a in mesh.axis_names
            if mesh.axis_size(a) > 1 and any(a in _entry_axes(e) for e in self.spec))

    @property
    def is_fully_replicated(self) -> bool:
        return not self.axes

    def box_of(self, rank: int, shape: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
        coords = self.mesh.rank_coords(rank)
        box = []
        for d, dim in enumerate(shape):
            axes = _entry_axes(self.spec[d]) if d < len(self.spec) else ()
            k, idx = 1, 0
            for a in axes:
                n = self.mesh.axis_size(a)
                idx = idx * n + coords.get(a, 0)
                k *= n
            chunk = int(dim) // k
            box.append((idx * chunk, (idx + 1) * chunk))
        return tuple(box)

    def local_box(self, shape) -> Tuple[Tuple[int, int], ...]:
        return self.box_of(self.mesh.rank, shape)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return tuple(hi - lo for lo, hi in self.local_box(shape))

    def devices_indices_map(self, shape) -> Dict[int, Tuple[Tuple[int, int], ...]]:
        """{rank: box} over every rank of the mesh."""
        return {r: self.box_of(r, shape) for r in range(self.mesh.size)}

    def shard(self, full, shape=None):
        """This rank's shard of a full tensor (a view; ``.clone()`` to own it)."""
        box = self.local_box(tuple(full.shape) if shape is None else shape)
        return full[tuple(slice(lo, hi) for lo, hi in box)]

    def __repr__(self):
        return "NamedSharding(%s, %s)" % (self.mesh.shape, self.spec)


def _to_wire(x, group):
    """x contiguous, as gloo takes it for a gather or a point-to-point
    message: on the host."""
    import torch.distributed as dist

    x = x.contiguous()
    return x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" else x


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` (one shape and dtype on every member) concatenated
    along dim 0 in rank order, on ``x``'s device.  gloo gathers host
    tensors only, so over gloo a CUDA tensor goes to the host and back."""
    import torch.distributed as dist

    src = _to_wire(x, group)
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, 0).to(x.device)


def gather_many(items) -> List[torch.Tensor]:
    """Full tensors from ``items`` of (sharding, local shard, global shape):
    one ``all_gather`` a (group of axes, dtype), each rank's shards flat in
    one buffer."""
    out: List[Optional[torch.Tensor]] = [None] * len(items)
    buckets: Dict[tuple, List[int]] = {}
    for i, (sh, local, shape) in enumerate(items):
        if sh.is_fully_replicated:
            out[i] = local
        else:
            buckets.setdefault((sh.axes, local.dtype, id(sh.mesh)), []).append(i)
    for (axes, _dtype, _), idxs in buckets.items():
        mesh = items[idxs[0]][0].mesh
        group, members = mesh.group(axes)
        locals_ = [items[i][1].contiguous() for i in idxs]
        sizes = [t.numel() for t in locals_]
        parts = all_gather_cat(torch.cat([t.reshape(-1) for t in locals_]),
                               group).chunk(len(members))
        for i, t in zip(idxs, locals_):
            sh, _, shape = items[i]
            out[i] = torch.empty(tuple(shape), dtype=t.dtype, device=t.device)
        for member, part in zip(members, parts):
            for i, piece in zip(idxs, part.split(sizes)):
                sh, local, shape = items[i]
                box = sh.box_of(member, shape)
                out[i][tuple(slice(lo, hi) for lo, hi in box)] = piece.view(local.shape)
    return out


def gather(sharding: NamedSharding, local: torch.Tensor, shape) -> torch.Tensor:
    return gather_many([(sharding, local, shape)])[0]


# ---------------------------------------------------------------------------
# shard_map and the axis reductions
# ---------------------------------------------------------------------------
def _map_leaves(x, fn):
    if isinstance(x, dict):
        return {k: _map_leaves(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(v, fn) for v in x)
    return fn(x)


def _with_specs(x, specs, fn):
    """Apply ``fn(leaf, spec)`` over ``x``, ``specs`` a PartitionSpec for a
    whole subtree (jax's prefix rule) or a matching dict / sequence."""
    from paddle_tpu_torch.sharding.rules import PartitionSpec

    if specs is None or isinstance(specs, PartitionSpec):
        return _map_leaves(x, lambda leaf: fn(leaf, specs))
    if isinstance(specs, dict):
        return {k: _with_specs(x[k], specs[k], fn) for k in x}
    return type(x)(_with_specs(v, s, fn) for v, s in zip(x, specs))


def shard_map(f, mesh: Mesh, in_specs, out_specs, check_vma: bool = True):
    """The JAX package's ``shard_map`` on the port's SPMD ranks: ``f`` is
    called on this rank's block of each argument (its slice of every dim
    a spec shards) with the mesh's axes active, so collectives on a ring
    bound to an axis (``env.set_ring_axis``) run over that axis's group;
    an output whose spec shards a dim is gathered along it.  ``check_vma``
    is accepted for the JAX signature; there is nothing to check."""

    def local(leaf, spec):
        if spec is None or leaf is None:
            return leaf
        sh = NamedSharding(mesh, spec)
        return sh.shard(leaf) if not sh.is_fully_replicated else leaf

    def full(leaf, spec):
        if spec is None:
            return leaf
        sh = NamedSharding(mesh, spec)
        if sh.is_fully_replicated:
            return leaf
        t = torch.as_tensor(leaf)
        shape = [d * _block(sh, i) for i, d in enumerate(t.shape)]
        return gather(sh, t, shape)

    def mapped(*args):
        args = tuple(_with_specs(a, s, local) for a, s in zip(args, in_specs))
        _mapped.append(mesh)
        try:
            with penv.active_axes(mesh.axis_names):
                out = f(*args)
        finally:
            _mapped.pop()
        return _with_specs(out, out_specs, full)

    return mapped


def _block(sh: NamedSharding, dim: int) -> int:
    if dim >= len(sh.spec):
        return 1
    k = 1
    for a in _entry_axes(sh.spec[dim]):
        k *= sh.mesh.axis_size(a)
    return k


def _axes_group(axis_name):
    """The process group over the active axes among ``axis_name`` (a name
    or a tuple of names): the innermost running shard_map's mesh's, else
    for one axis the group ``parallel/env.py`` binds to it; None where they
    span one rank or none is active."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    active = tuple(a for a in names if penv.axis_active(a))
    if not active:
        return None
    if _mapped:
        return _mapped[-1].group(active)[0]
    if len(active) == 1:
        return penv.group_for_axis(active[0])
    raise ValueError("a collective over the axes %r runs inside shard_map" % (active,))




def _all_reduce(x, group):
    import torch.distributed as dist

    out = x.reshape(-1).clone()  # a 0-d value reduces as one element
    dist.all_reduce(out, group=group)
    return out.view(x.shape)


class _PSum(torch.autograd.Function):
    """psum over a group; its backward is psum of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _permute(x, group, perm):
    """This rank's value after ``perm`` ((source, destination) group ranks):
    what its source sent, zeros where none did."""
    import torch.distributed as dist

    r = dist.get_rank(group)
    wire = _to_wire(x, group)
    out = torch.zeros_like(wire)
    reqs = [dist.isend(wire, dist.get_global_rank(group, d), group=group)
            for s, d in perm if s == r]
    reqs += [dist.irecv(out, dist.get_global_rank(group, s), group=group)
             for s, d in perm if d == r]
    for req in reqs:
        req.wait()
    return out.to(x.device)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


class _AllGather(torch.autograd.Function):
    """Tiled all_gather along ``dim``; its backward sums the cotangent over
    the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim, ctx.block = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        full = all_gather_cat(x.movedim(dim, 0), group)
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        total = _all_reduce(g, ctx.group)
        return total.narrow(ctx.dim, ctx.rank * ctx.block, ctx.block), None, None


def psum(x, axis_name):
    """The sum of ``x`` over the active mesh axes ``axis_name`` (a name or a
    tuple of names; ``x`` itself outside them).  Differentiable."""
    group = _axes_group(axis_name)
    t = torch.as_tensor(x)
    if group is None:
        return t
    return _PSum.apply(t, group)


def pmean(x, axis_name):
    import torch.distributed as dist

    group = _axes_group(axis_name)
    out = psum(x, axis_name)
    return out / dist.get_world_size(group) if group is not None else out


def ppermute(x, axis_name, perm):
    """jax.lax.ppermute over one active axis: ``perm`` lists (source,
    destination) axis indices; a rank no source names receives zeros.
    Differentiable (the backward sends back along the inverse pairs)."""
    group = _axes_group(axis_name)
    if group is None:
        return x
    return _PPermute.apply(x, group, [(int(s), int(d)) for s, d in perm])


def all_gather(x, axis_name, axis: int = 0, tiled: bool = False):
    """jax.lax.all_gather over the active axes ``axis_name``: the group's
    ``x`` in rank order, stacked on a new dim ``axis`` or, ``tiled``,
    concatenated along ``axis``.  Differentiable."""
    group = _axes_group(axis_name)
    axis = axis % (x.dim() + (0 if tiled else 1))
    if not tiled:
        x = x.unsqueeze(axis)
    if group is None:
        return x
    return _AllGather.apply(x, group, axis)
