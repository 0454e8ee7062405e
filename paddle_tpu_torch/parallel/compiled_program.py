"""CompiledProgram: a Program's step over a mesh of ranks.

The port's counterpart of the JAX package's ``parallel/compiled_program.py``
(reference: python/paddle/fluid/compiler.py:57, ``CompiledProgram
.with_data_parallel(...)``, which builds a C++ ParallelExecutor).  The JAX
package jits one module over a ``jax.sharding.Mesh`` and lets GSPMD
partition it.  The port is SPMD across processes (``parallel/mesh.py``):
every rank calls ``Executor.run(compiled, feed=<the global batch>)``, and
the step gives each rank's program the global program's math, following
FSDP2's design on the placements the partition rules resolve:

* **State.** Each persistable the rules (or
  ``DistributedStrategy.sharding_specs``) shard is held in the rank's
  scope as its shard: the box of the global tensor its mesh coordinates
  pick (``parallel.mesh.NamedSharding``).  A full value found in the scope
  (the startup program's, a load) is placed on the step's first run: the
  parameters are broadcast from rank 0 (as DDP does, so ranks that drew
  different initial weights agree), then cut.  Nothing is padded: a dim
  that does not divide its axes is a typed ``ShardingRuleError``.
* **Feeds.** A ``dp`` axis gives each rank its slice of the batch's rows
  (``_batch_axis``); on a mesh with no ``dp`` axis every rank runs the
  whole batch, as GSPMD leaves it.  A batch that does not divide ``dp``
  is a typed ``ValueError``.
* **The step.** The sharded parameters the forward reads are gathered
  (one ``all_gather`` a group of axes and dtype); the forward and backward
  ops run on whole tensors through the port's op kernels, the
  hand-written attention kernels included; the gradients the later ops
  read are averaged over ``dp`` (one ``all_reduce``); the ops between the
  backward and the first update (gradient clipping) run on whole
  gradients; each gradient an update op reads is cut to its parameter's
  shard, and the update ops and what follows run on the shards, each
  accumulator placed as its parameter (``sharding/train.py``).
  ``batch_norm`` reduces its statistics over ``dp`` and ``dropout`` draws
  the rank's slice of the global mask, so the step is the global batch's.
* **Fetches.** Every rank gets the global result: a value with a leading
  batch dim is gathered along ``dp``, another floating value (a mean
  loss) is averaged over it, and a sharded persistable is gathered whole.
* **Activations.** Rules with activation rules (the ``sp`` layout:
  sequence-parallel serving) install an ``ActivationConstrainer``
  (``sharding/activations.py``) around the step: each rank keeps its
  window of the sequence axis of every intermediate the rules shard, the
  ops run on windows (a replicated operand meeting a window along that
  axis is cut to it; an op that mixes positions gets its windows gathered),
  ``fused_attention`` runs as ring attention over the axis
  (``parallel/ring_attention.py``), and a fetched window is gathered whole.
  A feed whose spec shards a dim other than the batch is cut to the rank's
  window of it.

A mesh of one rank has nothing to gather, reduce or cut: the executor
runs the plain step on the compiled program's program (its CUDA graph
capture, guards, spans and ledger, and the parameter-server round of a
transpiled trainer program), after ``_prepare_one_rank`` has resolved the
rules and moved host-staged or recast state.  ``_execute`` is the step of
a mesh of more than one rank.

The sharded step runs eagerly: gloo's collectives block the host and
cannot be captured into a CUDA graph, so its plan's ``eager_ops`` names
the collectives it calls.  Megatron-style split compute (column- and
row-parallel matmuls that never gather a weight) is a perf lever
(ROADMAP); the result here is the gathered math's.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel import mesh as mesh_lib
from paddle_tpu_torch.parallel.strategy import BuildStrategy, DistributedStrategy, ExecutionStrategy

__all__ = ["CompiledProgram", "ParallelExecutor"]

# ops that may run on a shard: the update ops (a Param and a Grad input)
# and elementwise ops.  Updates that take a tensor-wide norm of their
# parameter (Lamb's and Lars's trust ratios) need the whole tensor.
_SHARD_SAFE = frozenset((
    "scale", "sum", "assign", "cast", "clip", "sign", "sqrt", "square", "abs", "increment",
    "fill_constant", "fill_zeros_like", "where", "local_sgd_select", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div", "elementwise_max",
    "elementwise_min", "elementwise_pow"))
_WHOLE_TENSOR_UPDATES = frozenset(("lamb", "lars_momentum"))


def _is_update(op) -> bool:
    return (op.attrs.get("op_role") == "optimize" and bool(op.inputs.get("Param"))
            and bool(op.inputs.get("Grad")))


class _ShardedPlan:
    """One (program version, feeds, fetches) of a compiled program: the op
    ranges of the step's three phases, what each phase boundary moves, and
    the names the step places, gathers and reduces."""

    __slots__ = ("feed_names", "fetch_names", "ops", "dead", "a1", "a2", "reduce", "cut",
                 "gather", "names", "state_in", "state_out", "feed_dtypes", "batch_fetches",
                 "eager_ops")


class CompiledProgram:
    _is_compiled_program = True

    def __init__(self, program):
        # accept either a Program or another CompiledProgram's program
        self._program = getattr(program, "_program", program)
        self._mesh = None
        self._strategy: Optional[DistributedStrategy] = None
        self._rules = None  # PartitionRules (with_sharding_rules)
        self._mesh_axes: Optional[Dict[str, int]] = None  # manifest form
        self._batch_axis = "dp"
        self._build_strategy: Optional[BuildStrategy] = None
        self._exec_strategy: Optional[ExecutionStrategy] = None
        self._loss_name: Optional[str] = None
        # resolved-placement memos: rule resolution runs once per name
        self._sharding_memo: Dict[Any, Any] = {}
        self._state_sh_memo: Dict[str, Any] = {}
        self._feed_sh_memo: Dict[tuple, Any] = {}
        # param name -> dtype applied once at placement (the composed
        # bf16 + sharded endpoint's hoisted casts; with_cast_dtypes)
        self._cast_dtypes: Dict[str, torch.dtype] = {}
        self._plans: Dict[tuple, _ShardedPlan] = {}
        self._act_constrainer = None  # activation_constrainer(), per rules+mesh bind
        # scope -> {name: the tensor this program placed there}: a name whose
        # scope tensor is still that object is placed (the steady state)
        self._placed: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        # host seconds of the last step's collective phases: placing fresh
        # state, gathering the parameters, averaging the gradients over dp
        self.last_step_seconds: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None) -> "CompiledProgram":
        """Data-parallel over all ranks (reference: compiler.py:126)."""
        self._loss_name = loss_name
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        n = len(places) if places else None
        self._mesh = mesh_lib.data_parallel_mesh(n)
        self._clear_sharding_memos()
        return self

    def with_strategy(self, strategy: DistributedStrategy, mesh=None) -> "CompiledProgram":
        """Bind an explicit mesh/sharding plan (``mesh_axes``,
        ``sharding_specs``)."""
        self._strategy = strategy
        if mesh is not None:
            self._mesh = mesh
        elif strategy.mesh_axes:
            self._mesh = mesh_lib.make_mesh(strategy.mesh_axes)
        else:
            self._mesh = mesh_lib.default_mesh()
        self._clear_sharding_memos()
        return self

    def with_mesh(self, mesh) -> "CompiledProgram":
        self._mesh = mesh
        self._clear_sharding_memos()
        return self

    def with_sharding_rules(self, rules, mesh=None, mesh_axes=None,
                            default=None) -> "CompiledProgram":
        """Bind a declarative partition-rule set.

        ``rules``: a :class:`paddle_tpu_torch.sharding.PartitionRules` or a
        sequence of ``(regex, PartitionSpec)`` pairs (first match wins;
        ``default=`` is the fallback spec for unmatched names — without it
        an unmatched persistable is a typed ``ShardingRuleError`` at
        resolve time).

        The mesh: ``mesh`` (a ``parallel.mesh.Mesh``) or ``mesh_axes``
        (axis→size, e.g. ``{"tp": 2}``); with neither, a single-axis rule
        set spans every rank on its one axis.  Explicit
        ``DistributedStrategy.sharding_specs`` entries still win over the
        rules for their names."""
        from paddle_tpu_torch.sharding.rules import PartitionRules, ShardingRuleError

        if not isinstance(rules, PartitionRules):
            rules = PartitionRules(rules, default=default)
        elif default is not None:
            # a TrainPartitionRules keeps its accumulator map through the rebind
            rules = rules.with_default(default)
        if mesh is not None:
            self._mesh = mesh
            self._mesh_axes = dict(mesh.shape)
        elif mesh_axes:
            self._mesh_axes = {str(a): int(n) for a, n in dict(mesh_axes).items()}
            self._mesh = mesh_lib.make_mesh(self._mesh_axes)
        else:
            axes = sorted(rules.axes())
            if len(axes) != 1:
                raise ShardingRuleError(
                    "rule set %r spans axes %s — pass mesh= or "
                    "mesh_axes= to fix their sizes" % (rules.name, axes))
            self._mesh_axes = {axes[0]: mesh_lib.world()[1]}
            self._mesh = mesh_lib.make_mesh(self._mesh_axes)
        rules.validate_mesh(self._mesh)
        # clear BEFORE rebinding: the retire check inside must see the OLD
        # rules (a train layout being replaced tears down its series)
        self._clear_sharding_memos()
        self._rules = rules
        return self

    def with_cast_dtypes(self, dtypes: Dict[str, Any]) -> "CompiledProgram":
        """Bind placement-time dtype casts (precision × sharding):
        ``dtypes`` maps a param name to a dtype (``"bfloat16"``, a torch or
        numpy dtype); a listed value of another dtype is cast once, as it
        is placed, so the rank keeps only its shard in the target dtype."""
        from paddle_tpu_torch.core import types as core_types

        self._cast_dtypes = {str(n): core_types.torch_dtype(
            core_types.canonical_dtype(d)) for n, d in dict(dtypes or {}).items()}
        self._placed = weakref.WeakKeyDictionary()  # the casts apply at the next placement
        return self

    @property
    def sharding_rules(self):
        return self._rules

    def activation_constrainer(self):
        """The activation constrainer of this plan
        (``sharding/activations.py``), or None when the bound rules carry
        no activation rules.  Built once per rules+mesh bind; its own
        (name, shape) memo keeps a run from re-scanning the regex list."""
        if self._act_constrainer is not None:
            return self._act_constrainer
        rules = self._rules
        if rules is None or not (getattr(rules, "activations", ())
                                 or getattr(rules, "activation_default", None) is not None):
            return None
        from paddle_tpu_torch.sharding.activations import ActivationConstrainer

        self._act_constrainer = ActivationConstrainer(
            rules, self.mesh, self._mesh_axes or dict(self.mesh.shape),
            block=self._program.global_block())
        return self._act_constrainer

    def activation_stats(self):
        """Aggregate activation-bytes report of the last run's constrained
        intermediates (``ActivationConstrainer.stats``), or None when
        activations are not ruled."""
        c = self.activation_constrainer()
        return c.stats() if c is not None else None

    def _clear_sharding_memos(self) -> None:
        if getattr(self._rules, "state_kind", None) is not None:
            # a mesh/rules rebind tears the old training layout down
            from paddle_tpu_torch.sharding import train as _sh_train

            _sh_train.retire_state_bytes()
        self._sharding_memo.clear()
        self._state_sh_memo.clear()
        self._feed_sh_memo.clear()
        self._act_constrainer = None
        self._plans.clear()
        self._placed = weakref.WeakKeyDictionary()

    # ------------------------------------------------------------------
    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = mesh_lib.default_mesh()
        return self._mesh

    def _var_shape(self, name: str) -> Optional[Tuple[int, ...]]:
        var = self._program.global_block()._find_var_recursive(name)
        if var is None or var.shape is None or any(int(d) < 0 for d in var.shape):
            return None
        return tuple(int(d) for d in var.shape)

    def _spec_for_state(self, name: str):
        from paddle_tpu_torch.sharding.rules import PartitionSpec

        specs = self._strategy.sharding_specs if self._strategy else {}
        if name in specs:
            return PartitionSpec(*specs[name])
        if self._rules is not None:
            shape = self._var_shape(name)
            spec = self._rules.spec_for(name, shape=shape)
            if shape and self._mesh_axes:
                # typed here, not as a shape error in the cut
                self._rules.check_divisible(name, spec, shape, self._mesh_axes)
            return spec
        return PartitionSpec()  # replicated

    def _spec_for_feed(self, name: str, ndim: int):
        from paddle_tpu_torch.sharding.rules import PartitionSpec

        specs = self._strategy.sharding_specs if self._strategy else {}
        if name in specs:
            return PartitionSpec(*specs[name])
        if ndim >= 1 and self._batch_axis in self.mesh.axis_names:
            return PartitionSpec(self._batch_axis)  # the batch dim; the rest whole
        return PartitionSpec()

    def _sharding(self, spec):
        sh = self._sharding_memo.get(spec)
        if sh is None:
            sh = self._sharding_memo[spec] = mesh_lib.NamedSharding(self.mesh, spec)
        return sh

    def state_sharding(self, name: str):
        sh = self._state_sh_memo.get(name)
        if sh is None:
            sh = self._state_sh_memo[name] = self._sharding(self._spec_for_state(name))
        return sh

    def feed_sharding(self, name: Optional[str], ndim: int, steps_axis: bool = False):
        from paddle_tpu_torch.sharding.rules import PartitionSpec

        key = (name, int(ndim), bool(steps_axis))
        sh = self._feed_sh_memo.get(key)
        if sh is None:
            if steps_axis:
                spec = PartitionSpec(None, *self._spec_for_feed(name, ndim - 1))
            else:
                spec = self._spec_for_feed(name, ndim)
            sh = self._feed_sh_memo[key] = self._sharding(spec)
        return sh

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def _plan(self, exe, feed_names, fetch_names) -> Tuple[_ShardedPlan, bool]:
        from paddle_tpu_torch.core import lowering

        program = self._program
        key = (program._uid, program.version, sum(len(b.ops) for b in program.blocks),
               tuple(feed_names), tuple(fetch_names), str(exe.device), penv.generation())
        plan = self._plans.get(key)
        if plan is not None:
            return plan, True
        base = exe._analyze(program, tuple(feed_names), tuple(fetch_names))
        block = program.global_block()
        ops = list(block.ops)
        first_update = next((i for i, op in enumerate(ops) if _is_update(op)), len(ops))
        last_bwd = max((i for i, op in enumerate(ops[:first_update])
                        if op.attrs.get("op_role") == "backward"), default=-1)
        a1, a2 = last_bwd + 1, first_update
        names = tuple(sorted(set(base.state_in) | set(base.state_out)))
        sharded = {n for n in names if not self.state_sharding(n).is_fully_replicated}
        # the gradients the ops after the backward read, averaged over dp
        written1 = {n for op in ops[:a1] for n in op.output_arg_names}
        later = {n for op in ops[a1:] for n in lowering.op_reads(op)}
        reduce = tuple(sorted(n for n in written1 & later if "@GRAD" in n))
        # each update's gradient, cut to its parameter's shard
        cut = {}
        for op in ops[a2:]:
            if _is_update(op):
                p, g = op.inputs["Param"][0], op.inputs["Grad"][0]
                if p in sharded:
                    if op.type in _WHOLE_TENSOR_UPDATES:
                        raise NotImplementedError(
                            "%s takes a norm of the whole parameter %r, which this layout "
                            "shards; run it with %r replicated" % (op.type, p, p))
                    cut[g] = p
        # the sharded state the forward, backward and clipping read: gathered
        gather, written = [], set()
        for op in ops[:a2]:
            for n in lowering.op_reads(op):
                if n in sharded and n not in written and n not in gather:
                    gather.append(n)
            written.update(op.output_arg_names)
        # what the update phase does with shards must not need the whole tensor
        on_shards = set(sharded) | set(cut)
        for op in ops[a2:]:
            if any(n in on_shards for n in lowering.op_reads(op)):
                if not (_is_update(op) or op.type in _SHARD_SAFE):
                    raise NotImplementedError(
                        "op %s after the first update reads a sharded value; only update "
                        "and elementwise ops run on shards" % op.type)
                on_shards.update(op.output_arg_names)
        keep = set(fetch_names) | set(base.state_out)
        plan = _ShardedPlan()
        plan.feed_names = tuple(feed_names)
        plan.fetch_names = tuple(fetch_names)
        plan.ops, plan.dead = ops, lowering._dead_after(ops, keep)
        plan.a1, plan.a2 = a1, a2
        plan.reduce, plan.cut, plan.gather = reduce, cut, tuple(gather)
        plan.names, plan.state_in, plan.state_out = names, base.state_in, base.state_out
        plan.feed_dtypes = base.feed_dtypes
        plan.batch_fetches = frozenset(
            n for n in fetch_names
            if (block._find_var_recursive(n) is not None
                and block._find_var_recursive(n).shape
                and int(block._find_var_recursive(n).shape[0]) < 0))
        dp = self.mesh.axis_size(self._batch_axis)
        eager = set(base.eager_ops) | {"c_broadcast"}  # the first placement's
        if gather:
            eager.add("c_allgather")
        if dp > 1:
            eager.update(("c_allreduce_sum", "c_allgather"))
        plan.eager_ops = tuple(sorted(eager))
        self._plans[key] = plan
        return plan, False

    def _local_feed(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a feed: its rows over ``dp``, and its window
        of any other dim its spec shards (a sequence axis over ``sp``)."""
        sh = self.feed_sharding(name, t.dim())
        if sh.is_fully_replicated:
            return t
        for d in range(min(len(sh.spec), t.dim())):
            k = mesh_lib._block(sh, d)
            if k > 1 and t.shape[d] % k:
                if d == 0 and self._batch_axis in sh.axes:
                    raise ValueError(
                        "feed %r has a batch of %d rows, which does not divide the %r axis of "
                        "%d ranks (nothing is padded)" % (name, t.shape[0], self._batch_axis, k))
                raise ValueError(
                    "feed %r has %d entries on dim %d, which does not divide the %d ranks of "
                    "its spec %s (nothing is padded)" % (name, t.shape[d], d, k, sh.spec))
        return sh.shard(t)

    def _place(self, scope, plan, device) -> Tuple[Dict[str, torch.Tensor], int]:
        """This rank's value of each state name, placing full values found in
        the scope (broadcast parameters from rank 0, cast, cut)."""
        import torch.distributed as dist

        placed = self._placed.get(scope)
        if placed is None:
            placed = self._placed[scope] = {}
        state, fresh, missing = {}, [], []
        for n in plan.names:
            v = scope.vars.get(n)
            if v is None:
                if n in plan.state_in:
                    missing.append(n)
                continue
            if placed.get(n) is v:
                state[n] = v
            else:
                fresh.append(n)
        if missing:
            raise RuntimeError(
                "Variables %s are not initialized in scope — run the startup "
                "program first (reference: executor.py run startup)" % missing)
        if not fresh:
            return state, 0
        params = {p.name for p in self._program.all_parameters()}
        full, to_bcast = {}, []
        for n in fresh:
            v = scope.vars[n]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            sh = self.state_sharding(n)
            shape = self._var_shape(n) or tuple(v.shape)
            if tuple(v.shape) == tuple(shape):
                full[n] = v  # cut where it lies (a host-staged load), then moved
                if n in params:
                    to_bcast.append(n)
            elif tuple(v.shape) == sh.shard_shape(shape):
                state[n] = self._to_device(n, v, device)  # a shard already (a restore)
            else:
                raise ValueError(
                    "state %r holds shape %s; its global shape is %s and this rank's shard "
                    "%s" % (n, tuple(v.shape), shape, sh.shard_shape(shape)))
        if to_bcast:
            groups: Dict[tuple, List[str]] = {}
            for n in to_bcast:
                groups.setdefault((full[n].dtype, full[n].device), []).append(n)
            for names in groups.values():
                flat = torch.cat([full[n].reshape(-1) for n in names])
                dist.broadcast(flat, src=0)
                for n, piece in zip(names, flat.split([full[n].numel() for n in names])):
                    full[n] = piece.view(full[n].shape)
        n_sharded = 0
        committed = scope.__dict__.setdefault("_mesh_committed", {})
        for n, v in full.items():
            sh = self.state_sharding(n)
            if not sh.is_fully_replicated:
                v = sh.shard(v).clone()
                n_sharded += 1
            state[n] = self._to_device(n, v, device)
        del full
        for n, v in state.items():
            scope.vars[n] = v
            placed[n] = v
            if not self.state_sharding(n).is_fully_replicated:
                committed[n] = (self, v)
        if n_sharded and self._rules is not None:
            from paddle_tpu_torch.sharding import metrics as _sh_metrics

            _sh_metrics.PARAMS_SHARDED.inc(n_sharded)
        kind_of = getattr(self._rules, "state_kind", None)
        if kind_of is not None:
            from paddle_tpu_torch.sharding import train as _sh_train

            _sh_train.publish_state_bytes(kind_of, state)
        return state, n_sharded

    def _prepare_one_rank(self, exe, scope, names) -> None:
        """A one-rank mesh runs the plain executor's step on this program
        (nothing to gather, reduce or cut).  Before it, the state names
        resolve against the rules (their typed errors), and a value the
        scope holds on the host (a sharded model's load) or in another
        dtype than its placement cast (``with_cast_dtypes``) is moved and
        cast, once."""
        moved = False
        for n in names:
            self.state_sharding(n)
            v = scope.vars.get(n)
            if v is None:
                continue
            cast = self._cast_dtypes.get(n)
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            elif v.device == exe.device and (cast is None or v.dtype == cast):
                continue
            scope.vars[n] = self._to_device(n, v, exe.device)
            moved = True
        kind_of = getattr(self._rules, "state_kind", None)
        if kind_of is not None and (moved or scope not in self._placed):
            from paddle_tpu_torch.sharding import train as _sh_train

            self._placed[scope] = {}
            _sh_train.publish_state_bytes(
                kind_of, {n: scope.vars[n] for n in names if n in scope.vars})

    def _to_device(self, name: str, v: torch.Tensor, device) -> torch.Tensor:
        """``v`` on the step's device, in its placement dtype."""
        cast = self._cast_dtypes.get(name)
        if cast is not None and v.dtype != cast:
            v = v.to(cast)
        return v.to(device)

    def gather_state(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole value of a state name from this rank's shard (every rank
        calls it, as every rank runs the step)."""
        sh = self.state_sharding(name)
        if sh.is_fully_replicated:
            return local
        shape = self._var_shape(name) or tuple(
            d * mesh_lib._block(sh, i) for i, d in enumerate(local.shape))
        return mesh_lib.gather(sh, local, shape)

    def _reduce_dp(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """The means over the dp axis of ``values`` (one all_reduce a dtype)."""
        import torch.distributed as dist

        group, members = self.mesh.group((self._batch_axis,))
        if group is None or not values:
            return values
        out = list(values)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, v in enumerate(values):
            by_dtype.setdefault(v.dtype, []).append(i)
        for idxs in by_dtype.values():
            flat = torch.cat([values[i].reshape(-1) for i in idxs])
            dist.all_reduce(flat, group=group)
            flat = flat / len(members)
            for i, piece in zip(idxs, flat.split([values[i].numel() for i in idxs])):
                out[i] = piece.view(values[i].shape)
        return out

    def _gather_rows(self, v: torch.Tensor) -> torch.Tensor:
        group, _ = self.mesh.group((self._batch_axis,))
        if group is None:
            return v
        return mesh_lib.all_gather_cat(v, group)

    def _execute(self, exe, feed: Dict[str, Any], fetch_names: Tuple[str, ...], scope,
                 return_numpy: bool):
        """One sharded step on this rank (``Executor.run`` of a compiled
        program over more than one rank)."""
        from paddle_tpu_torch.core import lowering
        from paddle_tpu_torch.kernels import dropout as kdropout
        from paddle_tpu_torch.scope import to_numpy

        from paddle_tpu_torch.sharding import activations as _sh_act

        act = self.activation_constrainer()
        if act is not None and act.n <= 1:
            act = None  # no axis of the rules spans more than one rank
        device = exe.device
        mesh = self.mesh
        plan, hit = self._plan(exe, tuple(sorted(feed)), fetch_names)
        stats = exe._cache_stats
        stats["plan_hits" if hit else "plan_misses"] += 1
        stats["hits" if hit else "misses"] += 1
        feeds, rows = {}, set()
        for n in plan.feed_names:
            t = exe._coerce_feed(feed[n], plan.feed_dtypes.get(n))
            local = self._local_feed(n, t)
            if local.dim() and local.shape[0] != t.shape[0]:
                rows.add(local.shape[0])  # a slice of the batch's rows
            feeds[n] = local.to(device, non_blocking=True)
        t0 = time.perf_counter()
        state, _ = self._place(scope, plan, device)
        t1 = time.perf_counter()
        shapes = {n: self._var_shape(n) or tuple(state[n].shape) for n in plan.gather}
        full = mesh_lib.gather_many([(self.state_sharding(n), state[n], shapes[n])
                                     for n in plan.gather])
        t2 = time.perf_counter()
        env = dict(state)
        env.update(zip(plan.gather, full))
        env.update(feeds)
        del full
        dp = mesh.axis_size(self._batch_axis)
        batch_axis = self._batch_axis if dp > 1 else None
        ops, dead, block = plan.ops, plan.dead, self._program.global_block()
        kept_full = {}
        with penv.active_axes(mesh.axis_names), penv.batch_axis_guard(batch_axis), \
                kdropout.batch_slice(mesh.coords.get(self._batch_axis, 0), dp, rows), \
                _sh_act.tracing(act), torch.no_grad():
            if act is not None:
                act.begin_trace()
            lowering.trace_ops(ops[:plan.a1], env, device, block, dead[:plan.a1])
            t3 = time.perf_counter()
            red = [n for n in plan.reduce if n in env]
            env.update(zip(red, self._reduce_dp([env[n] for n in red])))
            t4 = time.perf_counter()
            lowering.trace_ops(ops[plan.a1:plan.a2], env, device, block, dead[plan.a1:plan.a2])
            for n in plan.gather:  # the update phase reads the shards
                if n in env:
                    env[n] = state[n]
            for g, p in plan.cut.items():
                if g in env:
                    if g in plan.fetch_names:
                        kept_full[g] = env[g]
                    env[g] = self.state_sharding(p).shard(env[g]).contiguous()
            lowering.trace_ops(ops[plan.a2:], env, device, block, dead[plan.a2:])
            if act is not None:
                act.end_trace()
        self.last_step_seconds = {"place_s": t1 - t0, "gather_s": t2 - t1,
                                  "reduce_s": t4 - t3}
        placed = self._placed[scope]
        committed = scope.__dict__.setdefault("_mesh_committed", {})
        for n in plan.state_out:
            v = env.get(n)
            if v is None:
                continue
            sh = self.state_sharding(n)
            if not sh.is_fully_replicated:
                shape = self._var_shape(n)
                if shape is not None and tuple(v.shape) == shape:
                    v = sh.shard(v).clone()  # written whole (before the updates)
                committed[n] = (self, v)
            scope.vars[n] = v
            placed[n] = v
        out = []
        for n in plan.fetch_names:
            v = kept_full.get(n, env.get(n))
            if v is None:
                v = scope.vars[n]
            if act is not None and n not in plan.names and isinstance(v, torch.Tensor):
                wd = act.window_dim(n, v.shape)
                if wd is not None:  # a window of the sequence: gathered whole
                    v = act.gather(v, wd)
            if n in plan.names and not self.state_sharding(n).is_fully_replicated:
                v = self.gather_state(n, v)
            elif dp > 1 and n not in plan.names:
                if n in plan.batch_fetches and v.dim() >= 1:
                    v = self._gather_rows(v)
                elif v.is_floating_point():
                    v = self._reduce_dp([v])[0]
            out.append(v)
        if return_numpy:
            return [to_numpy(v) for v in out]
        return out

    def __repr__(self):
        return "CompiledProgram(mesh=%s)" % (dict(self._mesh.shape) if self._mesh else {},)


class ParallelExecutor:
    """Legacy multi-device executor (reference: parallel_executor.py) —
    thin facade over CompiledProgram.with_data_parallel + Executor; the
    ``run`` signature matches the reference (fetch_list of names/vars,
    feed dict split across the dp mesh by the compiled program)."""

    def __init__(self, use_cuda=False, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None, build_strategy=None,
                 num_trainers=1, trainer_id=0, scope=None):
        from paddle_tpu_torch import framework
        from paddle_tpu_torch.executor import Executor

        program = main_program or framework.default_main_program()
        self._compiled = CompiledProgram(program).with_data_parallel(
            loss_name=loss_name, build_strategy=build_strategy, exec_strategy=exec_strategy)
        self._exe = Executor(None if use_cuda else framework.CPUPlace())
        self._scope = scope

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        return self._exe.run(self._compiled, feed=feed or feed_dict, fetch_list=fetch_list,
                             scope=self._scope, return_numpy=return_numpy)
