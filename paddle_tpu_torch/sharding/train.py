"""Sharded FSDP/TP *training* through the partition-rules surface.

The port's own copy of the JAX package's ``sharding/train.py``.  The same
rules that place a served model's parameters, pointed at a TRAIN
program (forward + backward + optimizer ops), place params and optimizer
state sharded on the mesh with no new user concepts:

* :class:`TrainPartitionRules` — a rule set that also carries the
  optimizer's accumulator↔param mapping
  (``Optimizer.accumulator_map()``).  Each accumulator derives its spec
  from **its param's matched rule**: an Adam moment inherits the param's
  placement, a scalar beta-pow auto-replicates, and there is NO
  ``default=`` escape hatch in the derivation — an accumulator whose
  param no rule covers fails typed, naming the param.
* :func:`train_rules` — build one from a base layout (e.g.
  ``canonical_rules("transformer_lm", "fsdp")``) plus a live optimizer
  or an explicit accumulator map.
* :func:`sharded_train_program` — the one-call surface:
  ``CompiledProgram(prog).with_sharding_rules(train_rules(...))`` with
  the mesh bound, ready for ``Executor.run``.  Each rank keeps its
  shard of every sharded persistable between steps; the step gathers
  the parameters, runs forward and backward whole, cuts the gradients to
  the rank's shard and runs the optimizer ops on the shards
  (``parallel/compiled_program.py``).

Export closes the loop: ``save_inference_model(sharding_rules=`` a
``TrainPartitionRules``)`` unwraps to the base serving rules (the
pruned inference program has no accumulators).

Observability: the compiled program publishes
``sharding_train_state_bytes{kind=param|grad|moment}`` (one rank's
bytes) when it places the state, and the series retire when the layout
is torn down (:func:`retire_state_bytes`, also called on a mesh/rules
rebind).

The shard-box algebra below (index regions as ``((start, stop), ...)``
per dim) is shared by the shard-exchange checkpoint restore
(``faults/checkpoint.py``) and the offline verifier
(``tools/check_checkpoint.py``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

from paddle_tpu_torch.sharding.rules import (
    PartitionRules,
    PartitionSpec,
    ShardingRuleError,
    _n_elements,
    _shape_of,
)

__all__ = [
    "TrainPartitionRules",
    "train_rules",
    "sharded_train_program",
    "per_device_bytes",
    "state_bytes",
    "publish_state_bytes",
    "retire_state_bytes",
    "box_overlap",
    "box_volume",
    "boxes_cover",
    "shard_boxes",
]

_KINDS = ("param", "grad", "moment")


class TrainPartitionRules(PartitionRules):
    """A rule set over a TRAIN program's persistables.

    ``accumulators``: ``{accumulator var name: param name}`` (values may
    also be ``(param name, kind)`` tuples, the
    ``Optimizer.accumulator_map()`` shape).  Resolution:

    * an accumulator resolves to **its param's** spec — the param's
      first matching rule (or the rule set's default, when the param
      itself falls back to it); scalar/single-element accumulators
      (Adam beta pows) auto-replicate like any scalar,
    * every other name resolves with plain :class:`PartitionRules`
      semantics,
    * rank checks run against the accumulator's OWN shape, so a spec a
      param carries but an accumulator cannot (rank mismatch) is a
      typed error naming both.

    The base layout is kept as :attr:`serving_rules`:
    ``save_inference_model`` unwraps to it, so the exported manifest is
    exactly the serving layout (accumulators do not exist in the pruned
    inference program).
    """

    def __init__(self, rules, accumulators: Mapping[str, object],
                 default=None, name: Optional[str] = None):
        if isinstance(rules, PartitionRules):
            base = rules
            if default is not None:
                base = PartitionRules(base.rules, default=default,
                                      name=base.name)
        else:
            base = PartitionRules(rules, default=default)
        super().__init__(base.rules, default=base.default,
                         name=name or "%s+train" % base.name)
        self.serving_rules = base
        self._acc_param: Dict[str, str] = {}
        self._acc_kind: Dict[str, str] = {}
        for acc, ent in dict(accumulators).items():
            if isinstance(ent, (tuple, list)):
                pname, kind = str(ent[0]), str(ent[1])
            else:
                pname, kind = str(ent), "moment"
            self._acc_param[str(acc)] = pname
            self._acc_kind[str(acc)] = kind
        if not self._acc_param:
            raise ShardingRuleError(
                "TrainPartitionRules %r got an empty accumulator map — "
                "build it from Optimizer.accumulator_map() AFTER "
                "minimize() has run" % self.name)

    @property
    def accumulators(self) -> Dict[str, str]:
        """{accumulator name: param name} (copy)."""
        return dict(self._acc_param)

    def with_default(self, default) -> "TrainPartitionRules":
        # keep the accumulator map through a default rebind — dropping
        # to a plain PartitionRules here would silently replicate any
        # accumulator whose param only the default covers
        return TrainPartitionRules(
            self.serving_rules,
            {a: (p, self._acc_kind[a]) for a, p in self._acc_param.items()},
            default=default, name=self.name)

    def state_kind(self, name: str) -> Optional[str]:
        """``"moment"`` for an optimizer accumulator, ``"param"`` for a
        name some accumulator points at, None otherwise (LR vars, EMA
        state, ...).  The classification behind the
        ``sharding_train_state_bytes`` gauge."""
        if name in self._acc_param:
            return "moment"
        if name in self._param_names:
            return "param"
        return None

    @property
    def _param_names(self):
        names = getattr(self, "_param_name_set", None)
        if names is None:
            names = self._param_name_set = set(self._acc_param.values())
        return names

    # hot-path: begin train_spec_resolve (rule resolution for train
    # state: once per name on the compiled program's memo miss; pure
    # dict/regex work only)
    def spec_for(self, name: str, shape=None):
        param = self._acc_param.get(name)
        if param is None:
            return super().spec_for(name, shape=shape)
        shp = _shape_of(shape) if shape is not None else None
        if shp is not None and (len(shp) == 0 or _n_elements(shp) == 1):
            # scalar accumulators (beta pows, step counters) never
            # partition — same shortcut as params
            return PartitionSpec()
        try:
            # the param's FULL resolution (its matched rule, or the rule
            # set's default when the param itself uses it) — the
            # accumulator adds no fallback of its own
            spec = super().spec_for(param)
        except ShardingRuleError as e:
            raise ShardingRuleError(
                "accumulator %r inherits its spec from param %r, which "
                "no rule covers: %s" % (name, param, e)) from None
        if shp is not None:
            self._check_rank(
                name, spec, shp, "inherited from param %r" % param)
        return spec
    # hot-path: end train_spec_resolve


def train_rules(rules, optimizer=None, accumulators=None,
                default=None, name: Optional[str] = None
                ) -> TrainPartitionRules:
    """Build :class:`TrainPartitionRules` from a base layout plus the
    optimizer that owns the accumulators.

    ``rules``: a :class:`PartitionRules` (e.g. ``canonical_rules(...)``)
    or a ``(regex, spec)`` list.  ``optimizer``: a live
    ``paddle_tpu_torch.optimizer.Optimizer`` AFTER ``minimize()`` — its
    ``accumulator_map()`` supplies the name↔param ground truth;
    ``accumulators`` passes the map explicitly instead."""
    if accumulators is None:
        if optimizer is None:
            raise ShardingRuleError(
                "train_rules needs the optimizer (or an explicit "
                "accumulators= map) to know which accumulator belongs "
                "to which param")
        accumulators = optimizer.accumulator_map()
    return TrainPartitionRules(rules, accumulators, default=default,
                               name=name)


def sharded_train_program(program, rules, optimizer=None,
                          accumulators=None, mesh=None, mesh_axes=None,
                          default=None):
    """One call from a built train program to a mesh-sharded
    ``CompiledProgram``: wraps ``rules`` into train rules (accumulators
    inherit their param's placement) and binds the mesh.  ``program``
    may be a ``Program`` or an existing ``CompiledProgram``."""
    from paddle_tpu_torch.parallel.compiled_program import CompiledProgram

    if not isinstance(rules, TrainPartitionRules):
        rules = train_rules(rules, optimizer=optimizer,
                            accumulators=accumulators, default=default)
    compiled = (program if getattr(program, "_is_compiled_program", False)
                else CompiledProgram(program))
    return compiled.with_sharding_rules(rules, mesh=mesh,
                                        mesh_axes=mesh_axes)


# ---------------------------------------------------------------------------
# shard-box algebra: index regions as ((start, stop), ...) per dim.
# ---------------------------------------------------------------------------
def box_overlap(a, b):
    """Intersection of two boxes (same rank), or None when disjoint on
    any dim.  A box is ``((start, stop), ...)`` over the global shape."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(int(a0), int(b0)), min(int(a1), int(b1))
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def box_volume(box) -> int:
    n = 1
    for lo, hi in box:
        n *= max(0, int(hi) - int(lo))
    return n


def boxes_cover(boxes, target) -> bool:
    """True iff ``boxes`` (pairwise-disjoint regions — a PartitionSpec
    sharding's shard grid is) fully tile ``target``: the disjointness
    makes overlap-volume summation an exact coverage test."""
    vol = 0
    for b in boxes:
        ov = box_overlap(b, target)
        if ov is not None:
            vol += box_volume(ov)
    return vol == box_volume(target)


def shard_boxes(sharding, shape):
    """``{box: [ranks]}`` — each DISTINCT shard region of ``sharding``
    (a ``parallel.mesh.NamedSharding``) over global ``shape`` and the
    mesh ranks holding a replica of it."""
    out: Dict = {}
    for rank, box in sharding.devices_indices_map(
            tuple(int(d) for d in shape)).items():
        out.setdefault(tuple(box), []).append(rank)
    return out


# ---------------------------------------------------------------------------
# per-device state-bytes accounting (sharding_train_state_bytes gauge)
# ---------------------------------------------------------------------------
def per_device_bytes(arr) -> int:
    """ONE rank's bytes for ``arr``: a rank's scope holds its own shard of
    a sharded value and the whole of a replicated one, so this is the
    value's size — the measurement behind the gauge and the tests (one
    definition, so they cannot drift)."""
    if hasattr(arr, "element_size"):
        return int(arr.numel() * arr.element_size())
    return int(getattr(arr, "nbytes", 0))


# hot-path: begin train_state_bytes (runs on the compiled program's
# placement pass; reads sizes only, never a device buffer)
def state_bytes(kind_of, *state_dicts) -> Dict[str, int]:
    """Per-device bytes by kind over state dicts of {name: array}.
    ``kind_of``: name -> "param"|"moment"|None (TrainPartitionRules
    .state_kind).  Grad bytes are the param total: one grad per
    trainable param, placed like its param by the pinned update
    layout."""
    totals = {"param": 0, "moment": 0}
    for d in state_dicts:
        for n, a in d.items():
            kind = kind_of(n)
            if kind in totals:
                totals[kind] += per_device_bytes(a)
    totals["grad"] = totals["param"]
    return totals
# hot-path: end train_state_bytes


def publish_state_bytes(kind_of, *state_dicts) -> Dict[str, int]:
    """Set the ``sharding_train_state_bytes{kind=...}`` gauges from the
    current state placement (called by the compiled program on each
    full placement pass; steady-state dispatches skip it entirely)."""
    from paddle_tpu_torch.sharding import metrics as _metrics

    totals = state_bytes(kind_of, *state_dicts)
    for kind in _KINDS:
        _metrics.TRAIN_STATE_BYTES.labels(kind=kind).set(totals[kind])
    return totals


def retire_state_bytes() -> None:
    """Drop the ``sharding_train_state_bytes`` series from the
    exposition — called when the sharded-training layout is torn down
    (the compiled program's mesh/rules rebind does this; tests call it
    explicitly after teardown).  Like the publish path,
    this is process-global: the gauge carries only a ``kind`` label, so
    a process is assumed to host ONE sharded trainer at a time."""
    from paddle_tpu_torch.sharding import metrics as _metrics

    for kind in _KINDS:
        _metrics.TRAIN_STATE_BYTES.remove_labels(kind=kind)
