"""Declarative partition rules: ordered ``(regex, PartitionSpec)`` pairs.

The port's own copy of the JAX package's ``sharding/rules.py``, with its
own :class:`PartitionSpec` (a tuple of dim entries, as jax's), so a rule
set, its typed errors and its JSON manifest are the JAX package's, key for
key, with no jax import.

The GSPMD-tradition sharding surface (Xu et al., "GSPMD: General and
Scalable Parallelization for ML Computation Graphs"): instead of
annotating every parameter by hand, a model family declares an ORDERED
list of rules matched against parameter *names* (the pjit
partition-rule pattern).  Semantics:

* rules are tried in order; the FIRST pattern whose ``re.search``
  matches the name wins (an unanchored pattern is substring semantics;
  anchor with ``^``/``$`` for exact-name rules),
* scalar / single-element parameters are never partitioned (they get
  ``PartitionSpec()`` without consuming a rule),
* a parameter no rule matches is a typed ``ShardingRuleError`` naming
  it — unless the rule set carries a ``default=`` spec,
* a spec whose rank exceeds the parameter's rank is rejected HERE, at
  rule-resolve time, as a typed error.

Rule sets serialize to a JSON-safe manifest (``to_manifest`` /
``from_manifest``) so ``save_inference_model`` can carry the layout
with the weights and a loader reconstructs the same placement
(``paddle_tpu_torch/io.py``, ``paddle_tpu_torch/inference.py``).

ACTIVATION rules (``activations=``) are a second ordered rule list over
*intermediate* var names (sequence-parallel serving shards activations,
not params).  An unmatched activation resolves to ``activation_default``,
which is ``None`` by default and means no constraint at all.  A compiled
program applies them with ``sharding/activations.py``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

__all__ = [
    "PartitionSpec",
    "PartitionRules",
    "ShardingRuleError",
    "MeshCommittedStateError",
    "spec_to_manifest",
    "spec_from_manifest",
]


class ShardingRuleError(ValueError):
    """A partition-rule problem caught at rule-resolve time: an
    unmatched parameter, a spec whose rank exceeds the parameter's,
    a mesh missing a rule's axis, or a malformed manifest."""


class MeshCommittedStateError(RuntimeError):
    """Scope state holds this rank's shards, placed by a previous
    *compiled* run, and an *uncompiled* ``Executor.run`` would read a
    shard as the whole tensor.  Re-run with the CompiledProgram, or opt
    into reshard-on-gather (``Executor(reshard_on_gather=True)`` /
    ``PADDLE_TPU_RESHARD_ON_GATHER=1``) to gather the state back once
    (every rank runs it, as every rank runs the step)."""


class PartitionSpec(tuple):
    """How a tensor's dims split over mesh axes: one entry a dim, each
    ``None`` (replicated), an axis name, or a tuple of axis names (the
    dim split over several axes, the first outermost).  Trailing dims
    with no entry are replicated.  A tuple, as jax's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return "PartitionSpec(%s)" % ", ".join(repr(e) for e in self)


def _partition_spec_cls():
    return PartitionSpec


def _as_spec(spec):
    """Coerce ``spec`` (PartitionSpec | sequence of entries | None) to a
    PartitionSpec.  Entries are ``None`` (replicated dim), an axis name,
    or a tuple of axis names (a dim sharded over several axes)."""
    P = _partition_spec_cls()
    if spec is None:
        return P()
    if isinstance(spec, P):
        return spec
    if isinstance(spec, str):
        raise ShardingRuleError(
            "partition spec %r is a bare string — pass PartitionSpec(%r) "
            "or a sequence of dim entries" % (spec, spec))
    entries = []
    for e in spec:
        if e is None or isinstance(e, str):
            entries.append(e)
        elif isinstance(e, (list, tuple)):
            entries.append(tuple(str(a) for a in e))
        else:
            raise ShardingRuleError(
                "partition spec entry %r: expected None, an axis name, "
                "or a tuple of axis names" % (e,))
    return P(*entries)


def spec_to_manifest(spec) -> list:
    """JSON-safe form of a PartitionSpec: a list whose entries are
    ``None``, an axis-name string, or a list of axis names."""
    out = []
    for e in tuple(spec):
        if e is None or isinstance(e, str):
            out.append(e)
        else:
            out.append([str(a) for a in e])
    return out


def spec_from_manifest(doc) -> Any:
    return _as_spec(doc)


def _shape_of(leaf) -> Optional[Tuple[int, ...]]:
    shape = getattr(leaf, "shape", None)
    if shape is None and isinstance(leaf, (tuple, list)):
        shape = leaf
    if shape is None:
        return None
    return tuple(int(d) for d in shape)


def _n_elements(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


class PartitionRules:
    """An ordered first-match-wins rule set over parameter names.

    ``rules``: sequence of ``(pattern, spec)`` where ``pattern`` is a
    regex matched with ``re.search`` and ``spec`` is a PartitionSpec
    (or a sequence of dim entries).  ``default``: the spec unmatched
    parameters fall back to; with no default an unmatched parameter is
    a typed :class:`ShardingRuleError`.
    """

    def __init__(self, rules: Iterable[Tuple[str, Any]], default=None,
                 name: str = "rules", activations: Iterable[Tuple[str, Any]] = (),
                 activation_default=None):
        self.name = str(name)
        self.rules: Tuple[Tuple[str, Any], ...] = tuple(
            (str(pat), _as_spec(spec)) for pat, spec in rules)
        self._compiled = tuple(
            (re.compile(pat), spec) for pat, spec in self.rules)
        self.default = _as_spec(default) if default is not None else None
        # activation (intermediate-var) rules: same first-match-wins
        # grammar, but the fallback is None = NO constraint (see module
        # docstring) — P() here would force replication
        self.activations: Tuple[Tuple[str, Any], ...] = tuple(
            (str(pat), _as_spec(spec)) for pat, spec in activations)
        self._act_compiled = tuple(
            (re.compile(pat), spec) for pat, spec in self.activations)
        self.activation_default = (_as_spec(activation_default)
                                   if activation_default is not None else None)
        if not self.rules and self.default is None:
            raise ShardingRuleError(
                "empty rule set %r with no default spec" % self.name)

    # ------------------------------------------------------------------
    def with_default(self, default) -> "PartitionRules":
        """A copy of this rule set with ``default`` as the unmatched-name
        fallback spec.  Subclasses override so a rebuild keeps their
        extra state (TrainPartitionRules' accumulator map)."""
        return PartitionRules(self.rules, default=default, name=self.name,
                              activations=self.activations,
                              activation_default=self.activation_default)

    def axes(self) -> set:
        """Every mesh axis name any rule (or the default) refers to —
        activation rules included, so ``validate_mesh`` catches a
        missing ``sp`` axis at bind time."""
        out: set = set()
        specs = [spec for _, spec in self.rules]
        specs.extend(spec for _, spec in self.activations)
        if self.default is not None:
            specs.append(self.default)
        if self.activation_default is not None:
            specs.append(self.activation_default)
        for spec in specs:
            for e in tuple(spec):
                if e is None:
                    continue
                if isinstance(e, str):
                    out.add(e)
                else:
                    out.update(e)
        return out

    # hot-path: begin rule_resolve (called from the compiled program's
    # state-sharding memo MISS path: once per name, pure regex work)
    def _first_match(self, name: str):
        """(pattern, spec) of the first matching rule, or None."""
        for rx, spec in self._compiled:
            if rx.search(name) is not None:
                return rx.pattern, spec
        return None
    # hot-path: end rule_resolve

    @staticmethod
    def _check_rank(name: str, spec, shape: Sequence[int],
                    pattern: Optional[str]) -> None:
        if len(tuple(spec)) > len(shape):
            via = " (rule %r)" % pattern if pattern else " (default spec)"
            raise ShardingRuleError(
                "partition spec %s has rank %d but param %r has shape %s"
                "%s — spec rank must not exceed the param rank"
                % (tuple(spec), len(tuple(spec)), name, tuple(shape), via))

    # ------------------------------------------------------------------
    def spec_for(self, name: str, shape=None):
        """Resolve one parameter name to its PartitionSpec.

        ``shape`` (a shape sequence or an object with ``.shape``):
        enables the scalar short-circuit and the rank check; without it
        only name matching happens.  Raises :class:`ShardingRuleError`
        for an unmatched name (no ``default``) or a spec/param rank
        mismatch."""
        P = _partition_spec_cls()
        shp = _shape_of(shape) if shape is not None else None
        if shp is not None and (len(shp) == 0 or _n_elements(shp) == 1):
            return P()  # never partition scalars / single elements
        hit = self._first_match(name)
        if hit is not None:
            pattern, spec = hit
            if shp is not None:
                self._check_rank(name, spec, shp, pattern)
            return spec
        if self.default is not None:
            if shp is not None:
                self._check_rank(name, self.default, shp, None)
            return self.default
        raise ShardingRuleError(
            "no partition rule in %r matches param %r (tried %d rules, "
            "no default= spec given)"
            % (self.name, name, len(self.rules)))

    def match(self, params: Mapping[str, Any]) -> Dict[str, Any]:
        """Resolve every entry of ``{name: array-or-shape}`` to a spec
        pytree ``{name: PartitionSpec}``; first unmatched name (or rank
        mismatch) raises typed."""
        return {
            name: self.spec_for(name, shape=leaf)
            for name, leaf in params.items()
        }

    # hot-path: begin activation_resolve (pure regex + dict work)
    def activation_spec_for(self, name: str, shape=None):
        """Resolve one INTERMEDIATE var name to its PartitionSpec, or
        ``None`` for "no constraint" (unmatched and no
        ``activation_default``).  A spec whose rank exceeds the value's
        is resolved to None rather than raised: intermediates are
        auto-named and rule authors match families of them, so a
        low-rank straggler (a scalar scale, a [S] position vector)
        simply goes unconstrained."""
        hit = None
        for rx, spec in self._act_compiled:
            if rx.search(name) is not None:
                hit = spec
                break
        if hit is None:
            hit = self.activation_default
        if hit is None:
            return None
        shp = _shape_of(shape) if shape is not None else None
        if shp is not None and len(tuple(hit)) > len(shp):
            return None
        return hit
    # hot-path: end activation_resolve

    def dead_activation_rules(self, names: Iterable[str]) -> list:
        """Activation patterns matching NONE of ``names`` — same
        stale-cruft contract as :meth:`dead_rules`."""
        names = list(names)
        out = []
        for rx, _ in self._act_compiled:
            if not any(rx.search(n) is not None for n in names):
                out.append(rx.pattern)
        return out

    def dead_rules(self, names: Iterable[str]) -> list:
        """Patterns that match NONE of ``names`` — a dead rule in a
        canonical layout is stale cruft that will rot (the
        check_partition_rules tool fails them)."""
        names = list(names)
        out = []
        for rx, _ in self._compiled:
            if not any(rx.search(n) is not None for n in names):
                out.append(rx.pattern)
        return out

    def validate_mesh(self, mesh) -> None:
        """Every axis the rules name must exist on ``mesh``, caught
        here as a typed error."""
        missing = sorted(self.axes() - set(mesh.axis_names))
        if missing:
            raise ShardingRuleError(
                "rule set %r shards over mesh axes %s which are not on "
                "the mesh (axes: %s)"
                % (self.name, missing, list(mesh.axis_names)))

    @staticmethod
    def check_divisible(name: str, spec, shape: Sequence[int],
                        axis_sizes: Mapping[str, int]) -> None:
        """Every sharded dim must divide by its axes' total size: nothing
        is padded, so an uneven shard is a typed error naming the param
        and the rule-level cause."""
        for dim, entry in zip(shape, tuple(spec)):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            k = 1
            for a in axes:
                k *= int(axis_sizes.get(a, 1))
            if k > 1 and int(dim) % k:
                raise ShardingRuleError(
                    "param %r dim of size %d is sharded over %s (total "
                    "%d devices) but is not divisible by it (shape %s, "
                    "spec %s)" % (name, int(dim), list(axes), k,
                                  tuple(shape), tuple(spec)))

    def validate_shapes(self, named_shapes: Mapping[str, Any],
                        axis_sizes: Mapping[str, int]) -> None:
        """Resolve every entry and check shard divisibility against the
        mesh axis sizes — the full fail-at-export bundle (coverage +
        rank + divisibility), all typed."""
        for name, leaf in named_shapes.items():
            shape = _shape_of(leaf)
            spec = self.spec_for(name, shape=leaf)
            if shape:
                self.check_divisible(name, spec, shape, axis_sizes)

    # ------------------------------------------------------------------
    def to_manifest(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {
            "name": self.name,
            "rules": [[pat, spec_to_manifest(spec)]
                      for pat, spec in self.rules],
        }
        if self.default is not None:
            doc["default"] = spec_to_manifest(self.default)
        if self.activations:
            doc["activations"] = [[pat, spec_to_manifest(spec)]
                                  for pat, spec in self.activations]
        if self.activation_default is not None:
            doc["activation_default"] = spec_to_manifest(
                self.activation_default)
        return doc

    @classmethod
    def from_manifest(cls, doc: Mapping[str, Any]) -> "PartitionRules":
        try:
            rules = [(pat, spec_from_manifest(spec))
                     for pat, spec in doc["rules"]]
            acts = [(pat, spec_from_manifest(spec))
                    for pat, spec in doc.get("activations", [])]
        except (KeyError, TypeError, ValueError) as e:
            raise ShardingRuleError(
                "malformed partition-rules manifest: %r" % (doc,)) from e
        default = doc.get("default")
        act_default = doc.get("activation_default")
        return cls(rules,
                   default=spec_from_manifest(default)
                   if default is not None else None,
                   name=doc.get("name", "rules"),
                   activations=acts,
                   activation_default=spec_from_manifest(act_default)
                   if act_default is not None else None)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.rules)

    def __repr__(self) -> str:
        return "PartitionRules(%r, %d rules%s%s)" % (
            self.name, len(self.rules),
            ", default=%s" % (tuple(self.default),)
            if self.default is not None else "",
            ", %d activation rules" % len(self.activations)
            if self.activations else "")
