"""Static partition-rule guard for the port: canonical layouts and the
real models agree.

The port's copy of the JAX package's ``tools/check_partition_rules.py``,
building the port's own models.  Every canonical layout in
``paddle_tpu_torch/sharding/layouts.py`` must, for every mode, FULLY cover
its model family's parameter names against the real in-tree model:

1. no unmatched parameter — each persistable resolves to a spec (the
   scalar auto-replicate shortcut counts as covered),
2. no dead rule — a pattern matching NO parameter of the family is
   stale cruft that will rot,
3. no rank mismatch — every resolved spec fits its parameter's rank
   (``PartitionRules.match`` raises typed otherwise).

TRAIN mode builds each family with a backward pass and Adam: every
layout wrapped in ``train_rules`` must cover the full train persistable
set (params, accumulators through their param's rule, the LR var).
BF16-VARIANT mode checks that each family's bf16 serving variant keeps
the base parameter grammar, so one sharding manifest serves both.  SP
mode checks the transformer family's ``sp`` layout against the fused
LM: every param covered, every activation rule matching a real
intermediate, the fused attention output constrained.

Run::

    python -m paddle_tpu_torch.tools.check_partition_rules   # exits 1 and prints problems
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple


def _build_family(family: str, train: bool):
    """Build one family's real in-tree model; with ``train`` a real
    Adam minimize is appended (labels + backward + accumulators).
    Returns ({persistable name: shape}, optimizer-or-None, program,
    fetch var — the loss when training, the serve output otherwise) —
    ONE construction per family, so the serve and train guards can
    never validate against different parameter grammars."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import framework, models
    from paddle_tpu_torch.models.seq2seq import transformer_nmt

    prog, startup = framework.Program(), framework.Program()
    with framework.program_guard(prog, startup):
        if family == "transformer_lm":
            ids = fluid.layers.data("src_ids", [16], dtype="int64")
            lbl = (fluid.layers.data("lbl", [16, 1], dtype="int64")
                   if train else None)
            loss, out = models.transformer_lm(
                ids, lbl, vocab_size=128, d_model=32, n_layer=2,
                n_head=4, d_inner=64, seq_len=16, max_pos=64)
        elif family == "transformer_nmt":
            src = fluid.layers.data("src_ids", [8], dtype="int64")
            tgt = fluid.layers.data("tgt_ids", [8], dtype="int64")
            lbl = (fluid.layers.data("lbl", [8, 1], dtype="int64")
                   if train else None)
            loss, out = transformer_nmt(src, tgt, lbl, None,
                                        src_len=8, tgt_len=8)
        elif family == "deepfm":
            ids = fluid.layers.data("feat_ids", [39, 1], dtype="int64")
            vals = fluid.layers.data("feat_vals", [39])
            lbl = fluid.layers.data("lbl", [1], dtype="int64")
            loss, out = models.deepfm_ctr(ids, vals, lbl, num_features=1000,
                                          num_fields=39, embed_dim=8,
                                          deep_layers=(16, 16))
        else:
            raise ValueError("unknown family %r" % family)
        opt = None
        if train:
            opt = fluid.optimizer.AdamOptimizer(1e-3)
            opt.minimize(loss)
    # the same predicate save_inference_model validates against
    # (io._is_persistable): persistable non-Parameter vars must be covered
    # too, or this guard would pass layouts the export path rejects
    shapes = {
        v.name: tuple(v.shape or ())
        for v in prog.list_vars()
        if v.persistable and not v.is_data
    }
    return shapes, opt, prog, (loss if loss is not None else out)


def _build(family: str) -> Dict[str, Tuple[int, ...]]:
    """{param name: shape} for one family's real in-tree model."""
    return _build_family(family, train=False)[0]


def _build_train(family: str):
    """(persistable shapes, accumulator map) for one family's real
    TRAIN program: the same build as :func:`_build` with labels + a
    real Adam minimize, so the persistable set includes every optimizer
    accumulator and the LR var — exactly what a sharded training run
    must place."""
    shapes, opt, _, _ = _build_family(family, train=True)
    return shapes, opt.accumulator_map()


def check() -> List[str]:
    from paddle_tpu_torch.sharding.layouts import FAMILIES, MODES, canonical_rules
    from paddle_tpu_torch.sharding.rules import ShardingRuleError

    problems: List[str] = []
    for family in sorted(FAMILIES):
        params = _build(family)
        if not params:
            problems.append("family %r built zero parameters" % family)
            continue
        for mode in MODES:
            rules = canonical_rules(family, mode)
            try:
                rules.match(params)
            except ShardingRuleError as e:
                problems.append(
                    "layout %s/%s does not cover its family: %s"
                    % (family, mode, e))
            for pat in rules.dead_rules(params):
                problems.append(
                    "layout %s/%s rule %r matches no %s parameter "
                    "(dead rule)" % (family, mode, pat, family))
    return problems


def check_train() -> List[str]:
    """Train-mode coverage: every canonical layout, wrapped in
    ``train_rules``, must resolve the family's FULL train persistable
    set — optimizer accumulators inherit their param's rule, scalars
    (beta pows, LR) auto-replicate, and no rule may be dead against the
    param names."""
    from paddle_tpu_torch.sharding.layouts import FAMILIES, MODES, canonical_rules
    from paddle_tpu_torch.sharding.rules import ShardingRuleError
    from paddle_tpu_torch.sharding.train import train_rules

    problems: List[str] = []
    for family in sorted(FAMILIES):
        shapes, acc_map = _build_train(family)
        if not acc_map:
            problems.append(
                "family %r built zero optimizer accumulators" % family)
            continue
        missing = [a for a, (p, _) in acc_map.items() if a not in shapes]
        if missing:
            problems.append(
                "family %r: accumulators %s not among the program's "
                "persistables" % (family, missing[:3]))
        for mode in MODES:
            rules = train_rules(canonical_rules(family, mode),
                                accumulators=acc_map)
            try:
                rules.match(shapes)
            except ShardingRuleError as e:
                problems.append(
                    "train layout %s/%s does not cover its family's "
                    "train state: %s" % (family, mode, e))
            param_names = [n for n in shapes if n not in acc_map]
            for pat in rules.dead_rules(param_names):
                problems.append(
                    "train layout %s/%s rule %r matches no %s "
                    "parameter (dead rule)" % (family, mode, pat, family))
    return problems


def check_bf16_variants() -> List[str]:
    """Precision × sharding composed-mode guard: the bf16 VARIANT of
    each family's model must keep the base parameter grammar — hoisted
    casts flip dtypes, never names — so every canonical layout resolves
    the variant's param set exactly like the base's.  This is the
    invariant that lets ONE sharding manifest serve both the fp32
    program and its bf16 variant (``save_inference_model`` composes the
    two blocks; ``AnalysisPredictor`` reconstructs both on load): if a
    refactor ever makes hoisting rename a parameter, it fails here, not
    at a sharded bf16 endpoint's first warmup."""
    from paddle_tpu_torch.contrib.mixed_precision.inference import (
        build_bf16_variant,
    )
    from paddle_tpu_torch.sharding.layouts import FAMILIES, MODES, canonical_rules
    from paddle_tpu_torch.sharding.rules import ShardingRuleError

    problems: List[str] = []
    for family in sorted(FAMILIES):
        base_shapes, _, prog, fetch = _build_family(family, train=False)
        variant, info = build_bf16_variant(prog, [fetch.name])
        if not info["cast_params"]:
            problems.append(
                "family %r: bf16 variant hoisted zero params — the "
                "composed export would serve fp32 under a bf16 label"
                % family)
        vshapes = {
            v.name: tuple(v.shape or ())
            for v in variant.list_vars()
            if v.persistable and not v.is_data
        }
        if set(vshapes) != set(base_shapes):
            added = sorted(set(vshapes) - set(base_shapes))[:3]
            gone = sorted(set(base_shapes) - set(vshapes))[:3]
            problems.append(
                "family %r: bf16 variant param set drifted from the "
                "base program (added %s, removed %s) — one sharding "
                "manifest can no longer cover both" % (family, added,
                                                       gone))
            continue
        for mode in MODES:
            rules = canonical_rules(family, mode)
            try:
                rules.match(vshapes)
            except ShardingRuleError as e:
                problems.append(
                    "layout %s/%s does not cover the family's bf16 "
                    "variant: %s" % (family, mode, e))
    return problems


def check_sp() -> List[str]:
    """Sequence-parallel layout guard, validated against the real
    FUSED-attention LM build — the sp serving target, where causality
    is the fused op's attr and no [S, S] bias tensor exists to be
    mis-sharded.  Param rules must cover the full param set with no
    dead rule (all-replicated, but coverage is what lets one manifest
    carry the layout); activation rules must each match a real
    intermediate name, and the fused attention output — the tensor the
    ring attention keys on — must resolve to a constraint.  A run of the
    build under the sp constrainer of a two-rank axis, on meta tensors
    (shapes only, no collective), must dispatch every fused attention op
    to the ring (``parallel/ring_attention.py``)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import framework, models
    from paddle_tpu_torch.sharding.layouts import transformer_lm_rules
    from paddle_tpu_torch.sharding.rules import ShardingRuleError

    problems: List[str] = []
    prog, startup = framework.Program(), framework.Program()
    with framework.program_guard(prog, startup):
        ids = fluid.layers.data("src_ids", [16], dtype="int64")
        models.transformer_lm(
            ids, None, vocab_size=128, d_model=32, n_layer=2,
            n_head=4, d_inner=64, seq_len=16, max_pos=64,
            fused_attention=True)
    params = {
        v.name: tuple(v.shape or ())
        for v in prog.list_vars()
        if v.persistable and not v.is_data
    }
    inter = [v.name for v in prog.list_vars()
             if not v.persistable and not v.is_data]
    if not inter:
        return ["fused transformer_lm built zero intermediates"]
    rules = transformer_lm_rules("sp")
    try:
        rules.match(params)
    except ShardingRuleError as e:
        problems.append(
            "sp layout does not cover the fused LM's params: %s" % e)
    for pat in rules.dead_rules(params):
        problems.append(
            "sp layout param rule %r matches no parameter (dead rule)"
            % pat)
    for pat in rules.dead_activation_rules(inter):
        problems.append(
            "sp layout activation rule %r matches no fused-LM "
            "intermediate (dead rule)" % pat)
    constrained = [n for n in inter
                   if rules.activation_spec_for(n) is not None]
    if not constrained:
        problems.append(
            "sp layout constrains zero fused-LM intermediates")
    if not any("att_fused" in n for n in constrained):
        problems.append(
            "sp layout leaves the fused attention output unconstrained "
            "— the ring-attention target must carry the sp "
            "spec")
    n_attn = sum(op.type == "fused_attention" for op in prog.global_block().ops)
    ring_calls = _sp_ring_calls(prog, rules)
    if ring_calls != n_attn:
        problems.append(
            "a traced sp build dispatched %d of its %d fused attention ops to "
            "the ring" % (ring_calls, n_attn))
    return problems


def _sp_ring_calls(prog, rules, n_sp: int = 2) -> int:
    """The ring dispatches of one run of ``prog`` under the sp constrainer of
    an ``n_sp``-rank axis (rank 0's view), on meta tensors: feeds of 2 rows,
    every persistable at its declared shape."""
    import torch

    from paddle_tpu_torch.core import lowering
    from paddle_tpu_torch.core import types as core_types
    from paddle_tpu_torch.parallel.ring_attention import reset_ring_stats, ring_stats
    from paddle_tpu_torch.sharding import activations

    block = prog.global_block()
    env = {v.name: torch.empty([2 if int(d) < 0 else int(d) for d in v.shape],
                               dtype=core_types.torch_dtype(core_types.canonical_dtype(v.dtype)),
                               device="meta")
           for v in prog.list_vars() if v.persistable or v.is_data}
    ctx = activations.ActivationConstrainer(rules, None, {"sp": n_sp}, coords={"sp": 0},
                                            block=block)
    reset_ring_stats()
    with activations.tracing(ctx), torch.no_grad():
        lowering.trace_ops(block.ops, env, torch.device("meta"), block)
    return ring_stats()["calls"]


def main() -> int:
    problems = (check() + check_train() + check_bf16_variants()
                + check_sp())
    if not problems:
        from paddle_tpu_torch.sharding.layouts import FAMILIES, MODES

        print("check_partition_rules: OK (%d layouts cover %d families, "
              "serve + train + bf16 variants + sp activations)"
              % (len(FAMILIES) * len(MODES), len(FAMILIES)))
        return 0
    for p in problems:
        print("check_partition_rules: %s" % p, file=sys.stderr)
    print("check_partition_rules: %d problem(s)" % len(problems),
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
