"""Canonical axis layouts for the in-tree model families.

The port's own copy of the JAX package's ``sharding/layouts.py``: the same
rule sets, name for name, over the port's :class:`PartitionSpec`.

One :class:`~paddle_tpu_torch.sharding.rules.PartitionRules` builder per
(family, mode), in the ``SpecLayout`` tradition: the mesh axes are
named once (``tp`` for tensor/model parallel, ``fsdp`` for
fully-sharded params) and every rule speaks in those names, so the same
layout runs on any mesh that carries the axes.

Modes
-----
* ``tp`` — Megatron-style tensor parallelism: attention q/k/v and the
  FFN up-projection are COLUMN-parallel (output dim sharded over
  ``tp``, their biases ride along), the attention output and FFN
  down-projections are ROW-parallel (input dim sharded, biases
  replicated), embeddings and the LM head shard the vocab dim.
  LayerNorm params replicate.  The port gathers a sharded weight at use
  and runs the matmul whole (split compute is a perf lever, ROADMAP).
* ``fsdp`` — every parameter's leading dim shards over ``fsdp``
  (ZeRO-3-style parameter sharding; all-gathered at use).
* ``fsdp_tp`` — the 2D combination: the ``tp`` layout with every
  replicated weight dim sharded over ``fsdp`` instead.
* ``sp`` (transformer family only, outside ``MODES``) — sequence
  parallelism for long-context serving: parameters replicate and the
  layout's ACTIVATION rules shard the sequence axis over ``sp``: each
  rank keeps its window of it (``sharding/activations.py``) and the fused
  attention op runs as ring attention (``parallel/ring_attention.py``).

Coverage is a tested invariant, not an intention:
``python -m paddle_tpu_torch.tools.check_partition_rules`` builds each
family's real model in the port and fails if any parameter is unmatched
or any rule is dead (matches nothing).
"""
from __future__ import annotations

from typing import Dict

from paddle_tpu_torch.sharding.rules import PartitionRules, PartitionSpec, ShardingRuleError

__all__ = [
    "AXIS_TP",
    "AXIS_FSDP",
    "AXIS_SP",
    "MODES",
    "FAMILIES",
    "canonical_rules",
]

AXIS_TP = "tp"
AXIS_FSDP = "fsdp"
AXIS_SP = "sp"

# the modes every family must support (tools.check_partition_rules
# loops these over serve + train + bf16-variant builds).  ``sp`` is NOT
# a member: sequence parallelism is a transformer-family activation
# layout (DeepFM has no sequence axis, and sp has no train story), so
# it is reachable via canonical_rules(family, "sp") for the transformer
# builders only and guarded by the tool's dedicated check_sp pass.
MODES = ("tp", "fsdp", "fsdp_tp")


def _P(*entries):
    return PartitionSpec(*entries)


def _transformer_rules(mode: str, name: str) -> PartitionRules:
    """Shared layout for the transformer LM and the NMT seq2seq — both
    are built from the same blocks (models/transformer.py), so their
    parameter grammar is identical up to the attention-name alternation
    (``_att_`` encoder-style vs ``_self_``/``_cross_`` decoder-style)."""
    attn = r"_(att|self|cross)_"
    act_rules = ()
    act_default = None
    if mode == "tp":
        col_w, col_b = _P(None, AXIS_TP), _P(AXIS_TP)
        row_w, row_b = _P(AXIS_TP, None), _P()
        emb = _P(AXIS_TP, None)
        ln = _P()
    elif mode == "sp":
        # sequence parallel: every PARAM replicates (the 13 patterns are
        # kept so coverage + no-dead-rules hold for the family grammar);
        # the sharding lives in ACTIVATION rules over the auto-generated
        # intermediate names.  The seq axis sits at dim 2 of the fused
        # attention context ([N, H, S, D]) and dim 1 of everything the
        # fc / layer_norm / residual / embedding chain produces
        # ([N, S, ...]).  reshape/transpose tmps are deliberately
        # unconstrained (the seq axis moves around in them; GSPMD
        # propagation places them from their producers/consumers).
        # Divisibility contract: serve with seq_len % sp == 0 — the
        # constrainer skips a non-divisible dim rather than erroring,
        # and the fused_attention op falls back to its gathered path.
        col_w = col_b = row_w = row_b = emb = ln = _P()
        act_rules = (
            (attn + r"fused_\d+\.tmp", _P(None, None, AXIS_SP)),
            (r"^(fc|layer_norm|elementwise_add|embedding)_\d+\.tmp",
             _P(None, AXIS_SP)),
        )
    elif mode == "fsdp":
        return PartitionRules(
            [(r".", _P(AXIS_FSDP))], name=name)  # dim-0 shard everything
    elif mode == "fsdp_tp":
        col_w, col_b = _P(AXIS_FSDP, AXIS_TP), _P(AXIS_TP)
        row_w, row_b = _P(AXIS_TP, AXIS_FSDP), _P(AXIS_FSDP)
        emb = _P((AXIS_FSDP, AXIS_TP), None)
        ln = _P()
    else:
        raise ShardingRuleError(
            "unknown layout mode %r (have %s; the transformer family "
            "additionally has 'sp')" % (mode, MODES))
    return PartitionRules([
        # attention: q/k/v column-parallel, the output projection
        # row-parallel (Megatron-LM, Shoeybi et al.)
        (attn + r"(q|k|v)_w$", col_w),
        (attn + r"(q|k|v)_b$", col_b),
        (attn + r"out_w$", row_w),
        (attn + r"out_b$", row_b),
        # FFN: up column-parallel, down row-parallel
        (r"_ffn_fc0_w$", col_w),
        (r"_ffn_fc0_b$", col_b),
        (r"_ffn_fc1_w$", row_w),
        (r"_ffn_fc1_b$", row_b),
        # embeddings / head: vocab-dim sharded; positions replicated
        # (small, and the gather index is the position itself)
        (r"_word_emb$", emb),
        (r"_pos_emb$", ln),
        (r"_head_w$", col_w),
        (r"_head_b$", col_b),
        # norms replicate (tiny, and every rank needs them whole)
        (r"_ln\d_(scale|bias)$", ln),
    ], name=name, activations=act_rules, activation_default=act_default)


def transformer_lm_rules(mode: str = "tp") -> PartitionRules:
    return _transformer_rules(mode, "transformer_lm/%s" % mode)


def transformer_nmt_rules(mode: str = "tp") -> PartitionRules:
    return _transformer_rules(mode, "transformer_nmt/%s" % mode)


def deepfm_rules(mode: str = "tp") -> PartitionRules:
    """DeepFM CTR: the wide/FM embedding tables row-shard (the id dim is
    the big one), the dense-tower FCs column-shard over ``tp``, and the
    scalar output projection + auto-named tower biases replicate."""
    name = "deepfm/%s" % mode
    if mode == "fsdp":
        return PartitionRules([(r".", _P(AXIS_FSDP))], name=name)
    if mode == "tp":
        table = _P(AXIS_TP, None)
        tower_w = _P(None, AXIS_TP)
    elif mode == "fsdp_tp":
        table = _P((AXIS_FSDP, AXIS_TP), None)
        tower_w = _P(AXIS_FSDP, AXIS_TP)
    else:
        raise ShardingRuleError("unknown layout mode %r (have %s)"
                                % (mode, MODES))
    return PartitionRules([
        (r"_(w1|fm|deep)_emb$", table),
        (r"_deep_fc\d+_w$", tower_w),
        # the 1-wide output head and LayerHelper's auto-named tower
        # biases (``fc_<n>.b_0``) replicate; the head bias is a scalar
        # and self-replicates, but the rule keeps the name covered
        (r"_deep_out_w$", _P()),
        (r"^fc_\d+\.b_\d+$", _P()),
    ], name=name)


FAMILIES: Dict[str, object] = {
    "transformer_lm": transformer_lm_rules,
    "transformer_nmt": transformer_nmt_rules,
    "deepfm": deepfm_rules,
}


# hot-path: begin layout_lookup (layout builders run at endpoint
# setup/load time: pure construction, no device work)
def canonical_rules(family: str, mode: str = "tp") -> PartitionRules:
    """The canonical layout for ``family`` in ``mode`` (see MODES)."""
    try:
        builder = FAMILIES[family]
    except KeyError:
        raise ShardingRuleError(
            "unknown model family %r (have %s)"
            % (family, sorted(FAMILIES))) from None
    return builder(mode)
# hot-path: end layout_lookup
