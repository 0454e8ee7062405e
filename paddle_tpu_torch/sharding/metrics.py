"""Sharding metrics (process-global registry, always on).

The port's copy of the JAX package's ``sharding/metrics.py``, less the
mesh-resident sparse tables' series (ROADMAP A10 part 4).  Registered at
import like every subsystem's metrics;
``paddle_tpu_torch.tools.check_metrics_docs`` holds the README table to
this set.

``sharding_params_sharded_total`` counts parameters a compiled program
placed SHARD-wise (a non-replicated PartitionSpec) on a rank: placement
happens on a step's first run over a scope, so the counter moving after
warmup means state is being re-placed per step.
``sharding_group_hbm_bytes`` is one rank's device bytes of one
model-parallel group's persistable state: the number the "does this
model fit one card's share" capacity math reads.
"""
from __future__ import annotations

from paddle_tpu_torch.monitor import registry as _registry

__all__ = ["PARAMS_SHARDED", "GROUP_HBM_BYTES", "ACTIVATION_BYTES", "TRAIN_STATE_BYTES"]

PARAMS_SHARDED = _registry.REGISTRY.counter(
    "sharding_params_sharded_total",
    "params placed shard-wise (non-replicated PartitionSpec) onto a "
    "mesh at restage time")
GROUP_HBM_BYTES = _registry.REGISTRY.gauge(
    "sharding_group_hbm_bytes",
    "per-device HBM bytes of one model-parallel group's persistable "
    "state (sharded params count their shard, replicated params their "
    "full size)", ("group",))
ACTIVATION_BYTES = _registry.REGISTRY.gauge(
    "sharding_activation_bytes",
    "per-device bytes of one group's constrained intermediate "
    "activations, summed over the last traced program (sequence-"
    "parallel serving's capacity number: ~1/n_sp of the unsharded "
    "activation footprint)", ("group",))
TRAIN_STATE_BYTES = _registry.REGISTRY.gauge(
    "sharding_train_state_bytes",
    "per-device bytes of sharded-training state by kind (param | grad "
    "| moment); published on each full placement pass (restage — a "
    "warmup-time event) and retired when the layout is torn down.  "
    "Grad bytes are accounted at the param's placement: one grad per "
    "trainable param, layout pinned to the param's by the update's "
    "out sharding.  Scope: ONE sharded-training layout per process — "
    "publish is last-writer-wins and retire is global (kind is the "
    "only label; a training process hosts one trainer)", ("kind",))
