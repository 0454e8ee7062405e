"""Robustness metrics (process-global registry, always on).

The port's copy of the JAX package's ``faults/metrics.py``.

The counters every fault-tolerance mechanism reports through: armed
fault points count their injections here, ``RetryPolicy`` counts every
granted retry, the half-open circuit breakers (wire fleet backends AND
in-process serving replicas — the shared ``pool`` label distinguishes
them) count their probe admissions, and the training checkpointer
counts completed atomic saves.  ``paddle_tpu_torch.tools.check_metrics_docs``
holds the README table to this set like every other metrics module.
"""
from __future__ import annotations

from paddle_tpu_torch.monitor import registry as _registry

__all__ = [
    "FAULTS_INJECTED", "RETRY_ATTEMPTS",
    "BACKEND_HALFOPEN_PROBES", "TRAIN_CHECKPOINTS",
    "TRAIN_CHECKPOINT_RESTORES", "TRAIN_CHECKPOINT_FALLBACKS",
    "TRAIN_CHECKPOINT_CORRUPTION", "TRAIN_CHECKPOINT_BYTES",
]

FAULTS_INJECTED = _registry.REGISTRY.counter(
    "faults_injected_total",
    "fault-point triggers that actually fired an armed injection "
    "(point=<faultpoint name>)", ("point",))
RETRY_ATTEMPTS = _registry.REGISTRY.counter(
    "retry_attempts_total",
    "retries granted by a RetryPolicy budget, after the backoff sleep "
    "(op=<call site>)", ("op",))
BACKEND_HALFOPEN_PROBES = _registry.REGISTRY.counter(
    "backend_halfopen_probes_total",
    "half-open circuit-breaker probes: a retired backend/replica "
    "admitted one trial after its cooldown (pool=<fleet or server>)",
    ("pool",))
TRAIN_CHECKPOINTS = _registry.REGISTRY.counter(
    "train_checkpoints_total",
    "training checkpoints committed (atomic tmp+rename completed)")
TRAIN_CHECKPOINT_RESTORES = _registry.REGISTRY.counter(
    "train_checkpoint_restore_total",
    "checkpoints successfully restored (integrity-verified; cross-mesh "
    "shard-exchange restores count here too)")
TRAIN_CHECKPOINT_FALLBACKS = _registry.REGISTRY.counter(
    "train_checkpoint_fallback_total",
    "restore fell back past a checkpoint it could not use (corrupt, "
    "truncated, or a dangling LATEST pointer) to an older complete one "
    "— counted per checkpoint skipped, never silent")
TRAIN_CHECKPOINT_CORRUPTION = _registry.REGISTRY.counter(
    "train_checkpoint_corruption_total",
    "checkpoints that failed integrity verification at restore "
    "(content-hash mismatch, truncated or missing files)")
TRAIN_CHECKPOINT_BYTES = _registry.REGISTRY.gauge(
    "train_checkpoint_bytes",
    "total on-disk bytes of the last committed training checkpoint "
    "(every file the integrity manifest covers)")
