"""Robustness metrics (process-global registry, always on).

The port's own copy of the counter of the JAX package's
``faults/metrics.py`` that ``RetryPolicy`` reports through: every granted
retry increments ``retry_attempts_total{op=...}``.  The fault-injection,
circuit-breaker and checkpoint counters come with the fault points and
checkpoints (ROADMAP A9).
"""
from __future__ import annotations

from paddle_tpu_torch.monitor import registry as _registry

__all__ = ["RETRY_ATTEMPTS"]

RETRY_ATTEMPTS = _registry.REGISTRY.counter(
    "retry_attempts_total",
    "retries granted by a RetryPolicy budget, after the backoff sleep "
    "(op=<call site>)", ("op",))
