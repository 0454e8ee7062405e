"""Wire-layer metrics (process-global registry, always on; the port's
copy of the JAX package's ``serving/wire/metrics.py``).

Registered at import like every other subsystem's metrics — the
``/metrics`` exposition of any process that loaded the wire layer
carries them, and ``tools/check_metrics_docs.py`` holds the README
table to this set.

``role`` distinguishes the two ends of the hop: ``client`` series are
stamped by ``RemoteClient``/the fleet balancer, ``server`` series by
``ServingProcess``.  The codec histogram is the wire tax's measured
half: encode/decode seconds per message, labeled by direction.
"""
from __future__ import annotations

from paddle_tpu_torch.monitor import registry as _registry

__all__ = [
    "WIRE_REQUESTS", "WIRE_BYTES_SENT", "WIRE_BYTES_RECEIVED",
    "WIRE_CODEC_SECONDS", "WIRE_BACKEND_RETIRED",
    "WIRE_HEALTH_CHECKS", "WIRE_HEALTH_CHECK_FAILURES",
    "WIRE_BACKEND_RELAUNCHES", "RETRY_THROTTLED",
    "FLEET_AFFINITY_HITS",
    "FEDERATION_SCRAPES", "FEDERATION_STALENESS",
]

WIRE_REQUESTS = _registry.REGISTRY.counter(
    "wire_requests_total",
    "wire RPC exchanges (role=client: sent; role=server: served)",
    ("role",))
WIRE_BYTES_SENT = _registry.REGISTRY.counter(
    "wire_bytes_sent_total",
    "wire message bytes written (bodies, post-codec)", ("role",))
WIRE_BYTES_RECEIVED = _registry.REGISTRY.counter(
    "wire_bytes_received_total",
    "wire message bytes read (bodies, pre-codec)", ("role",))
# codec cost buckets: a wire message should encode/decode in well under
# a millisecond for small feeds — the sub-ms rungs are where the signal
# lives, the tail rungs catch giant-array bodies
WIRE_CODEC_SECONDS = _registry.REGISTRY.histogram(
    "wire_codec_seconds",
    "per-message codec time (op=encode|decode)", ("op",),
    buckets=(1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.025, 0.1, 0.5))
WIRE_BACKEND_RETIRED = _registry.REGISTRY.counter(
    "wire_backend_retired_total",
    "backends the front-end balancer retired from routing "
    "(consecutive request failures or failed health checks)", ("fleet",))
WIRE_HEALTH_CHECKS = _registry.REGISTRY.counter(
    "wire_health_checks_total",
    "balancer /healthz probes issued", ("fleet",))
WIRE_HEALTH_CHECK_FAILURES = _registry.REGISTRY.counter(
    "wire_health_check_failures_total",
    "balancer /healthz probes that failed or timed out", ("fleet",))
WIRE_BACKEND_RELAUNCHES = _registry.REGISTRY.counter(
    "wire_backend_relaunches_total",
    "supervisor relaunch attempts for crashed serving children "
    "(each attempt counts; compare against RelaunchFailed give-ups)",
    ("fleet",))
RETRY_THROTTLED = _registry.REGISTRY.counter(
    "retry_throttled_total",
    "fleet re-dispatches the token-bucket retry throttle denied: the "
    "typed error propagated to the caller instead of amplifying load "
    "on a saturated backend (back-pressure, not a retry storm)",
    ("fleet",))
FEDERATION_SCRAPES = _registry.REGISTRY.counter(
    "wire_federation_scrapes_total",
    "balancer observability scrapes of child admin surfaces "
    "(status=ok|error; one count per backend per scrape pass)",
    ("fleet", "status"))
FEDERATION_STALENESS = _registry.REGISTRY.gauge(
    "wire_federation_staleness_seconds",
    "age of the OLDEST live backend's last successful observability "
    "scrape (worst-case staleness of the balancer's federated view)",
    ("fleet",))
FLEET_AFFINITY_HITS = _registry.REGISTRY.counter(
    "serving_fleet_affinity_hits_total",
    "fleet requests routed to the backend their prompt-prefix hash was "
    "last served by (cache-affinity routing: the hinted backend's "
    "prefix KV cache is warm for this prompt head)", ("fleet",))
