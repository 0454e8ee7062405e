"""Push-gateway exporter: ship the registry to a Prometheus pushgateway.

Batch jobs (bench runs, offline training) finish before any scraper
would pull ``/metrics``; the standard answer is pushing the exposition
to a gateway that holds it for the scraper.  ``monitor.push_gateway(url,
interval_s=30)`` starts a daemon loop PUT-ing the full registry body to
``<url>/metrics/job/<job>`` until ``stop()`` (which pushes one final
snapshot so the terminal state is never lost).

Transport is stdlib urllib — no new dependency — and failures are
counted (``monitor_push_errors_total``) but never raised into the
caller: metrics export must not take the workload down.
"""
from __future__ import annotations

import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from paddle_tpu_torch.monitor import registry as _registry

__all__ = ["PushGateway", "push_gateway"]

_MON_PUSHES = _registry.REGISTRY.counter(
    "monitor_push_total", "successful push-gateway exports")
_MON_PUSH_ERRORS = _registry.REGISTRY.counter(
    "monitor_push_errors_total", "failed push-gateway exports")


class PushGateway:
    """Periodic exporter handle (see module docstring).  Usable as a
    context manager; ``push_now()`` forces an immediate export."""

    def __init__(self, url: str, interval_s: float = 30.0,
                 job: str = "paddle_tpu_torch",
                 registry: Optional[_registry.MetricsRegistry] = None,
                 openmetrics: bool = False, timeout_s: float = 5.0,
                 method: str = "PUT"):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0 (got %r)" % (interval_s,))
        self.url = self._push_url(url, job)
        self.interval_s = float(interval_s)
        self.openmetrics = bool(openmetrics)
        self.timeout_s = float(timeout_s)
        self.method = method
        self._registry = registry if registry is not None else _registry.REGISTRY
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="ptpu-push-gateway", daemon=True)
        self._thread.start()

    @staticmethod
    def _push_url(url: str, job: str) -> str:
        """Pushgateway grouping-key convention: POST/PUT target is
        ``<base>/metrics/job/<job>``; a caller that already encoded the
        full path (any ``/metrics/job/`` segment) is passed through."""
        if "/metrics/job/" in url:
            return url
        return url.rstrip("/") + "/metrics/job/" + urllib.parse.quote(
            job, safe="")

    # ------------------------------------------------------------------
    def push_now(self) -> bool:
        """One export; returns success.  Never raises — failures count
        into ``monitor_push_errors_total``."""
        body, ctype = self._registry.expose(openmetrics=self.openmetrics)
        req = urllib.request.Request(
            self.url, data=body.encode("utf-8"),
            headers={"Content-Type": ctype}, method=self.method)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except Exception:  # noqa: BLE001 — export must not kill the job
            _MON_PUSH_ERRORS.inc()
            return False
        _MON_PUSHES.inc()
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.push_now()

    # ------------------------------------------------------------------
    def stop(self, push_final: bool = True, timeout: float = 10.0) -> None:
        """Stop the loop; by default pushes one final snapshot so the
        job's terminal counters reach the gateway."""
        self._stop.set()
        self._thread.join(timeout)
        if push_final:
            self.push_now()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def push_gateway(url: str, interval_s: float = 30.0, **kw) -> PushGateway:
    """Start a background push loop (the ``monitor.push_gateway`` entry
    point); returns the handle — ``stop()`` it when the job ends."""
    return PushGateway(url, interval_s=interval_s, **kw)
