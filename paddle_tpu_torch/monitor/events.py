"""Bounded, severity-tagged operational event ring — the ``/eventz``
surface.

Metrics say *how much*; traces say *where the time went*; this ring says
*what happened*: brownout level transitions, backend retirements and
readmissions, prefix-cache fallbacks, SLO alerts firing and clearing.
Every notable-but-rare state change lands here as one small dict, in a
drop-oldest ring bounded at construction, so the last N operational
events of a process are always one ``/eventz`` GET away — on a child
server directly, or merged across a fleet by the balancer's federated
``/eventz``.

``emit()`` is the single producer call site.  It does three things:

* appends the event to the installed ring (a process-default ring is
  always present — emitting never requires setup);
* increments ``serving_events_total{severity}`` so dashboards can rate
  and alert on event volume without parsing the ring;
* forwards to ``spans.record_instant`` so the span-stream instants that
  previously lived at these call sites stay intact — an active trace
  session still sees the same markers, now with a ``severity`` arg.

Events are deliberately cheap and rare (state *transitions*, not
per-request traffic) — ``emit`` must never appear on a request hot path
(``tools/check_hot_path.py`` enforces this statically).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional

from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.monitor.registry import REGISTRY

__all__ = [
    "SEVERITIES", "EventRing", "emit", "eventz", "install", "get",
    "uninstall",
]

# ordered least -> most severe; emit() rejects anything else
SEVERITIES = ("info", "warning", "error", "critical")

_EVENTS_TOTAL = REGISTRY.counter(
    "serving_events_total",
    "operational events appended to the /eventz ring, by severity",
    ("severity",))

_DEFAULT_CAPACITY = 512


class EventRing:
    """Drop-oldest ring of operational events.

    Each record: ``{"seq", "ts", "kind", "severity", "message", ...attrs}``
    — ``seq`` is a process-unique monotonic id (merge/dedup key for
    federation), ``ts`` wall-clock seconds, ``kind`` a slash-scoped name
    (``serving/brownout``, ``wire/backend_retired``, ``slo/fired``)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        if int(capacity) < 1:
            raise ValueError("capacity must be >= 1 (got %r)" % (capacity,))
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, object]] = collections.deque(
            maxlen=self.capacity)
        self._dropped = 0
        self._seq = itertools.count()

    # ------------------------------------------------------------------
    def emit(self, kind: str, severity: str = "info",
             message: str = "", **attrs) -> Dict[str, object]:
        """Append one event; returns the stored record."""
        if severity not in SEVERITIES:
            raise ValueError("unknown severity %r (want one of %s)"
                             % (severity, ", ".join(SEVERITIES)))
        rec: Dict[str, object] = {
            "ts": time.time(),
            "kind": str(kind),
            "severity": severity,
        }
        if message:
            rec["message"] = str(message)
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            rec["seq"] = next(self._seq)
            if len(self._ring) == self.capacity:
                self._dropped += 1
            self._ring.append(rec)
        _EVENTS_TOTAL.labels(severity=severity).inc()
        return rec

    # ------------------------------------------------------------------
    def snapshot(self, limit: Optional[int] = None,
                 min_severity: Optional[str] = None
                 ) -> List[Dict[str, object]]:
        """Events oldest -> newest; ``limit`` keeps the newest N,
        ``min_severity`` filters below the given level."""
        with self._lock:
            out = list(self._ring)
        if min_severity is not None:
            floor = SEVERITIES.index(min_severity)
            out = [e for e in out
                   if SEVERITIES.index(e["severity"]) >= floor]
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def eventz(self, limit: Optional[int] = None) -> Dict[str, object]:
        """The ``/eventz`` document."""
        events = self.snapshot(limit=limit)
        return {
            "capacity": self.capacity,
            "dropped": self.dropped,
            "retained": len(events),
            "events": events,
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._dropped = 0


# ---------------------------------------------------------------------------
# module slot — a default ring is always installed, so call sites emit
# unconditionally (mirrors flight.py's install/get, minus the None state)
# ---------------------------------------------------------------------------
_default_ring = EventRing()
_ring: EventRing = _default_ring
_slot_lock = threading.Lock()


def install(capacity: int = _DEFAULT_CAPACITY) -> EventRing:
    """Replace the process event ring (e.g. to size it); returns the new
    ring.  Events already in the old ring are not carried over."""
    global _ring
    ring = EventRing(capacity)
    with _slot_lock:
        _ring = ring
    return ring


def get() -> EventRing:
    """The process event ring (always present)."""
    return _ring


def uninstall() -> None:
    """Restore the process-default ring."""
    global _ring
    with _slot_lock:
        _ring = _default_ring


def emit(kind: str, severity: str = "info", message: str = "",
         cat: str = "event", **attrs) -> Dict[str, object]:
    """Append one operational event to the process ring, count it under
    ``serving_events_total{severity}``, and mirror it into any active
    span stream as an instant (the pre-ring behavior of these sites)."""
    rec = _ring.emit(kind, severity=severity, message=message, **attrs)
    # keep the span-stream instants intact: a live trace session sees
    # the same marker the ring stored (record_instant no-ops otherwise)
    _spans.record_instant(kind, cat=cat, severity=severity, **attrs)
    return rec


def eventz(limit: Optional[int] = None) -> Dict[str, object]:
    """The process ring's ``/eventz`` document."""
    return _ring.eventz(limit=limit)
