"""Tail-sampled per-request flight recorder.

Dapper-style tail sampling for the serving stack: every request gets a
trace id and its spans are *collected* per batch, but full span trees
are *retained* only for the requests worth keeping — slow (latency over
``slow_ms``), errored, or deadline-missed — in a bounded drop-oldest
ring.  That inverts head sampling's blind spot: the p99 request is
exactly the one whose trace survives.

Lifecycle::

    rec = monitor.flight_recorder(capacity=256, slow_ms=50)
    ...serve traffic...              # slow/errored requests accumulate
    rec.snapshot()                   # JSON-ready records, newest first
    rec.export_chrome_trace("slow_requests.json")
    rec.close()                      # uninstall (idempotent)

The recorder is process-global (one per process, like the metrics
registry): the serving server consults ``flight.get()`` per batch and
pays a single ``is None`` check when no recorder is installed — the
idle hot path stays inside the asserted <1% instrumentation bound.
While a recorder IS installed, each batch execution runs under a
``spans.capture()`` buffer, so executor run-phase spans (h2d /
device_execute / d2h), serving spans (queue wait, dispatch,
materialize), and the client span all land in the retained record with
their ``trace_ids`` attribution.

``/tracez`` (serving admin endpoint) serves ``snapshot()`` over HTTP.
"""
from __future__ import annotations

import collections
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.monitor import registry as _registry

__all__ = [
    "FlightRecorder", "new_trace_id", "install", "get", "uninstall",
    "span_tree",
]

# retention accounting: requests seen vs kept vs pushed off the ring —
# the knob-tuning signal (an evicted_total climbing fast means slow_ms
# is too low for the traffic, or capacity too small for the tail).
_MON_CONSIDERED = _registry.REGISTRY.counter(
    "flight_requests_considered_total",
    "requests the flight recorder saw (recorder installed)")
_MON_RETAINED = _registry.REGISTRY.counter(
    "flight_requests_retained_total",
    "requests retained by tail sampling (slow/errored/deadline-missed)")
_MON_EVICTED = _registry.REGISTRY.counter(
    "flight_requests_evicted_total",
    "retained requests pushed off the bounded ring (drop-oldest)")


def new_trace_id() -> str:
    """Mint a 16-hex-char request trace id (Dapper-style)."""
    return uuid.uuid4().hex[:16]


def span_tree(spans: Sequence[Dict]) -> List[Dict]:
    """Build the real hierarchy from a record's span dicts via their
    explicit ``id``/``parent`` edges (no timestamp inference): returns a
    forest of ``{"name", "span_id", "dur_ms", "children": [...]}`` nodes,
    roots first by start time.  A span whose parent is not in the set
    (e.g. the remote parent lives in another process's record half)
    roots its own subtree.  Parent cycles are broken by promoting one
    member per cycle to a root (its back-edge cut), so every span always
    appears exactly once and the forest stays JSON-serializable."""
    nodes, order = {}, []
    for s in spans:
        sid = s.get("id")
        node = {
            "name": s.get("name"),
            "span_id": sid,
            "parent_id": s.get("parent"),
            "dur_ms": round(float(s.get("dur", 0.0)) * 1e3, 3),
            "children": [],
        }
        if s.get("error"):
            node["error"] = True
        order.append(node)
        if sid and sid not in nodes:
            nodes[sid] = node
    roots = []
    parent_of = {}
    for node in order:
        parent = nodes.get(node.pop("parent_id", None))
        if parent is None or parent is node:
            roots.append(node)
        else:
            parent["children"].append(node)
            parent_of[id(node)] = parent

    def _mark(start, seen):
        stack = [start]
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            stack.extend(n["children"])

    # parent CYCLES in foreign span dicts (a malformed peer) would leave
    # every cycle member a child of another member — unreachable from
    # any root.  Promote one entry node per unreachable component,
    # CUTTING its back-edge (or the forest would be circular and refuse
    # to serialize), so the result really degrades to roots instead of
    # dropping spans.
    reachable = set()
    for r in roots:
        _mark(r, reachable)
    for node in order:
        if id(node) not in reachable:
            parent_of[id(node)]["children"].remove(node)
            roots.append(node)
            _mark(node, reachable)
    return roots


class FlightRecorder:
    """Bounded ring of retained request records.

    A record is a plain JSON-ready dict::

        {"trace_id": ..., "status": "ok"|"error"|"deadline",
         "latency_ms": ..., "ts": <wall seconds at completion>,
         "spans": [span dicts incl. trace_ids], ...extra}

    ``consider()`` applies the tail-sampling policy; ``add_span()``
    appends late spans (the client-side span closes after the server
    retained the record).  All methods are thread-safe.
    """

    def __init__(self, capacity: int = 256, slow_ms: float = 50.0):
        if int(capacity) < 1:
            raise ValueError("capacity must be >= 1 (got %r)" % (capacity,))
        self.capacity = int(capacity)
        self.slow_ms = float(slow_ms)
        self._lock = threading.Lock()
        self._ring: "collections.OrderedDict[str, Dict]" = \
            collections.OrderedDict()

    # ------------------------------------------------------------------
    def consider(self, trace_id: Optional[str], latency_s: float,
                 status: str = "ok",
                 spans: Optional[Sequence[Dict]] = None,
                 **extra) -> bool:
        """Apply the tail-sampling policy to one completed request;
        returns True when the request's trace was retained.  A request
        already retained (e.g. the server kept it and the client later
        reports a deadline) is MERGED — spans appended, status upgraded
        (ok < deadline < error), latency maxed — never double-counted
        (merges do not touch ``flight_requests_considered_total``, so
        the retained/considered tuning ratio stays per-request)."""
        latency_ms = float(latency_s) * 1e3
        keep = status != "ok" or latency_ms >= self.slow_ms
        with self._lock:
            rec = self._ring.get(trace_id) if trace_id else None
            if rec is not None:
                rec["latency_ms"] = max(rec["latency_ms"], latency_ms)
                rank = {"ok": 0, "deadline": 1, "error": 2}
                if rank.get(status, 0) > rank.get(rec["status"], 0):
                    rec["status"] = status
                if spans:
                    self._merge_spans(rec, spans)
                for k, v in extra.items():
                    rec.setdefault(k, v)
                return True
            _MON_CONSIDERED.inc()
            if not keep:
                return False
            rec = {
                "trace_id": trace_id or new_trace_id(),
                "status": str(status),
                "latency_ms": latency_ms,
                "ts": time.time(),
                "spans": [dict(s) for s in (spans or ())],
            }
            rec.update(extra)
            self._ring[rec["trace_id"]] = rec
            _MON_RETAINED.inc()
            while len(self._ring) > self.capacity:
                self._ring.popitem(last=False)
                _MON_EVICTED.inc()
        return True

    @staticmethod
    def _merge_spans(rec: Dict, spans: Sequence[Dict]) -> None:
        """Append spans, deduplicating by span id: a cross-process merge
        can present the same span twice (e.g. a loopback hop whose
        server half shares this process's recorder — the wire response
        echoes spans the recorder already holds)."""
        have = {s.get("id") for s in rec["spans"] if s.get("id")}
        for s in spans:
            sid = s.get("id")
            if sid and sid in have:
                continue
            if sid:
                have.add(sid)
            rec["spans"].append(dict(s))

    def add_span(self, trace_id: Optional[str], span: Dict) -> bool:
        """Append one span to an already-retained record (no-op — and
        False — when the request wasn't sampled; duplicate span ids are
        merged away)."""
        if not trace_id:
            return False
        with self._lock:
            rec = self._ring.get(trace_id)
            if rec is None:
                return False
            self._merge_spans(rec, (span,))
        return True

    def get_record(self, trace_id: str) -> Optional[Dict]:
        with self._lock:
            rec = self._ring.get(trace_id)
            return dict(rec) if rec is not None else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------------------
    def snapshot(self, limit: Optional[int] = None) -> List[Dict]:
        """Retained records, newest first (JSON-serializable)."""
        with self._lock:
            recs = [dict(r) for r in reversed(self._ring.values())]
        return recs[:limit] if limit is not None else recs

    def statusz(self) -> Dict[str, object]:
        """The ``/tracez`` document: knobs + retained records, each
        carrying its rendered span hierarchy (``tree`` — built from the
        explicit parent ids, so the nesting is real, not inferred)."""
        requests = self.snapshot()
        for rec in requests:
            rec["tree"] = span_tree(rec.get("spans") or ())
        return {
            "capacity": self.capacity,
            "slow_ms": self.slow_ms,
            "retained": len(self),
            "requests": requests,
        }

    def export_chrome_trace(self, path: str, limit: Optional[int] = None,
                            **kw) -> str:
        """Render the retained requests' span trees as one
        Perfetto-loadable trace (``monitor.export_chrome_trace``
        ``requests=`` mode)."""
        from paddle_tpu_torch.monitor.chrome_trace import export_chrome_trace

        return export_chrome_trace(
            path, requests=self.snapshot(limit=limit), **kw)

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Uninstall this recorder from the process slot (records stay
        readable on the handle)."""
        global _recorder
        with _install_lock:
            if _recorder is self:
                _recorder = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# ---------------------------------------------------------------------------
# process-global slot (monitor.flight_recorder installs here; serving
# reads it per batch with one attribute load)
# ---------------------------------------------------------------------------
_install_lock = threading.Lock()
_recorder: Optional[FlightRecorder] = None


def install(capacity: int = 256, slow_ms: float = 50.0) -> FlightRecorder:
    """Install (and return) the process flight recorder, superseding any
    previous one — the ``monitor.flight_recorder()`` entry point."""
    global _recorder
    rec = FlightRecorder(capacity=capacity, slow_ms=slow_ms)
    with _install_lock:
        _recorder = rec
    return rec


def get() -> Optional[FlightRecorder]:
    """The installed recorder, or None (the hot-path gate)."""
    return _recorder


def uninstall() -> None:
    global _recorder
    with _install_lock:
        _recorder = None
