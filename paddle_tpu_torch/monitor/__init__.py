"""paddle_tpu_torch.monitor — framework-wide observability.

The port's copy of the JAX package's ``monitor/``.  The reference
framework's profiler stack (profiler.py + RecordEvent + CUPTI
DeviceTracer + timeline.py) is a first-class subsystem; this is its
counterpart, shared by train, serving, and distributed
paths:

* **Metrics registry** (``registry.py``) — process-global Counter /
  Gauge / Histogram with labels; ``snapshot()`` for programs,
  ``render_text()`` for Prometheus scrapers (the serving ``/metrics``
  endpoint).  Every subsystem registers at import and increments on the
  hot path (a lock + an add; always on).
* **Run-phase spans** (``spans.py``) — Executor.run emits per-phase
  spans (lower / jit_compile on first dispatch per cache key / h2d feed
  transfer / device execute / d2h fetch), RecordEvent blocks mirror in,
  serving batches ride the profiler JSONL stream.  Recording is
  opt-in; when off, instrumentation is a single flag check.
* **Chrome-trace export** (``chrome_trace.py``) — merges spans, the
  JSONL event stream, flight-recorder request trees, AND a
  time-aligned ``torch.profiler`` device timeline into one ``trace.json``
  loadable in chrome://tracing / Perfetto (the ``timeline.py`` analog,
  device lanes included).
* **Request-scoped tracing** (``flight.py`` + span trace contexts) —
  ``new_trace_id()`` / ``trace_context()`` attribute spans to requests;
  ``flight_recorder(capacity, slow_ms)`` tail-samples full span trees
  for slow/errored/deadline-missed requests into a bounded ring served
  by the serving ``/tracez`` endpoint.
* **OpenMetrics + push** (``registry.py`` / ``push.py``) —
  ``expose(openmetrics=True)`` renders OpenMetrics 1.0 with histogram
  exemplars carrying ``trace_id``; ``push_gateway(url, interval_s)``
  ships the registry to a Prometheus pushgateway for batch jobs.

Quickstart::

    from paddle_tpu_torch import monitor, profiler

    with monitor.trace_session(path="trace.json",
                               jsonl_path="events.jsonl") as sess:
        profiler.start_jsonl_trace("events.jsonl")
        ...train / serve...
        profiler.stop_jsonl_trace()
    # trace.json now loads in Perfetto; sess.spans holds the raw spans

    print(monitor.render_text())        # Prometheus exposition
    monitor.snapshot()                  # nested dict of every metric
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional

from paddle_tpu_torch.monitor.registry import (
    DEFAULT_BUCKETS,
    CallbackCounter,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    merge_expositions,
    parse_exposition,
    relabel_exposition,
)
from paddle_tpu_torch.monitor import events as events
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import slo as slo
from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.monitor import train as train
from paddle_tpu_torch.monitor.events import EventRing, eventz
from paddle_tpu_torch.monitor.events import emit as emit_event
from paddle_tpu_torch.monitor.flight import FlightRecorder, new_trace_id
from paddle_tpu_torch.monitor.push import PushGateway, push_gateway
from paddle_tpu_torch.monitor.spans import (
    current_parent,
    current_trace_ids,
    new_span_id,
    parent_scope,
    record_instant,
    record_span,
    recording,
    set_thread_lane,
    span,
    start_recording,
    stop_recording,
    trace_context,
)
from paddle_tpu_torch.monitor.chrome_trace import export_chrome_trace

# ring-buffer sessions (trace_session(max_spans=N)) count what they drop
REGISTRY.counter_callback(
    "trace_dropped_spans_total",
    "spans dropped by ring-buffer trace sessions (drop-oldest)",
    fn=_spans.dropped_total)

__all__ = [
    "Counter", "Gauge", "Histogram", "CallbackCounter", "MetricsRegistry",
    "REGISTRY", "DEFAULT_BUCKETS",
    "counter", "gauge", "histogram", "counter_callback",
    "snapshot", "render_text", "render_openmetrics", "expose",
    "counter_value",
    "span", "record_span", "record_instant", "recording",
    "start_recording", "stop_recording",
    "trace_context", "current_trace_ids", "set_thread_lane",
    "new_span_id", "parent_scope", "current_parent",
    "new_trace_id", "flight_recorder", "FlightRecorder",
    "events", "EventRing", "emit_event", "eventz",
    "slo", "train",
    "parse_exposition", "relabel_exposition", "merge_expositions",
    "push_gateway", "PushGateway",
    "export_chrome_trace", "trace_session", "TraceSession",
]


# -- process-default registry conveniences ------------------------------
def counter(name: str, help: str = "", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames=(),
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets)


def counter_callback(name: str, help: str = "", fn=None) -> CallbackCounter:
    return REGISTRY.counter_callback(name, help, fn)


def snapshot() -> Dict[str, object]:
    return REGISTRY.snapshot()


def render_text() -> str:
    return REGISTRY.render_text()


def render_openmetrics() -> str:
    return REGISTRY.render_openmetrics()


def expose(openmetrics: bool = False):
    """(body, content_type) for a scrape endpoint — Prometheus 0.0.4 or
    OpenMetrics 1.0 with histogram exemplars."""
    return REGISTRY.expose(openmetrics=openmetrics)


def flight_recorder(capacity: int = 256, slow_ms: float = 50.0) -> FlightRecorder:
    """Install the process flight recorder (tail-sampled per-request
    span trees; see ``monitor.flight``).  Returns the handle — usable as
    a context manager; ``close()`` uninstalls."""
    return _flight.install(capacity=capacity, slow_ms=slow_ms)


def counter_value(name: str, default: float = 0.0, **labels) -> float:
    """Sum of the named counter/gauge's series matching the given label
    subset (bench/test convenience)."""
    return REGISTRY.value(name, default, **labels)


# -- trace sessions -----------------------------------------------------
class TraceSession:
    """Handle yielded by ``trace_session``; after the block exits,
    ``spans`` holds the recorded spans (the last ``max_spans`` of them
    in ring-buffer mode, with ``dropped`` counting the rest) and
    ``export`` re-renders them."""

    def __init__(self, path: Optional[str], jsonl_path: Optional[str],
                 device_trace_dir: Optional[str] = None):
        self.path = path
        self.jsonl_path = jsonl_path
        self.device_trace_dir = device_trace_dir
        self.spans: List[Dict[str, object]] = []
        self.dropped = 0

    def export(self, path: Optional[str] = None,
               jsonl_path: Optional[str] = None,
               device_trace_dir: Optional[str] = None) -> str:
        target = path or self.path
        if target is None:
            raise ValueError("no trace path given")
        return export_chrome_trace(
            target, spans=self.spans,
            jsonl_path=jsonl_path or self.jsonl_path,
            device_trace_dir=device_trace_dir or self.device_trace_dir)


@contextlib.contextmanager
def trace_session(path: Optional[str] = None,
                  jsonl_path: Optional[str] = None,
                  max_spans: Optional[int] = None,
                  device_trace_dir: Optional[str] = None):
    """Record spans for the duration of the block; when ``path`` is
    given, write the merged Chrome trace (spans + ``jsonl_path`` +
    ``device_trace_dir``) on exit — including exceptional exit, so a
    failed run still leaves its trace behind.

    ``device_trace_dir``: a ``torch.profiler`` trace dir.  The session
    runs ``profiler.start_profiler(trace_dir=...)`` at its start and
    ``stop_profiler()`` at its end, unless the body stopped (or
    restarted) it itself; the exported device timeline is time-aligned
    and merged into the trace — one file holds host spans AND the
    card's kernel lanes.

    ``max_spans=N`` bounds the buffer to a drop-oldest ring of N spans,
    making always-on production tracing safe: the session keeps the N
    most recent spans and ``sess.dropped`` (plus the registry's
    ``trace_dropped_spans_total``) counts what fell off."""
    start_recording(max_spans=max_spans)
    sess = TraceSession(path, jsonl_path, device_trace_dir)
    if device_trace_dir is not None:
        from paddle_tpu_torch import profiler as _profiler

        _profiler.start_profiler(trace_dir=device_trace_dir)

    def _stop_device_trace():
        if device_trace_dir is not None:
            from paddle_tpu_torch import profiler as _profiler

            last = _profiler.last_device_trace()
            if (last is not None and _profiler._active_trace_dir is not None
                    and os.path.abspath(last[0]) == os.path.abspath(device_trace_dir)):
                _profiler.stop_profiler(profile_path=os.devnull)

    try:
        yield sess
    except BaseException:
        try:
            _stop_device_trace()
        except Exception:
            pass  # never mask the body's exception with a profiler error
        sess.spans = stop_recording()
        sess.dropped = _spans.session_dropped()
        if path is not None:
            try:
                sess.export()
            except Exception:
                pass  # never mask the body's exception with an export error
        raise
    else:
        _stop_device_trace()
        sess.spans = stop_recording()
        sess.dropped = _spans.session_dropped()
        if path is not None:
            sess.export()
