"""Host-side span recording for run-phase tracing.

Instrumentation sites (Executor.run phases, lowering, RecordEvent) call
``record_span`` unconditionally; it is a no-op unless a recording session
is active, and hot paths that want to skip even the timestamp read gate
on the module flag directly::

    rec = spans.recording()
    if rec:
        t0 = time.perf_counter()
    ...work...
    if rec:
        spans.record_span("executor/h2d_feed", t0,
                          time.perf_counter() - t0, cat="transfer")

Spans carry a wall-clock start (mapped from perf_counter through the
session epoch, so they merge cleanly with the profiler's JSONL events,
which stamp ``time.time()``), a duration in seconds, the recording
thread id, a category, an optional ``error`` flag, and free-form args.
``chrome_trace.export_chrome_trace`` turns them into trace-event JSON.

Request attribution (trace-id propagation): a thread that is serving a
specific request (or batch of requests) installs a *trace context* —
``with spans.trace_context(ids):`` — and every span the thread records
while inside it carries ``trace_ids``, so a merged Chrome trace (and the
flight recorder) can attribute queue-wait / h2d / execute / d2h spans to
the exact requests in flight.  Orthogonally, ``spans.capture(buf)``
installs a thread-local side buffer: spans recorded by the thread are
ALSO appended to ``buf`` even when no global session is active — the
flight recorder's per-batch collection mechanism.  ``recording()``
reports True when either sink is live, so hot-path gates stay a single
call.

Span hierarchy (parent ids): every recorded span carries a fresh 16-hex
``id``, and a ``parent`` id when one is known — no longer inferred from
timestamps.  Enclosing-span call sites push their own id onto a
thread-local parent stack while their body runs (``parent_scope()`` /
``push_parent``+``pop_parent``), so nested spans record a real edge; a
span recorded after-the-fact picks up ``current_parent()``.  The stack
also accepts a FOREIGN id — a wire server pushes the remote parent
parsed from the request's W3C ``traceparent`` header, so a
cross-process span tree keeps one connected hierarchy per trace id.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
import uuid
from typing import Deque, Dict, List, Optional, Sequence

__all__ = [
    "recording", "start_recording", "stop_recording", "record_span",
    "record_instant", "span", "session_dropped", "dropped_total",
    "trace_context", "current_trace_ids", "capture",
    "set_thread_lane", "thread_lanes",
    "new_span_id", "push_parent", "pop_parent", "current_parent",
    "parent_scope",
]

_enabled = False
_lock = threading.Lock()
_buffer: Deque[Dict[str, object]] = collections.deque()
_max_spans: Optional[int] = None  # ring-buffer capacity; None = unbounded
_dropped = 0        # spans dropped by the ring in the current/last session
_dropped_total = 0  # process-lifetime drop total (registry exposition)
_epoch_pc = 0.0    # perf_counter at session start
_epoch_wall = 0.0  # time.time at session start

# process-lifetime perf_counter->wall anchor for spans recorded OUTSIDE
# a session (flight-recorder captures have no session epoch to map
# through; drift over a process lifetime is irrelevant at trace-viewer
# resolution)
_anchor_pc = time.perf_counter()
_anchor_wall = time.time()

_tls = threading.local()  # .trace_ids (tuple) / .capture (list)

# tid -> human lane name for the Chrome-trace export (replica workers,
# dispatcher, prefetch producers register here so the fleet renders as
# named parallel tracks)
_thread_lanes: Dict[int, str] = {}


def recording() -> bool:
    """True while a span sink is live for the calling thread: a global
    trace session, or a thread-local flight-recorder capture."""
    return _enabled or getattr(_tls, "capture", None) is not None


def start_recording(max_spans: Optional[int] = None) -> None:
    """Begin a session: clears the buffer, re-anchors the epoch.

    ``max_spans`` turns the buffer into a drop-oldest ring, so an
    always-on production session holds the LAST N spans instead of
    growing an unbounded list; drops are counted (``session_dropped`` /
    the ``trace_dropped_spans_total`` registry counter).

    Sessions are process-global and do NOT nest: starting a new one
    supersedes (and discards the buffered spans of) any active session,
    and the superseded ``trace_session`` will export empty.  One trace
    session at a time is the contract."""
    global _enabled, _epoch_pc, _epoch_wall, _max_spans, _dropped
    if max_spans is not None and int(max_spans) < 1:
        raise ValueError("max_spans must be >= 1 (got %r)" % (max_spans,))
    with _lock:
        _buffer.clear()
        _max_spans = int(max_spans) if max_spans is not None else None
        _dropped = 0
        _epoch_pc = time.perf_counter()
        _epoch_wall = time.time()
        _enabled = True


def stop_recording() -> List[Dict[str, object]]:
    """End the session; returns (and drains) the recorded spans.  With a
    ring-buffer session these are the LAST ``max_spans`` recorded —
    ``session_dropped()`` says how many older ones fell off."""
    global _enabled
    with _lock:
        _enabled = False
        out = list(_buffer)
        _buffer.clear()
    return out


def session_dropped() -> int:
    """Spans dropped by the ring buffer in the current (or, after
    ``stop_recording``, the most recent) session."""
    return _dropped


def dropped_total() -> int:
    """Process-lifetime ring-buffer drop total (monotonic; backs the
    ``trace_dropped_spans_total`` registry counter)."""
    return _dropped_total


def record_span(name: str, t0: float, dur: float, cat: str = "host",
                error: bool = False, span_id: Optional[str] = None,
                parent: Optional[str] = None, **args) -> None:
    """Record one completed span.  ``t0`` is the perf_counter value at
    span start, ``dur`` the duration in seconds.  No-op when neither a
    session nor a thread-local capture is active.

    ``span_id`` pins the span's id (an enclosing call site that pushed
    the id onto the parent stack while its body ran passes it here);
    omitted, a fresh id is minted.  ``parent`` pins the parent edge;
    omitted, the thread's current parent-stack top (if any) is used."""
    cap = getattr(_tls, "capture", None)
    if not _enabled and cap is None:
        return
    rec: Dict[str, object] = {
        "name": name,
        "cat": cat,
        "dur": float(dur),
        "tid": threading.get_ident(),
        "id": span_id or new_span_id(),
    }
    if parent is None:
        parent = current_parent()
    if parent:
        rec["parent"] = parent
    if error:
        rec["error"] = True
    ids = getattr(_tls, "trace_ids", None)
    if ids:
        rec["trace_ids"] = list(ids)
    if args:
        rec["args"] = args
    if cap is not None:
        # capture-only spans map through the process anchor (no session
        # epoch may exist); when a session IS live the dict is shared, so
        # the session's epoch-mapped ts below overwrites this one
        rec["ts"] = _anchor_wall + (t0 - _anchor_pc)
        cap.append(rec)
    if not _enabled:
        return
    global _dropped, _dropped_total
    with _lock:
        if _enabled:
            # epoch read under the lock: a concurrent start_recording
            # re-anchors both epochs atomically, so the ts can never mix
            # an old perf_counter anchor with a new wall anchor
            rec["ts"] = _epoch_wall + (t0 - _epoch_pc)  # wall-clock seconds
            if _max_spans is not None and len(_buffer) >= _max_spans:
                _buffer.popleft()  # drop-oldest ring
                _dropped += 1
                _dropped_total += 1
            _buffer.append(rec)


def record_instant(name: str, cat: str = "host", **args) -> None:
    """Record a zero-duration marker event."""
    if not recording():
        return
    record_span(name, time.perf_counter(), 0.0, cat=cat, instant=True, **args)


@contextlib.contextmanager
def span(name: str, cat: str = "host", **args):
    """Context-manager form; spans that exit via exception are flagged
    ``error=True``.  Near-zero-cost when no session is active.

    The span's id is pushed onto the parent stack while the body runs,
    so spans recorded inside nest under it (a real parent edge, not a
    timestamp guess)."""
    if not recording():
        yield
        return
    t0 = time.perf_counter()
    sid = push_parent()
    err = False
    try:
        yield
    except BaseException:
        err = True
        raise
    finally:
        pop_parent()
        record_span(name, t0, time.perf_counter() - t0, cat=cat, error=err,
                    span_id=sid, **args)


# ---------------------------------------------------------------------------
# request attribution: trace context + capture buffers + thread lanes
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def trace_context(trace_ids: Optional[Sequence[str]]):
    """Attribute every span this thread records inside the block to the
    given request trace ids (None/empty = no-op).  Nested contexts
    shadow; the previous context is restored on exit."""
    ids = tuple(i for i in (trace_ids or ()) if i)
    if not ids:
        yield
        return
    prev = getattr(_tls, "trace_ids", None)
    _tls.trace_ids = ids
    try:
        yield
    finally:
        _tls.trace_ids = prev


def current_trace_ids() -> tuple:
    """The calling thread's active trace ids (empty tuple outside any
    ``trace_context``)."""
    return getattr(_tls, "trace_ids", None) or ()


# ---------------------------------------------------------------------------
# span hierarchy: per-thread parent stack
# ---------------------------------------------------------------------------
def new_span_id() -> str:
    """Mint a 16-hex span id (same shape as a trace id, distinct space)."""
    return uuid.uuid4().hex[:16]


def push_parent(span_id: Optional[str] = None) -> str:
    """Push a span id onto the calling thread's parent stack (minting a
    fresh one when omitted) and return it.  Spans the thread records
    while it is on top carry it as ``parent``.  Pushing a FOREIGN id
    (e.g. the remote parent from a wire request's ``traceparent``
    header) grafts this thread's spans under a span recorded elsewhere."""
    sid = span_id or new_span_id()
    stack = getattr(_tls, "parents", None)
    if stack is None:
        stack = _tls.parents = []
    stack.append(sid)
    return sid


def pop_parent() -> None:
    stack = getattr(_tls, "parents", None)
    if stack:
        stack.pop()


def current_parent() -> Optional[str]:
    """The calling thread's innermost open parent span id, or None."""
    stack = getattr(_tls, "parents", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def parent_scope(span_id: Optional[str] = None):
    """Context-manager form of ``push_parent``/``pop_parent``; yields
    the pushed id.  The caller that OWNS the enclosing span records it
    afterwards via ``record_span(..., span_id=<yielded id>)``; a caller
    grafting under a remote/foreign parent just passes that id."""
    sid = push_parent(span_id)
    try:
        yield sid
    finally:
        pop_parent()


@contextlib.contextmanager
def capture(buf: List[Dict[str, object]]):
    """Thread-local span side-sink: spans recorded by this thread inside
    the block are appended to ``buf`` — independent of (and in addition
    to) any global trace session.  The flight recorder wraps each batch
    execution in one of these; nesting shadows (innermost wins)."""
    prev = getattr(_tls, "capture", None)
    _tls.capture = buf
    try:
        yield buf
    finally:
        _tls.capture = prev


def wall_ts(t0: float) -> float:
    """Map a ``time.perf_counter()`` reading to wall-clock seconds via
    the process anchor (the timebase capture-mode spans use)."""
    return _anchor_wall + (t0 - _anchor_pc)


def set_thread_lane(name: str) -> None:
    """Name the calling thread's lane in Chrome-trace exports (replica
    workers, dispatchers, prefetch producers).

    Registrations deliberately outlive the thread: exports usually run
    AFTER the server stopped, and the spans its dead workers recorded
    must still carry their lane names.  The costs are bounded and
    cosmetic — one small dict entry per named thread ever created, and
    a later unnamed thread that reuses a dead thread's OS id inherits
    its label until it registers its own (latest registration wins)."""
    _thread_lanes[threading.get_ident()] = str(name)


def thread_lanes() -> Dict[int, str]:
    """Snapshot of tid -> lane-name registrations."""
    return dict(_thread_lanes)
