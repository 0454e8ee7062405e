"""Profiler (reference: python/paddle/fluid/profiler.py:39-225 +
platform/profiler.cc RecordEvent / CUPTI DeviceTracer).

Port of the JAX package's ``profiler.py``.  Device-side tracing is
``torch.profiler`` (Kineto over CUPTI: the card's kernels, graph replays
included, and the host's ops), exported as Chrome trace-event JSON into
the trace dir; host-side per-run timing is recorded by this module.
PyTorch allows one active profiler, so a second start (or a reset)
stops the trace this module started first.

Time alignment: just after the trace starts, ``start_profiler`` records
one ``record_function`` marker (``ANCHOR_EVENT``) bracketed by two reads
of the wall clock.  The marker's timestamp in the exported trace and the
bracket's midpoint tie the trace's clock to the host spans' wall clock;
half the bracket is the alignment's reading error
(``monitor.export_chrome_trace`` uses and records it).
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

from paddle_tpu_torch.monitor import spans as _mon_spans

__all__ = [
    "profiler", "start_profiler", "stop_profiler", "reset_profiler",
    "RecordEvent", "cuda_profiler", "start_jsonl_trace", "stop_jsonl_trace",
    "emit_trace_event", "jsonl_trace", "last_device_trace", "last_device_marker",
]

_host_events: Dict[str, List[float]] = defaultdict(list)
_active_trace_dir: Optional[str] = None
_active_trace_anchor: Optional[float] = None  # wall clock at start_trace
_active_profile = None  # the running torch.profiler.profile
_active_marker: Optional[tuple] = None  # (wall at the anchor marker, its reading error)
_last_trace: Optional[tuple] = None  # (dir, anchor) of the last finished trace
_last_marker: Optional[tuple] = None  # (dir, marker wall, reading error, trace file)

ANCHOR_EVENT = "paddle_tpu_torch/profiler_anchor"
_ERROR_SUFFIX = " (error)"  # table key for spans that exited via exception


class RecordEvent:
    """Host-side RAII timing marker (reference: profiler.h:81).

    Context manager OR decorator::

        with RecordEvent("step"): ...

        @RecordEvent("step")
        def step(...): ...

    Spans that exit via exception aggregate under ``"<name> (error)"``
    in the stop_profiler() table and carry ``error=True`` in any active
    monitor trace session, so failed runs are distinguishable.
    """

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        # a FRESH instance per invocation: the decorated function may be
        # reentrant or called from several threads, and _t0 lives on self
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)

        return wrapper

    def __enter__(self):
        self._t0 = time.perf_counter()
        # own span id on the parent stack while the body runs: spans
        # recorded inside (predictor hop, executor phases) nest under
        # this block with a real parent edge
        self._sid = (
            _mon_spans.push_parent() if _mon_spans.recording() else None)
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        error = exc_type is not None
        _host_events[self.name + _ERROR_SUFFIX if error else self.name].append(dur)
        if self._sid is not None:
            _mon_spans.pop_parent()
        _mon_spans.record_span(
            self.name, self._t0, dur, cat="record_event", error=error,
            span_id=self._sid)
        return False


def _warm_device_trace(torch) -> None:
    """Launch and wait for a few hundred tiny kernels: on an H100 a trace
    started late in a long process lost kernel records at its start (one
    of its first step's attention kernels); these take that loss instead
    of the caller's."""
    w = torch.zeros(32, device="cuda")
    for _ in range(256):
        w.add_(1.0)
    torch.cuda.synchronize()


def start_profiler(state: str = "All", trace_dir: Optional[str] = None):
    """reference: profiler.py start_profiler / EnableProfiler.

    Idempotent: a second start (or a start after a crashed run) first
    stops any device trace this module previously started (via
    reset_profiler), so torch.profiler never sees two active profilers.
    ``trace_dir``: record the card's kernels and the host's ops with
    ``torch.profiler`` (the CPU alone where there is no card) and write
    them there as ``<name>.trace.json`` at ``stop_profiler``.
    """
    global _active_trace_dir, _active_trace_anchor, _active_profile, _active_marker
    reset_profiler()
    if trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # exception-safe: _active_trace_dir is only set AFTER the trace
        # actually started, so a failed start leaves no dangling state
        # for stop_profiler()/reset_profiler() to trip over
        prof = profile(activities=activities)
        anchor = time.time()
        prof.start()
        if ProfilerActivity.CUDA in activities:
            _warm_device_trace(torch)
        with torch.profiler.record_function(ANCHOR_EVENT + "_warmup"):
            pass  # the first annotation pays the profiler's set-up; the anchor does not
        t_before = time.time()
        with torch.profiler.record_function(ANCHOR_EVENT):
            pass
        t_after = time.time()
        _active_profile = prof
        _active_marker = ((t_before + t_after) / 2, (t_after - t_before) / 2)
        _active_trace_dir = trace_dir
        _active_trace_anchor = anchor


def _finish_trace(export: bool) -> None:
    """Stop the running device trace (export it when asked) and move its
    bookkeeping to ``_last_trace``; never raises over a half-dead trace
    when not exporting."""
    global _active_trace_dir, _active_trace_anchor, _active_profile, _active_marker
    global _last_trace, _last_marker
    prof, trace_dir, marker = _active_profile, _active_trace_dir, _active_marker
    _last_trace = (_active_trace_dir, _active_trace_anchor)
    _active_trace_dir = _active_trace_anchor = _active_profile = _active_marker = None
    try:
        prof.stop()
    except Exception:
        if export:
            raise
        return
    if export:
        path = os.path.join(trace_dir, "paddle_tpu_torch.%d.%d.trace.json"
                            % (os.getpid(), time.time_ns()))
        prof.export_chrome_trace(path)
        _last_marker = (trace_dir, marker[0], marker[1], path)


def stop_profiler(sorted_key: str = "total", profile_path: Optional[str] = None):
    """reference: profiler.py stop_profiler — prints the per-event table."""
    if _active_trace_dir is not None:
        _finish_trace(export=True)
    rows = []
    for name, ts in _host_events.items():
        rows.append((name, len(ts), sum(ts), max(ts), sum(ts) / len(ts)))
    key_idx = {"total": 2, "max": 3, "ave": 4, "calls": 1}.get(sorted_key, 2)
    rows.sort(key=lambda r: r[key_idx], reverse=True)
    lines = ["%-40s %8s %12s %12s %12s" % ("Event", "Calls", "Total(s)", "Max(s)", "Ave(s)")]
    for name, calls, total, mx, ave in rows:
        lines.append("%-40s %8d %12.6f %12.6f %12.6f" % (name, calls, total, mx, ave))
    report = "\n".join(lines)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report)
    else:
        print(report)
    return rows


def reset_profiler():
    """Clear host events AND stop any device trace this module started
    (without writing it).  Reset owns the whole teardown, so start and
    reset are idempotent and exception-safe."""
    _host_events.clear()
    if _active_trace_dir is not None:
        _finish_trace(export=False)


def last_device_marker() -> Optional[tuple]:
    """``(trace_dir, marker_wall, reading_error_s, trace_file)`` of the
    last exported trace: the wall-clock time of its ``ANCHOR_EVENT``
    marker and half the bracket it was read in."""
    return _last_marker


def last_device_trace() -> Optional[tuple]:
    """``(trace_dir, wall_anchor)`` for the most recently finished
    torch.profiler trace this module started (``wall_anchor``: the wall
    clock read just before it started) — the time-alignment hint
    ``monitor.export_chrome_trace(device_trace_dir=...)`` consumes.
    The running trace is reported too (export-while-tracing reads a
    partial dir, which the loader tolerates)."""
    if _active_trace_dir is not None:
        return (_active_trace_dir, _active_trace_anchor)
    return _last_trace


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None, trace_dir: Optional[str] = None):
    """reference: profiler.py:127 context manager."""
    start_profiler(state, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


# ---------------------------------------------------------------------------
# JSONL event trace — one JSON object per line, for host-side subsystems
# that emit discrete events rather than RAII spans (serving batches, reader
# stalls, PS rounds).  Complements RecordEvent: RecordEvent aggregates into
# the stop_profiler() table, the JSONL sink keeps every event with its
# wall-clock timestamp so latency tails and occupancy histograms can be
# reconstructed offline.
# ---------------------------------------------------------------------------
_jsonl_sink = None  # (path, file handle, lock)


def start_jsonl_trace(path: str):
    """Open ``path`` and route emit_trace_event() lines to it (append
    mode, one JSON object per line).  Returns the path."""
    global _jsonl_sink
    import threading

    stop_jsonl_trace()
    _jsonl_sink = (path, open(path, "a"), threading.Lock())
    return path


def stop_jsonl_trace() -> Optional[str]:
    """Close the active JSONL sink; returns its path (or None)."""
    global _jsonl_sink
    if _jsonl_sink is None:
        return None
    path, fh, lock = _jsonl_sink
    _jsonl_sink = None
    with lock:
        fh.close()
    return path


def emit_trace_event(event: dict) -> None:
    """Write one event to the active JSONL sink (no-op when none is
    active).  A wall-clock ``ts`` field is stamped in unless the caller
    already provided one; the event must be JSON-serializable."""
    sink = _jsonl_sink
    if sink is None:
        return
    import json

    _, fh, lock = sink
    rec = dict(event)
    rec.setdefault("ts", time.time())
    line = json.dumps(rec)
    with lock:
        if not fh.closed:
            fh.write(line + "\n")
            fh.flush()


@contextlib.contextmanager
def jsonl_trace(path: str):
    """Context manager form of start/stop_jsonl_trace."""
    start_jsonl_trace(path)
    try:
        yield path
    finally:
        stop_jsonl_trace()


@contextlib.contextmanager
def cuda_profiler(*a, **k):
    """Legacy nvprof hook (reference: profiler.py:39) — device tracing
    goes through torch.profiler (``start_profiler(trace_dir=)``); kept as
    a no-op alias."""
    yield
