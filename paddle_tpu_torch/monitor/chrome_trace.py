"""Chrome trace-event exporter (chrome://tracing / Perfetto).

The port's copy of the JAX package's exporter: the analog of the reference's ``timeline.py`` (which merged
host RecordEvent profiles with CUPTI device records into one trace
file): this merges

* recorded host spans (``monitor.spans`` — Executor run phases,
  lowering, RecordEvent blocks, serving batches, each carrying its
  request ``trace_ids`` when recorded under a trace context),
* the profiler's JSONL event stream (``profiler.emit_trace_event`` —
  discrete events like ``serving.batch`` with a wall ``ts`` and
  optionally a ``run_ms`` duration),
* flight-recorder records (``requests=`` — tail-sampled slow/errored
  request span trees), and
* a ``torch.profiler`` trace directory (``device_trace_dir=`` — the
  trace-event JSON that ``profiler.stop_profiler`` exports there:
  the card's kernels, graph replays included, and the host's ops),
  time-aligned with the host spans,

into a single ``trace.json`` in the trace-event format — client span,
queue wait, batch assembly, executor h2d/execute/d2h, and the
device-side kernel timeline on one scroll, attributable to one trace id.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from paddle_tpu_torch.monitor import spans as _spans

__all__ = ["export_chrome_trace"]

# device-trace events keep their own pid topology (one pid per card and
# per profiled process), offset into a reserved range so they can never
# collide with the exporting host process's pid
_DEVICE_PID_BASE = 1 << 20


def _jsonl_events(path: str) -> List[Dict[str, object]]:
    events = []
    try:
        f = open(path)
    except OSError:
        # the sink may never have been started (e.g. the traced body
        # failed early) — an absent stream must not kill the export
        return events
    with f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except ValueError:
                continue  # a torn tail line must not kill the export
    return events


def _device_trace_file(trace_dir: str) -> Optional[str]:
    """The newest ``*.trace.json`` (or ``.gz``) in ``trace_dir``."""
    cands = (glob.glob(os.path.join(trace_dir, "*.trace.json"))
             + glob.glob(os.path.join(trace_dir, "*.trace.json.gz")))
    return max(cands, key=os.path.getmtime) if cands else None


def _load_device_trace(trace_dir: str) -> Tuple[List[Dict[str, object]], Dict[str, object]]:
    """(trace events, the document's other top-level keys) of the newest
    trace-event JSON that ``torch.profiler``'s ``export_chrome_trace``
    wrote into ``trace_dir``; ([], {}) when there is none or it does not
    parse (never raises — a half-written profile must not kill the
    host-side export)."""
    path = _device_trace_file(trace_dir)
    if path is None:
        return [], {}
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return [], {}
    if isinstance(doc, list):
        return doc, {}
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list):
        return [], {}
    meta = {k: v for k, v in doc.items() if k != "traceEvents"}
    meta["_path"] = path
    return evs, meta


_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the merge's own times in a device event's args, shifted with its ts
_HOST_TIME_ARGS = ("launch_ts", "cupti_ts", "call_ts")
_DEVICE_WORK_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _correlation(ev) -> Optional[object]:
    return (ev.get("args") or {}).get("correlation") if isinstance(ev, dict) else None


def _sync_lateness(device: List[Dict[str, object]]) -> Dict[int, Tuple[float, float]]:
    """{id(copy event): (start of the call that carried it, how long after
    that call returned CUPTI timed the copy's end)} for each copy from the
    device into pageable host memory.  Such a copy returns only after it
    has finished, so a positive lateness is CUPTI's clock drifting from the
    host's: on an H100 it grew to 44 ms within one 6 s trace (about 15 ms a
    second) before CUPTI caught up again."""
    calls: Dict[object, Tuple[float, float]] = {}
    for ev in device:
        if (isinstance(ev, dict) and ev.get("cat") in _LAUNCH_CATS and "ts" in ev
                and "Memcpy" in str(ev.get("name", "")) and _correlation(ev) is not None):
            calls[_correlation(ev)] = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
    out: Dict[int, Tuple[float, float]] = {}
    for ev in device:
        name = str(ev.get("name", "")) if isinstance(ev, dict) else ""
        if ev.get("cat") == "gpu_memcpy" and "DtoH" in name and "Pageable" in name and "ts" in ev:
            call = calls.get(_correlation(ev))
            if call is not None:
                out[id(ev)] = (call[0], float(ev["ts"]) + float(ev.get("dur", 0.0)) - call[1])
    return out


#: the largest shift the merge makes to bring a launch's work to its launch
#: call.  CUPTI's offset drifts by a few ms (a shift repairs that); beyond
#: this the error came with a step of CUPTI's clock inside the launch's own
#: work (on an H100: a 21.9 ms gap between two consecutive kernels of one
#: graph replay, its first 467 kernels timed 21.4 ms before the launch),
#: where shifting the whole launch would throw its correctly timed tail past
#: the step, so such work is left where CUPTI put it, tied to its launch.
MAX_LAUNCH_MOVE_US = 10000.0


def _launch_ordered(device: List[Dict[str, object]]
                    ) -> Tuple[List[Dict[str, object]], Dict[str, object]]:
    """The device events with each launch's device work tied to the launch
    call that issued it, and the merge's statistics (``otherData``):
    launches with device work, launches moved, the largest move in us,
    launches whose work was left early and by how much at most, and the
    largest lateness of a synchronous copy in us.

    CUPTI converts the card's timestamps to the host clock by a model that
    drifts from it by milliseconds either way and can step.  On an H100 a
    graph replay's kernels were timed 1.8 ms before the ``cudaGraphLaunch``
    that issued them (same correlation id); in another trace device work
    was timed up to 44 ms after the return of the synchronous copy that had
    waited for it; in a third the clock stepped inside one replay.  So every work event of a launch carries the launch call's
    host time in ``args["launch_ts"]``, which places it in the host's
    timeline whatever CUPTI's clock says.  Work cannot start before its
    launch call, so the events of a launch timed up to MAX_LAUNCH_MOVE_US
    before it (and its launch-to-kernel flow end) are shifted later by the
    difference, a moved work event keeping CUPTI's own start in
    ``args["cupti_ts"]`` and the shift in ``args["moved_us"]``; work timed
    earlier than that keeps CUPTI's start, with how early it is in
    ``args["cupti_early_us"]``.  Late work is left where CUPTI put it; a
    synchronous copy into pageable memory, which ends before its call
    returns, carries its call's start and CUPTI's lateness past that
    return (``args["call_ts"]``, ``args["cupti_late_us"]``)."""
    launch: Dict[object, float] = {}
    for ev in device:
        if (isinstance(ev, dict) and ev.get("cat") in _LAUNCH_CATS and "ts" in ev
                and "Launch" in str(ev.get("name", "")) and _correlation(ev) is not None):
            launch[_correlation(ev)] = float(ev["ts"])
    first: Dict[object, float] = {}
    for ev in device:
        c = _correlation(ev)
        if c in launch and ev.get("cat") in _DEVICE_WORK_CATS and "ts" in ev:
            first[c] = min(first.get(c, float("inf")), float(ev["ts"]))
    early = {c: launch[c] - t for c, t in first.items() if t < launch[c]}
    shift = {c: d for c, d in early.items() if d <= MAX_LAUNCH_MOVE_US}
    left = {c: d for c, d in early.items() if d > MAX_LAUNCH_MOVE_US}
    synced = _sync_lateness(device)
    out = []
    for ev in device:
        if isinstance(ev, dict) and "ts" in ev:
            c = _correlation(ev)
            if id(ev) in synced:
                call_ts, late = synced[id(ev)]
                ev = dict(ev, args=dict(ev.get("args") or {}, call_ts=call_ts,
                                        cupti_late_us=late))
            elif ev.get("cat") in _DEVICE_WORK_CATS and c in launch:
                args = dict(ev.get("args") or {}, launch_ts=launch[c])
                if c in shift:
                    ev = dict(ev, ts=float(ev["ts"]) + shift[c],
                              args=dict(args, cupti_ts=ev["ts"], moved_us=shift[c]))
                else:
                    if c in left:
                        args["cupti_early_us"] = left[c]
                    ev = dict(ev, args=args)
            elif ev.get("cat") == "ac2g" and ev.get("ph") == "f" and ev.get("id") in shift:
                ev = dict(ev, ts=float(ev["ts"]) + shift[ev.get("id")])
        out.append(ev)
    return out, {"device_launches": len(first), "device_launches_moved": len(shift),
                 "device_largest_move_us": max(shift.values(), default=0.0),
                 "device_launches_left_early": len(left),
                 "device_largest_early_left_us": max(left.values(), default=0.0),
                 "device_sync_late_us": max([0.0] + [late for _, late in synced.values()])}


def _device_anchor_default(trace_dir: str, device: Sequence[Dict[str, object]],
                           meta: Dict[str, object]) -> Tuple[Optional[float], str, Optional[float]]:
    """(wall-clock seconds at device-trace ts 0, where it came from, its
    reading error in seconds).  In order: the profiler's anchor marker
    (its wall time, read when this process started the trace, minus its
    ts in the trace); the trace's own ``baseTimeNanoseconds`` (Kineto
    writes ts relative to it, rounded to the second on some builds); the
    wall clock read just before the trace started, taken as the earliest
    event's time."""
    try:
        from paddle_tpu_torch import profiler

        marker = profiler.last_device_marker()
        last = profiler.last_device_trace()
        anchor_name = profiler.ANCHOR_EVENT
    except Exception:
        marker, last, anchor_name = None, None, None
    if (marker and os.path.abspath(marker[0]) == os.path.abspath(trace_dir)
            and os.path.abspath(marker[3]) == os.path.abspath(str(meta.get("_path")))):
        ts = next((float(ev["ts"]) for ev in device
                   if isinstance(ev, dict) and ev.get("name") == anchor_name and "ts" in ev),
                  None)
        if ts is not None:
            return marker[1] - ts / 1e6, "marker", marker[2]
    base_ns = meta.get("baseTimeNanoseconds")
    if base_ns:
        return float(base_ns) / 1e9, "baseTimeNanoseconds", None
    if last and os.path.abspath(last[0]) == os.path.abspath(trace_dir) and last[1] is not None:
        first = min((float(ev["ts"]) for ev in device if isinstance(ev, dict) and "ts" in ev),
                    default=0.0)
        return last[1] - first / 1e6, "start_wall", None
    return None, "none", None


def export_chrome_trace(
    path: str,
    spans: Optional[Sequence[Dict[str, object]]] = None,
    jsonl_path: Optional[str] = None,
    pid: Optional[int] = None,
    requests: Optional[Sequence[Dict[str, object]]] = None,
    device_trace_dir: Optional[str] = None,
    device_anchor: Optional[float] = None,
) -> str:
    """Write ``path`` as a chrome://tracing-loadable JSON object.

    ``spans``: output of ``spans.stop_recording()`` (or any list in that
    shape).  ``jsonl_path``: an ``emit_trace_event`` JSONL file to merge.
    ``requests``: flight-recorder records (``FlightRecorder.snapshot()``)
    whose span trees are merged in with their trace ids.
    ``device_trace_dir``: a ``torch.profiler`` trace dir whose newest
    trace-event JSON is merged as device-side lanes; ``device_anchor``
    is the wall-clock time at device-trace ts 0 (defaulting to the
    profiler's anchor marker for that dir, else the trace's
    ``baseTimeNanoseconds``, else the profiler's start time, else the
    earliest host event).  Where the anchor came from and its reading
    error are written under ``otherData``.  Timestamps from every source share the
    wall-clock timebase; the earliest event is rebased to t=0 so the
    viewer opens centered.
    """
    spans = list(spans or [])
    for rec in requests or ():
        spans.extend(rec.get("spans") or ())
    jsonl = _jsonl_events(jsonl_path) if jsonl_path else []
    device, device_meta_doc = (_load_device_trace(device_trace_dir)
                               if device_trace_dir else ([], {}))
    device, merge_stats = _launch_ordered(device)
    anchor_source, anchor_err = ("argument" if device_anchor is not None else None), None
    pid = os.getpid() if pid is None else pid

    starts = [float(s["ts"]) for s in spans if "ts" in s]
    for ev in jsonl:
        ts = float(ev.get("ts", 0.0))
        starts.append(ts - float(ev.get("run_ms", 0.0)) / 1e3)
    if device:
        if device_anchor is None:
            device_anchor, anchor_source, anchor_err = _device_anchor_default(
                device_trace_dir, device, device_meta_doc)
        if device_anchor is not None:
            starts.append(device_anchor)
    base = min(starts) if starts else 0.0
    if device and device_anchor is None:
        device_anchor = base  # no anchor known: device t=0 at first host event
        anchor_source = "first_host_event"

    events: List[Dict[str, object]] = []
    tids = set()
    # span-id -> (ts_us, tid) of every exported span: parent edges that
    # cross lanes (threads, or processes via a wire hop) get explicit
    # flow arrows — the viewer draws the hierarchy instead of the reader
    # inferring it from timestamps
    span_sites: Dict[str, tuple] = {}
    child_edges: List[tuple] = []  # (child_id, parent_id, ts_us, tid)
    for s in spans:
        if "ts" not in s:
            continue  # a torn/foreign span dict must not kill the export
        tid = int(s.get("tid", 0))
        tids.add(tid)
        args = dict(s.get("args") or {})
        if s.get("error"):
            args["error"] = True
        if s.get("trace_ids"):
            args["trace_ids"] = list(s["trace_ids"])
        ev = {
            "name": str(s["name"]),
            "cat": str(s.get("cat", "host")),
            "ph": "X",
            "ts": (float(s["ts"]) - base) * 1e6,  # microseconds
            "dur": float(s.get("dur", 0.0)) * 1e6,
            "pid": pid,
            "tid": tid,
        }
        if s.get("id"):
            args["span_id"] = s["id"]
            span_sites[str(s["id"])] = (ev["ts"], tid)
        if s.get("parent"):
            args["parent_id"] = s["parent"]
            if s.get("id"):
                child_edges.append(
                    (str(s["id"]), str(s["parent"]), ev["ts"], tid))
        if args.pop("instant", None):
            ev["ph"] = "i"
            ev["s"] = "t"
            ev.pop("dur")
        if args:
            ev["args"] = args
        events.append(ev)

    for child_id, parent_id, ts_us, tid in child_edges:
        site = span_sites.get(parent_id)
        if site is None or site[1] == tid:
            continue  # same lane (nesting is visible) or parent not exported
        try:
            flow_id = int(child_id, 16) & 0x7FFFFFFF
        except ValueError:
            continue  # foreign span dict with a non-hex id
        events.append({
            "name": "span_parent", "cat": "flow", "ph": "s",
            "ts": site[0], "pid": pid, "tid": site[1], "id": flow_id,
        })
        events.append({
            "name": "span_parent", "cat": "flow", "ph": "f", "bp": "e",
            "ts": max(ts_us, site[0]), "pid": pid, "tid": tid, "id": flow_id,
        })

    _JSONL_TID = 0  # dedicated lane for the discrete event stream
    for rec in jsonl:
        rec = dict(rec)
        name = str(rec.pop("event", "event"))
        ts = float(rec.pop("ts", base))
        run_ms = rec.pop("run_ms", None)
        ev = {
            "name": name,
            "cat": "jsonl",
            "pid": pid,
            "tid": _JSONL_TID,
        }
        if run_ms is not None:
            # ts was stamped at emit time (batch END) — rebase to start
            ev["ph"] = "X"
            ev["ts"] = (ts - float(run_ms) / 1e3 - base) * 1e6
            ev["dur"] = float(run_ms) * 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
            ev["ts"] = (ts - base) * 1e6
        if rec:
            ev["args"] = rec
        events.append(ev)

    # device-side lanes: the profiler's events are already trace-event
    # dicts with µs timestamps relative to its session start — shift
    # them onto the shared wall timebase and move their pids into the
    # reserved device range (metadata rows ride along so Perfetto shows
    # the profiler's process/thread names)
    device_meta: List[Dict[str, object]] = []
    device_shift_us = ((device_anchor or 0.0) - base) * 1e6
    for ev in device:
        if not isinstance(ev, dict) or "ph" not in ev:
            continue
        ev = dict(ev)
        if "pid" in ev:
            try:
                ev["pid"] = _DEVICE_PID_BASE + int(ev["pid"])
            except (TypeError, ValueError):
                continue
        if ev.get("ph") == "M":
            device_meta.append(ev)
            continue
        if "ts" not in ev:
            continue
        ev["ts"] = float(ev["ts"]) + device_shift_us
        # the merge's own times ride in args: on the same timebase
        args = ev.get("args")
        if isinstance(args, dict) and any(k in args for k in _HOST_TIME_ARGS):
            ev["args"] = args = dict(args)
            for k in _HOST_TIME_ARGS:
                if k in args:
                    args[k] = float(args[k]) + device_shift_us
        ev["cat"] = ev.get("cat", "device")
        events.append(ev)

    meta: List[Dict[str, object]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "paddle_tpu_torch host"},
    }]
    if jsonl:
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": _JSONL_TID,
            "args": {"name": "jsonl events"},
        })
    main_tid = threading.get_ident()
    lanes = _spans.thread_lanes()
    # every REGISTERED lane gets its name row even when its thread
    # recorded no span this session (an idle replica worker is still a
    # track the fleet view should name; viewers ignore eventless tids)
    for tid in sorted(tids | set(lanes)):
        name = lanes.get(tid) or (
            "main" if tid == main_tid else "thread-%d" % tid)
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": name},
        })
    meta.extend(device_meta)

    events.sort(key=lambda e: e.get("ts", 0.0))
    doc: Dict[str, object] = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if device:
        # the host timebase's zero, and the device lanes' alignment onto it
        doc["otherData"] = {"base_wall_s": base, "device_anchor_wall_s": device_anchor,
                            "device_anchor_source": anchor_source,
                            "device_anchor_error_s": anchor_err,
                            **merge_stats}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
