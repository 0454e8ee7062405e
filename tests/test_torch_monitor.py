"""paddle_tpu_torch's monitor/, profiler, memory and debugger against the
JAX package's: the same calls on both give the same expositions (text-equal
once exemplar timestamps are masked), the same span trees and event rings,
the same SLO burn-rate verdicts under one injected clock, and the same
program dumps.  The device trace is the port's own (torch.profiler in
place of jax.profiler): on the CPU it traces host ops, and the merged
trace's lanes are aligned on the profiler's anchor marker, whose reading
error the export records."""
import json
import os
import re
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import debugger as jdebugger
from paddle_tpu import memory as jmemory
from paddle_tpu.monitor import events as jevents
from paddle_tpu.monitor import flight as jflight
from paddle_tpu.monitor import registry as jreg
from paddle_tpu.monitor import slo as jslo
from paddle_tpu.monitor import spans as jspans
from paddle_tpu_torch import debugger as tdebugger
from paddle_tpu_torch import memory as tmemory
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.monitor import events as tevents
from paddle_tpu_torch.monitor import flight as tflight
from paddle_tpu_torch.monitor import registry as treg
from paddle_tpu_torch.monitor import slo as tslo
from paddle_tpu_torch.monitor import spans as tspans

PAIRS = [(jreg, treg)]
# OpenMetrics exemplars carry a wall-clock timestamp: masked before comparing
_TS = re.compile(r"(\} [0-9.e+-]+) [0-9]{9,}\.[0-9]+")


def _mask(text):
    return _TS.sub(r"\1 <ts>", text)


def _fill(reg_mod):
    """One scenario on a private registry: labelled counters, gauges, a
    histogram with exemplars, a callback counter."""
    r = reg_mod.MetricsRegistry()
    c = r.counter("reqs_total", "requests", ("code",))
    c.labels(code="200").inc(3)
    c.labels(code="500").inc()
    g = r.gauge("queue_depth", "queued rows")
    g.set(7)
    g.dec(2)
    g2 = r.gauge("temp_c", "per-card temperature", ("card",))
    g2.labels(card="0").set(41.5)
    h = r.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for i, v in enumerate([0.005, 0.05, 0.05, 0.5, 2.0]):
        h.observe(v, exemplar={"trace_id": "t%d" % i})
    r.counter_callback("cb_total", "collected on read", fn=lambda: 11)
    return r


@pytest.mark.parametrize("form", ["text", "openmetrics", "snapshot", "value"])
def test_registry_expositions_match(form):
    jr, tr = _fill(jreg), _fill(treg)
    if form == "text":
        assert tr.render_text() == jr.render_text()
    elif form == "openmetrics":
        assert _mask(tr.render_openmetrics()) == _mask(jr.render_openmetrics())
        assert "# EOF" in tr.render_openmetrics()
    elif form == "snapshot":
        assert tr.snapshot() == jr.snapshot()
    else:
        for name, labels in (("reqs_total", {}), ("reqs_total", {"code": "500"}),
                             ("queue_depth", {}), ("cb_total", {})):
            assert tr.value(name, **labels) == jr.value(name, **labels)


@pytest.mark.parametrize("op", ["parse", "relabel", "merge"])
def test_exposition_tools_match(op):
    jt, tt = _fill(jreg).render_text(), _fill(treg).render_text()
    jp, tp = jreg.parse_exposition(jt), treg.parse_exposition(tt)
    if op == "parse":
        assert tp == jp
    elif op == "relabel":
        assert (treg.relabel_exposition(tp, "replica", "r1")
                == jreg.relabel_exposition(jp, "replica", "r1"))
    else:
        jm = jreg.merge_expositions([jp, jreg.relabel_exposition(jp, "r", "2")])
        tm = treg.merge_expositions([tp, treg.relabel_exposition(tp, "r", "2")])
        assert tm == jm


def test_registry_rejects_bad_names_and_counts_down_alike():
    for mod in (jreg, treg):
        r = mod.MetricsRegistry()
        with pytest.raises(ValueError):
            r.counter("bad name")
        with pytest.raises(ValueError):
            r.counter("ok_total").inc(-1)


def test_the_readers_stall_counters_still_register():
    from paddle_tpu_torch import reader  # noqa: F401

    snap = tmonitor.snapshot()
    for name in ("reader_consumer_stalls_total", "reader_producer_stalls_total",
                 "reader_consumer_stall_seconds_total", "reader_producer_stall_seconds_total"):
        assert snap[name]["type"] == "counter"


def _span_scenario(spans_mod):
    """A nested span tree under a trace context, recorded in a session;
    returns the spans with ids, times and threads normalised."""
    spans_mod.start_recording()
    try:
        with spans_mod.trace_context(("req-1",)):
            with spans_mod.span("outer", cat="test", k=1):
                with spans_mod.span("inner"):
                    spans_mod.record_instant("mark", cat="test")
                t0 = time.perf_counter()
                spans_mod.record_span("manual", t0, 0.25, cat="x", n=2)
        with spans_mod.parent_scope() as sid:
            spans_mod.record_span("child", time.perf_counter(), 0.0)
    finally:
        out = spans_mod.stop_recording()
    ids = {}

    def norm(i):
        return ids.setdefault(i, "s%d" % len(ids)) if i else None

    return [{"name": s["name"], "cat": s.get("cat"), "args": s.get("args"),
             "trace_ids": s.get("trace_ids"), "parent": norm(s.get("parent")),
             "id": norm(s.get("id")), "dur": s["dur"] if s["name"] == "manual" else None}
            for s in out], sid is not None


def test_span_trees_match():
    jout, jok = _span_scenario(jspans)
    tout, tok = _span_scenario(tspans)
    assert tout == jout and tok and jok
    assert [s["name"] for s in tout] == ["mark", "inner", "manual", "outer", "child"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flight_recorder_tree_and_tail_sampling(pkg):
    flight = jflight if pkg == "jax" else tflight
    rec = flight.FlightRecorder(capacity=2, slow_ms=10.0)
    assert not rec.consider("fast", 0.001)
    assert rec.consider("slow", 0.5, spans=[{"name": "a", "id": "1", "ts": 1.0, "dur": 0.1}])
    assert rec.consider("err", 0.001, status="error")
    assert rec.consider("late", 0.2)
    keys = [r["trace_id"] for r in rec.snapshot()]
    assert sorted(keys) == ["err", "late"]  # capacity 2: the oldest evicted


def test_flight_recorders_agree():
    def run(flight):
        rec = flight.FlightRecorder(capacity=3, slow_ms=5.0)
        for i, (lat, st) in enumerate([(0.001, "ok"), (0.01, "ok"), (0.0, "error"),
                                       (0.02, "deadline"), (0.03, "ok")]):
            rec.consider("t%d" % i, lat, status=st)
        return [{k: r[k] for k in ("trace_id", "status", "latency_ms")} for r in rec.snapshot()]

    assert run(tflight) == run(jflight)
    spans = [{"name": "root", "id": "a", "ts": 0.0, "dur": 1.0},
             {"name": "kid", "id": "b", "parent": "a", "ts": 0.1, "dur": 0.2}]
    assert tflight.span_tree(spans) == jflight.span_tree(spans)


def test_event_rings_match():
    def run(events):
        ring = events.EventRing(capacity=3)
        for i, sev in enumerate(["info", "warning", "error", "critical", "info"]):
            ring.emit("test/e%d" % i, severity=sev, message="m%d" % i, step=i)
        with pytest.raises(ValueError):
            ring.emit("x", severity="loud")
        doc = ring.eventz()
        doc["events"] = [{k: v for k, v in e.items() if k != "ts"} for e in doc["events"]]
        return doc, [e["kind"] for e in ring.snapshot(min_severity="error")]

    assert run(tevents) == run(jevents)


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _slo_run(reg_mod, slo_mod):
    r = reg_mod.MetricsRegistry()
    good, bad = r.counter("good_total"), r.counter("bad_total")
    h = r.histogram("lat_seconds", buckets=(0.05, 0.1, 0.5))
    clock = _Clock()
    eng = slo_mod.SloEngine(
        [slo_mod.availability("avail", "good_total", "bad_total", target=0.99),
         slo_mod.latency("fast", "lat_seconds", threshold_s=0.1, target=0.9)],
        window_scale=0.001, registry=r, clock=clock)
    out = []
    for tick in range(30):
        clock.t += 1.0
        good.inc(100)
        if 10 <= tick < 20:
            bad.inc(20)  # a burst of errors: the fast pair fires, then clears
            for _ in range(5):
                h.observe(0.3)
        for _ in range(20):
            h.observe(0.01)
        doc = eng.evaluate_once()
        # "since" is the wall clock a pair began firing: kept as whether it is set
        out.append({o["name"]: {k: (json.loads(json.dumps(o[k]).replace('"since": null', '"since": 0'))
                                    if k == "alerts" else o[k])
                                for k in o if k in ("firing", "burn", "alerts", "status", "windows")}
                    for o in doc.get("objectives", [])})
        for row in out[-1].values():
            for a in row.get("alerts", []):
                a["since"] = bool(a["since"])
    eng.stop()
    return out


def test_slo_burn_rate_verdicts_match():
    t, j = _slo_run(treg, tslo), _slo_run(jreg, jslo)
    assert t == j
    assert any(v for row in t for v in row.values())


def test_push_gateway_posts_the_exposition(tmp_path):
    from http.server import BaseHTTPRequestHandler, HTTPServer

    got = []

    class H(BaseHTTPRequestHandler):
        def do_PUT(self):
            got.append((self.path, self.rfile.read(int(self.headers["Content-Length"]))))
            self.send_response(200)
            self.end_headers()

        do_POST = do_PUT

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        gw = tmonitor.PushGateway("http://127.0.0.1:%d" % srv.server_address[1],
                                  interval_s=3600, registry=_fill(treg))
        assert gw.push_now()
        gw.stop(push_final=False)
    finally:
        srv.shutdown()
    assert got and b"reqs_total" in got[0][1]
    assert "paddle_tpu" in got[0][0]


def test_monitor_exposes_the_jax_packages_names():
    from paddle_tpu import monitor as jmonitor

    assert set(jmonitor.__all__) <= set(dir(tmonitor))
    for mod_j, mod_t in ((jfluid.profiler, tprofiler), (jmemory, tmemory),
                         (jdebugger, tdebugger)):
        assert set(mod_j.__all__) <= set(mod_t.__all__)


def test_memory_stats_on_the_cpu_report_none_as_the_jax_package():
    (t,), (j,) = tmemory.device_memory_stats(), jmemory.device_memory_stats()[:1]
    keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit", "num_allocs")
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys} == dict.fromkeys(keys)
    assert "in_use" in tmemory.memory_summary()


def _dump_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        fluid.layers.fc(x, 2, act="relu")
    return main


def test_debugger_dumps_match(tmp_path, capsys):
    jt = jdebugger.pprint_program_codes(_dump_program(jfluid))
    tt = tdebugger.pprint_program_codes(_dump_program(tfluid))
    assert tt == jt
    jd = jdebugger.draw_block_graphviz(_dump_program(jfluid).global_block(), path=None)
    td = tdebugger.draw_block_graphviz(_dump_program(tfluid).global_block(),
                                       path=str(tmp_path / "g.dot"))
    assert td == jd and (tmp_path / "g.dot").read_text() == td


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_record_event_table_and_error_rows(pkg, capsys):
    prof = jfluid.profiler if pkg == "jax" else tprofiler
    prof.reset_profiler()
    with prof.RecordEvent("work"):
        pass

    @prof.RecordEvent("deco")
    def f():
        return 3

    assert f() == 3
    with pytest.raises(ValueError):
        with prof.RecordEvent("work"):
            raise ValueError("x")
    rows = prof.stop_profiler(sorted_key="calls")
    assert sorted((r[0], r[1]) for r in rows) == [("deco", 1), ("work", 1), ("work (error)", 1)]


def test_jsonl_trace_and_cuda_profiler_alias(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    with tprofiler.jsonl_trace(path):
        tprofiler.emit_trace_event({"event": "serving.batch", "run_ms": 2.0, "rows": 3})
    rec = json.loads(open(path).read().strip())
    assert rec["rows"] == 3 and "ts" in rec
    with tprofiler.cuda_profiler():
        pass


def test_device_trace_merges_on_the_anchor_marker(tmp_path):
    """start_profiler(trace_dir=) runs torch.profiler (host ops on the CPU),
    a second start resets the first, and trace_session merges the trace
    with the host spans, aligned on the anchor marker."""
    import torch

    d = str(tmp_path / "prof")
    tprofiler.start_profiler(trace_dir=d)
    tprofiler.start_profiler(trace_dir=d)  # idempotent: the first is reset
    tprofiler.stop_profiler(profile_path=os.devnull)
    assert tprofiler.last_device_marker()[0] == d
    out = str(tmp_path / "trace.json")
    with tmonitor.trace_session(path=out, device_trace_dir=d):
        with tspans.span("host_work"):
            x = torch.randn(64, 64)
            for _ in range(3):
                x = x @ x
    doc = json.load(open(out))
    other = doc["otherData"]
    assert other["device_anchor_source"] == "marker"
    assert 0.0 <= other["device_anchor_error_s"] < 0.01
    evs = doc["traceEvents"]
    host = next(e for e in evs if e.get("name") == "host_work")
    mm = [e for e in evs if e.get("name") == "aten::mm"]
    assert len(mm) == 3
    for e in mm:  # the profiler's ops land inside the host span that ran them
        assert host["ts"] - 100 <= e["ts"] and e["ts"] + e["dur"] <= host["ts"] + host["dur"] + 100
    assert not tprofiler._active_trace_dir  # the session stopped its trace


def test_device_work_never_starts_before_its_launch(tmp_path):
    """A device trace whose graph replay was timed before the
    ``cudaGraphLaunch`` that issued it (CUPTI's clock conversion, seen on
    an H100): the merge moves that launch's kernels, memcpy and flow end
    to the launch, keeping CUPTI's own start and the shift in the moved
    events' args, and leaves an in-order launch as it is."""
    from paddle_tpu_torch.monitor import chrome_trace

    d = tmp_path / "prof"
    d.mkdir()
    evs = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 5000.0, "dur": 20.0,
         "pid": 1, "tid": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_early", "ts": 3200.0, "dur": 80.0, "pid": 0,
         "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 3300.0, "dur": 5.0, "pid": 0,
         "tid": 7, "args": {"correlation": 7}},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 7, "ts": 3200.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 6000.0, "dur": 5.0,
         "pid": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_ok", "ts": 6010.0, "dur": 10.0, "pid": 0, "tid": 7,
         "args": {"correlation": 8}},
    ]
    (d / "host.pt.trace.json").write_text(json.dumps({"traceEvents": evs}))
    out = str(tmp_path / "trace.json")
    chrome_trace.export_chrome_trace(out, spans=[], device_trace_dir=str(d), device_anchor=100.0)
    doc = json.load(open(out))
    by = {e["name"]: e["ts"] for e in doc["traceEvents"] if e.get("ph") in ("X", "f")}
    assert by["k_early"] == pytest.approx(by["cudaGraphLaunch"])
    assert by["copy"] - by["k_early"] == pytest.approx(100.0)
    assert by["ac2g"] == pytest.approx(by["cudaGraphLaunch"])
    assert by["k_ok"] - by["cudaLaunchKernel"] == pytest.approx(10.0)
    other = doc["otherData"]
    assert other["device_launches"] == 2 and other["device_launches_moved"] == 1
    assert other["device_largest_move_us"] == pytest.approx(1800.0)
    args = {e["name"]: e.get("args", {}) for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert args["k_early"]["cupti_ts"] == 3200.0 and args["copy"]["cupti_ts"] == 3300.0
    assert args["k_early"]["moved_us"] == pytest.approx(1800.0)
    assert "cupti_ts" not in args["k_ok"] and "moved_us" not in args["k_ok"]


def test_device_work_is_tied_to_its_launch_when_cupti_runs_late(tmp_path):
    """The shape of a recorded H100 failure of the merged trace's check:
    CUPTI's clock drifted from the host's, so a captured step's kernels and
    its loss copy were timed after the return of the synchronous
    ``cudaMemcpyAsync`` that waited for them (9.7 ms there), and the last
    kernels of the step fell past its host span.  The merge ties each work
    event to the launch call that issued it (``args["launch_ts"]``, on the
    merged timebase) without moving late work, and tags the synchronous
    copy with its call and CUPTI's lateness past the call's return
    (``device_sync_late_us`` the largest)."""
    from paddle_tpu_torch.monitor import chrome_trace

    launch = {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 2624.0,
              "dur": 13301.0, "pid": 1, "tid": 1, "args": {"correlation": 11}}
    copy_call = {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "ts": 15000.0,
                 "dur": 45630.0, "pid": 1, "tid": 1, "args": {"correlation": 12}}
    kernels = [{"ph": "X", "cat": "kernel", "name": "k%d" % i, "ts": 8000.0 + 5000.0 * i,
                "dur": 900.0, "pid": 0, "tid": 7, "args": {"correlation": 11, "stream": 7}}
               for i in range(11)]  # the last ends at 58,900; ...
    kernels[-1]["ts"] = 61000.0      # ... CUPTI put it past the copy's return
    copy = {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pageable)",
            "ts": 62000.0, "dur": 3.0, "pid": 0, "tid": 7,
            "args": {"correlation": 12, "stream": 7}}
    device = [launch, copy_call] + kernels + [copy]
    out, stats = chrome_trace._launch_ordered(device)
    assert stats["device_launches"] == 1 and stats["device_launches_moved"] == 0
    assert stats["device_largest_move_us"] == 0.0 and stats["device_launches_left_early"] == 0
    assert stats["device_sync_late_us"] == pytest.approx(62003.0 - 60630.0)
    work = [e for e in out if e.get("cat") == "kernel"]
    assert [e["ts"] for e in work] == [k["ts"] for k in kernels]  # late work is not moved
    assert all(e["args"]["launch_ts"] == 2624.0 for e in work)
    assert all("moved_us" not in e["args"] for e in work)
    synced = next(e for e in out if e.get("cat") == "gpu_memcpy")["args"]
    assert synced["call_ts"] == 15000.0 and synced["cupti_late_us"] == pytest.approx(1373.0)

    d = tmp_path / "prof"
    d.mkdir()
    (d / "host.pt.trace.json").write_text(json.dumps({"traceEvents": device}))
    path = str(tmp_path / "trace.json")
    chrome_trace.export_chrome_trace(path, spans=[{"name": "step", "ts": 50.0, "dur": 0.06}],
                                     device_trace_dir=str(d), device_anchor=50.001)
    doc = json.load(open(path))
    by = {e["name"]: e for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert by["k0"]["args"]["launch_ts"] == pytest.approx(by["cudaGraphLaunch"]["ts"])
    assert doc["otherData"]["device_sync_late_us"] == pytest.approx(1373.0)


def test_a_clock_step_inside_a_launch_is_not_shifted_whole():
    """The shape of a second recorded failure: CUPTI's clock stepped 21.9
    ms between two consecutive kernels of one graph replay, so its first
    kernels were timed 21.4 ms before the launch and the rest where they
    ran.  Shifting the whole launch by 21.4 ms would throw its correctly
    timed tail past the step: the merge leaves work timed more than
    MAX_LAUNCH_MOVE_US early where CUPTI put it, tied to its launch and
    flagged, and still moves a launch a few ms early."""
    from paddle_tpu_torch.monitor import chrome_trace

    def launch(c, ts):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": ts,
                "dur": 15000.0, "pid": 1, "tid": 1, "args": {"correlation": c}}

    def kernel(c, name, ts):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 5.0, "pid": 0,
                "tid": 7, "args": {"correlation": c, "stream": 7}}

    device = [launch(21, 100000.0), launch(22, 200000.0)]
    device += [kernel(21, "early%d" % i, 78630.0 + 10.0 * i) for i in range(3)]  # 21.4 ms early
    device += [kernel(21, "tail%d" % i, 100553.0 + 10.0 * i) for i in range(3)]  # after the step
    device += [kernel(22, "drift%d" % i, 198000.0 + 10.0 * i) for i in range(3)]  # 2 ms early
    out, stats = chrome_trace._launch_ordered(device)
    by = {e["name"]: e for e in out}
    assert stats["device_launches_moved"] == 1 and stats["device_launches_left_early"] == 1
    assert stats["device_largest_move_us"] == pytest.approx(2000.0)
    assert stats["device_largest_early_left_us"] == pytest.approx(21370.0)
    assert by["early0"]["ts"] == 78630.0 and by["tail0"]["ts"] == 100553.0
    assert by["early0"]["args"]["cupti_early_us"] == pytest.approx(21370.0)
    assert by["tail2"]["args"]["launch_ts"] == 100000.0
    assert by["drift0"]["ts"] == pytest.approx(200000.0)
    assert by["drift0"]["args"]["moved_us"] == pytest.approx(2000.0)
    assert chrome_trace.MAX_LAUNCH_MOVE_US == 10000.0


def test_reset_profiler_stops_a_running_trace_without_writing(tmp_path):
    d = str(tmp_path / "p")
    tprofiler.start_profiler(trace_dir=d)
    tprofiler.reset_profiler()
    assert tprofiler._active_trace_dir is None
    assert not [f for f in os.listdir(d) if f.endswith(".trace.json")]
    assert tprofiler.last_device_trace()[0] == d


def test_memory_fraction_flag_caps_each_card_once(monkeypatch):
    import torch

    monkeypatch.delenv("FLAGS_fraction_of_gpu_memory_to_use", raising=False)
    monkeypatch.delenv("FLAGS_tpu_memory_fraction", raising=False)
    assert tmemory.apply_memory_fraction() is None
    monkeypatch.setenv("FLAGS_fraction_of_gpu_memory_to_use", "0.5")
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, i: calls.append((f, i)))
    monkeypatch.setattr(tmemory, "_fraction_applied", set())
    assert tmemory.apply_memory_fraction() == 0.5
    assert tmemory.apply_memory_fraction("cuda:1") == 0.5
    assert calls == [(0.5, 0), (0.5, 1)]
