"""The port's ``InferenceServer`` replica pool and its operating surface
on the CPU: least-loaded routing over several predictors, a failing
replica's batches requeued onto a survivor (none dropped) and the replica
retired, re-admission after ``readmit_cooldown_s``, ``remove_replica``,
the ``server.admit`` and ``replica.dispatch`` fault points, the admin
endpoints (``/metrics``, ``/statusz``, ``/tracez`` on 127.0.0.1, port 0),
the flight recorder, trace-id propagation from the client to the
executor's spans, and the ladder autotuner (``replan_ladder``,
``start_autotuner``) with no entry built after warmup.  The stub
predictors sleep (releasing the GIL as device work does); the real ones
are a small MLP saved and loaded through the port's inference path.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.serving import (
    Client,
    DeadlineExceeded,
    InferenceServer,
    ServingError,
)
from paddle_tpu_torch.serving.errors import BackendUnavailable

IN_DIM, OUT_DIM = 16, 4


def _save_mlp(d, seed=7):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = seed
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [IN_DIM])
        h = fluid.layers.fc(x, 32, act="relu")
        pred = fluid.layers.fc(h, OUT_DIM, act="softmax")
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(d, ["x"], [pred], exe, main_program=prog, scope=scope)
    return d


def _mlp_predictor(d):
    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    return create_paddle_predictor(cfg)


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    return _save_mlp(str(tmp_path_factory.mktemp("replicas") / "mlp"))


def _rows(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, IN_DIM)).astype("float32")


class SlowPredictor:
    """A host stub whose run blocks: deterministic worker stalls."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.calls = 0

    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return ["y"]

    def input_specs(self):
        return {"x": ((IN_DIM,), np.dtype("float32"))}

    def jit_cache_stats(self):
        return {"entries": 0, "hits": 0, "misses": 0}

    def run_padded(self, feed, n_valid=None):
        self.calls += 1
        if self.delay_s:
            time.sleep(self.delay_s)
        return [np.asarray(feed["x"][:n_valid]).sum(axis=1, keepdims=True)]


class KillablePredictor(SlowPredictor):
    """A SlowPredictor that can be flipped into failing for good."""

    def __init__(self, delay_s=0.0):
        super().__init__(delay_s)
        self.killed = False

    def run_padded(self, feed, n_valid=None):
        if self.killed:
            raise RuntimeError("replica hardware lost")
        return super().run_padded(feed, n_valid=n_valid)


class _OnReplica(faults.FaultPlan):
    """A plan that fires only on one replica's dispatches."""

    def __init__(self, specs, replica):
        super().__init__(specs)
        self.replica = replica

    def faultpoint(self, name, **ctx):
        if ctx.get("replica") != self.replica:
            return None
        return super().faultpoint(name, **ctx)


def _storm(server, n_req, start_val=0):
    futs = []
    for i in range(n_req):
        row = np.full((1, IN_DIM), float(start_val + i), np.float32)
        futs.append((start_val + i, server.submit({"x": row})))
    return futs


def _measure_throughput(n_replicas, n_req=20, delay=0.05):
    preds = [SlowPredictor(delay) for _ in range(n_replicas)]
    server = InferenceServer(preds if n_replicas > 1 else preds[0], max_batch_size=1,
                             batch_timeout_ms=1, queue_capacity=128, name="tp%d" % n_replicas)
    try:
        server.warmup()
        t0 = time.perf_counter()
        futs = [server.submit({"x": _rows(1, seed=i)}) for i in range(n_req)]
        for f in futs:
            f.result(timeout=30)
        elapsed = time.perf_counter() - t0
        m = server.metrics()
        assert m["recompiles"] == 0 and m["completed"] == n_req
        return elapsed
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the replica pool
# ---------------------------------------------------------------------------
def test_two_replicas_serve_faster_than_one():
    """Two replicas behind the one batcher beat 1.5x one replica's
    throughput on a slow endpoint whose runs release the GIL."""
    t1, t2 = _measure_throughput(1), _measure_throughput(2)
    assert t1 / t2 > 1.5, "2-replica speedup %.2fx (%.3fs vs %.3fs)" % (t1 / t2, t1, t2)


def test_killed_replica_drains_without_dropping_requests():
    p0, p1 = KillablePredictor(0.02), KillablePredictor(0.02)
    server = InferenceServer([p0, p1], max_batch_size=1, batch_timeout_ms=1, queue_capacity=128,
                             name="killtest")
    try:
        server.warmup()
        futs = []
        for i in range(30):
            futs.append(_storm(server, 1, start_val=i)[0])
            if i == 10:
                p0.killed = True  # replica r0 dies mid-stream
        for val, fut in futs:
            (out,) = fut.result(timeout=30)
            np.testing.assert_allclose(out[0, 0], val * IN_DIM, rtol=1e-5)
        m = server.metrics()
        assert m["completed"] == 30 and m["failed"] == 0
        assert sorted(r["alive"] for r in m["replicas"].values()) == [False, True]
        assert m["requeued"] >= 1 and server.num_replicas == 1
        assert m["replicas"]["r0"]["failed"] >= 3  # retired after three in a row
    finally:
        server.stop(drain=True)


def test_all_replicas_dead_fails_typed_not_hang():
    p0, p1 = KillablePredictor(), KillablePredictor()
    server = InferenceServer([p0, p1], max_batch_size=1, batch_timeout_ms=1, name="alldead")
    try:
        p0.killed = p1.killed = True
        failed = 0
        for f in [server.submit({"x": _rows(1)}) for _ in range(4)]:
            try:
                f.result(timeout=30)
            except (ServingError, RuntimeError):
                failed += 1
        assert failed == 4
    finally:
        server.stop(drain=True)


def test_remove_replica_graceful_with_drain_marker():
    pa, pb = SlowPredictor(0.01), SlowPredictor(0.01)
    server = InferenceServer([pa, pb], max_batch_size=1, batch_timeout_ms=1, queue_capacity=128,
                             name="rmtest")
    with monitor.trace_session() as sess:
        try:
            server.warmup()
            futs = [server.submit({"x": _rows(1, seed=i)}) for i in range(10)]
            server.remove_replica(0)
            calls = pa.calls
            futs += [server.submit({"x": _rows(1, seed=i)}) for i in range(10)]
            for f in futs:
                f.result(timeout=30)
            assert pa.calls == calls  # nothing routed to the removed replica
            assert server.num_replicas == 1
            assert server.metrics()["replicas"]["r0"]["alive"] is False
            with pytest.raises(ValueError, match="last live replica"):
                server.remove_replica("r1")
            with pytest.raises(ValueError, match="unknown replica"):
                server.remove_replica("r9")
            assert server.metrics()["completed"] == 20
        finally:
            server.stop(drain=True)
    drains = [s for s in sess.spans if s["name"] == "serving/replica_drain"
              and s.get("args", {}).get("server") == "rmtest"]
    assert len(drains) == 1 and drains[0]["args"]["replica"] == "r0"


def test_retired_replica_is_readmitted_after_its_cooldown():
    p0, p1 = KillablePredictor(0.005), KillablePredictor(0.005)
    server = InferenceServer([p0, p1], max_batch_size=1, batch_timeout_ms=1, queue_capacity=128,
                             name="readmit", readmit_cooldown_s=0.2)
    probes0 = monitor.counter_value("backend_halfopen_probes_total", pool="server/readmit")
    try:
        server.warmup()
        p0.killed = True
        for _, f in _storm(server, 12):
            f.result(timeout=30)
        assert server.replica_stats()["r0"]["alive"] is False
        p0.killed = False  # healed
        time.sleep(0.3)
        deadline = time.monotonic() + 10
        while p0.calls == 0 or not server.replica_stats()["r0"]["alive"]:
            for _, f in _storm(server, 4):
                f.result(timeout=30)
            assert time.monotonic() < deadline, "r0 never re-admitted"
        assert monitor.counter_value("backend_halfopen_probes_total",
                                     pool="server/readmit") >= probes0 + 1
        assert server.replica_stats()["r0"]["executed"] >= 1
    finally:
        server.stop(drain=True)


def test_fleet_warmup_builds_nothing_under_traffic(mlp_dir):
    """Warmup covers every replica: mixed-size traffic afterwards builds no
    entry on any replica, and both replicas serve."""
    first, second = _mlp_predictor(mlp_dir), _mlp_predictor(mlp_dir)
    server = InferenceServer([first, second], max_batch_size=8, batch_timeout_ms=5,
                             name="fleetwarm")
    try:
        assert server.warmup() == 2 * len(server.bucket_ladder)
        misses0 = [first.jit_cache_stats()["misses"], second.jit_cache_stats()["misses"]]
        cli = Client(server)
        sizes = [1, 2, 3, 5, 7, 8, 4, 6, 1, 3, 2, 5, 8, 7]
        errors, answers = [], {}

        def go(i, n):
            try:
                answers[i] = cli.infer({"x": _rows(n, seed=i)})[0]
            except Exception as e:  # noqa: BLE001 — asserted below
                errors.append(e)

        threads = [threading.Thread(target=go, args=(i, n)) for i, n in enumerate(sizes)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        m = server.metrics()
        assert m["recompiles"] == 0 and m["completed"] == len(sizes)
        assert [first.jit_cache_stats()["misses"], second.jit_cache_stats()["misses"]] == misses0
        assert sum(r["executed"] for r in m["replicas"].values()) == m["batches"]
    finally:
        server.stop()
    for i, n in enumerate(sizes):  # each answer is its request's, run alone
        np.testing.assert_allclose(answers[i], first.run({"x": _rows(n, seed=i)})[0],
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the fault points
# ---------------------------------------------------------------------------
def test_server_admit_fault_point_fails_the_submit_typed():
    server = InferenceServer(SlowPredictor(), max_batch_size=2, name="admitfault")
    try:
        with faults.armed("server.admit=error:BackendUnavailable,times=1") as plan:
            with pytest.raises(BackendUnavailable):
                server.submit({"x": _rows(1)})
            assert server.submit({"x": _rows(1)}).result(timeout=30)[0].shape == (1, 1)
            assert plan.triggers() == {"server.admit": 1}
        assert server.metrics()["requests"] == 1  # the failed one never enqueued
    finally:
        server.stop()


def test_replica_dispatch_fault_kills_one_replica_and_no_request_drops():
    """``replica.dispatch`` armed on r1 only, failing for good: its batches
    are requeued onto r0, r1 is retired after three in a row, and every
    request is answered with its own rows."""
    p0, p1 = SlowPredictor(0.005), SlowPredictor(0.005)
    server = InferenceServer([p0, p1], max_batch_size=1, batch_timeout_ms=1, queue_capacity=128,
                             name="dispatchfault")
    try:
        server.warmup()
        plan = faults.arm(_OnReplica([faults.FaultSpec("replica.dispatch", "error", after=2)],
                                     replica="r1"))
        try:
            futs = _storm(server, 30)
            for val, fut in futs:
                (out,) = fut.result(timeout=30)
                np.testing.assert_allclose(out[0, 0], val * IN_DIM, rtol=1e-5)
        finally:
            faults.disarm()
        m = server.metrics()
        assert m["completed"] == 30 and m["failed"] == 0
        assert plan.triggers()["replica.dispatch"] == 3
        # the three failed batches, and any batch queued behind them on r1
        assert m["replicas"]["r1"]["alive"] is False and m["requeued"] >= 3
    finally:
        server.stop(drain=True)


def test_lifecycle_markers_agree_with_the_requeue_counter():
    p0, p1 = KillablePredictor(0.02), KillablePredictor(0.02)
    server = InferenceServer([p0, p1], max_batch_size=1, batch_timeout_ms=1, queue_capacity=128,
                             name="marktest")
    with monitor.trace_session() as sess:
        try:
            server.warmup()
            requeued0 = monitor.counter_value("serving_requeued_total", server="marktest")
            futs = []
            for i in range(30):
                futs.append(_storm(server, 1, start_val=i)[0])
                if i == 10:
                    p0.killed = True
            for _, fut in futs:
                fut.result(timeout=30)
            requeued = monitor.counter_value("serving_requeued_total",
                                             server="marktest") - requeued0
        finally:
            server.stop(drain=True)
    markers = [s for s in sess.spans if s.get("args", {}).get("instant")
               and s["args"].get("server") == "marktest"]
    retire = [m for m in markers if m["name"] == "serving/replica_retired"]
    requeue = [m for m in markers if m["name"] == "serving/batch_requeue"]
    drain = [m for m in markers if m["name"] == "serving/server_drain"]
    assert len(retire) == 1 and retire[0]["args"]["replica"] == "r0"
    assert requeued >= 1 and len(requeue) == requeued
    assert all(m["args"]["replica"] == "r0" for m in requeue)
    assert len(drain) == 1


# ---------------------------------------------------------------------------
# the admin surface, the flight recorder, traces
# ---------------------------------------------------------------------------
def _get(host, port, path, accept=None):
    req = urllib.request.Request("http://%s:%d%s" % (host, port, path))
    if accept:
        req.add_header("Accept", accept)
    with urllib.request.urlopen(req, timeout=10) as resp:
        return resp.headers["Content-Type"], resp.read().decode()


def test_admin_metrics_statusz_and_tracez(mlp_dir):
    server = InferenceServer([_mlp_predictor(mlp_dir), _mlp_predictor(mlp_dir)], max_batch_size=2,
                             batch_timeout_ms=1, name="adminz")
    try:
        server.warmup()
        server.submit({"x": np.zeros((2, IN_DIM), "float32")}).result(timeout=60)
        host, port = server.start_admin(port=0)
        assert host == "127.0.0.1" and server.start_admin() == (host, port)  # idempotent
        ctype, text = _get(host, port, "/metrics")
        assert ctype.startswith("text/plain")
        assert "# TYPE serving_requests_total counter" in text and 'server="adminz"' in text
        assert "# TYPE executor_runs_total counter" in text  # the whole registry
        assert text == server.metrics_text() or "serving_requests_total" in server.metrics_text()
        _, om = _get(host, port, "/metrics", accept="application/openmetrics-text")
        assert om.rstrip().endswith("# EOF")
        _, body = _get(host, port, "/statusz")
        status = json.loads(body)
        assert status["server"] == "adminz"
        assert status["metrics"]["completed"] == 1 and status["metrics"]["recompiles"] == 0
        assert status["metrics"]["bucket_ladder"] == [1, 2]
        assert status["metrics"]["batch_histogram"]["2"]["batches"] == 1
        assert set(status["replica_jit_cache"]) == {"r0", "r1"}
        assert status["jit_cache"]["misses"] >= 2  # one per warmup rung
        assert "serving_requests_total" in status["registry"]
        _, body = _get(host, port, "/tracez")
        assert json.loads(body) == server.tracez() == {"recorder": False, "retained": 0,
                                                       "requests": []}
        with pytest.raises(urllib.error.HTTPError):
            _get(host, port, "/nope")
    finally:
        server.stop()
    assert server.admin_address is None  # stop() tears the admin down
    assert 'server="adminz"' not in monitor.render_text()  # its series retired
    assert server.metrics()["completed"] == 1  # the local snapshot still reads


def test_flight_recorder_tail_samples_slow_requests():
    slow = SlowPredictor(delay_s=0.05)
    server = InferenceServer(slow, max_batch_size=2, batch_timeout_ms=1, name="flighty")
    with monitor.flight_recorder(capacity=16, slow_ms=20.0) as rec:
        try:
            server.warmup()
            cli = Client(server)
            cli.infer({"x": _rows(1)}, trace_id="aaaa000011112222")
            record = rec.get_record("aaaa000011112222")
            assert record is not None, "a 50 ms request above slow_ms=20 was dropped"
            names = [s["name"] for s in record["spans"]]
            assert {"serving/queue_wait", "serving/materialize", "serving/client_infer"} <= set(names)
            assert record["status"] == "ok" and record["latency_ms"] >= 20.0
            assert record["replica"] == "r0"
            host, port = server.start_admin(port=0)
            doc = json.loads(_get(host, port, "/tracez")[1])
            assert doc["recorder"] is True
            assert any(r["trace_id"] == "aaaa000011112222" for r in doc["requests"])
            slow.delay_s = 0.0  # a fast request stays below the threshold
            cli.infer({"x": _rows(1)}, trace_id="bbbb000011112222")
            assert rec.get_record("bbbb000011112222") is None
        finally:
            server.stop()
    assert _flight.get() is None


def test_flight_recorder_retains_deadline_missed_requests():
    server = InferenceServer(SlowPredictor(delay_s=0.3), max_batch_size=4, batch_timeout_ms=1,
                             queue_capacity=8, name="flightdl")
    with monitor.flight_recorder(capacity=16, slow_ms=1e9) as rec:
        try:
            blocker = server.submit({"x": _rows(1)})
            time.sleep(0.1)
            fut = server.submit({"x": _rows(1)}, timeout_ms=40, trace_id="dead000011112222")
            with pytest.raises(DeadlineExceeded):
                fut.result()
            blocker.result(timeout=5)
            deadline = time.monotonic() + 5
            while rec.get_record("dead000011112222") is None and time.monotonic() < deadline:
                time.sleep(0.01)
            record = rec.get_record("dead000011112222")
            assert record is not None and record["status"] == "deadline"
        finally:
            server.stop()


def test_trace_id_propagates_client_to_executor_spans(mlp_dir):
    server = InferenceServer(_mlp_predictor(mlp_dir), max_batch_size=4, batch_timeout_ms=1,
                             name="tracey")
    try:
        server.warmup()
        cli = Client(server)
        with monitor.trace_session() as sess:
            cli.infer({"x": _rows(2, seed=9)}, trace_id="feedbeef00000001")
        out = cli.infer({"x": _rows(1)})  # the client mints an id when given none
        assert len(out) == 1 and len(cli.last_trace_id) == 16
    finally:
        server.stop()
    by_name = {}
    for s in sess.spans:
        if "feedbeef00000001" in (s.get("trace_ids") or ()):
            by_name.setdefault(s["name"], []).append(s)
    for name in ("serving/client_infer", "serving/queue_wait", "predictor/run_padded",
                 "serving/materialize", "executor/h2d_feed", "executor/device_execute"):
        assert name in by_name, (name, sorted(by_name))
    assert by_name["serving/client_infer"][0]["dur"] >= by_name["serving/queue_wait"][0]["dur"] >= 0
    assert "serving/tracey/r0 worker" in set(_spans.thread_lanes().values())


def test_openmetrics_exemplar_links_latency_bucket_to_trace(mlp_dir):
    server = InferenceServer(_mlp_predictor(mlp_dir), max_batch_size=2, batch_timeout_ms=1,
                             name="exemplary")
    try:
        server.warmup()
        Client(server).infer({"x": _rows(1)}, trace_id="cafe000011112222")
        text = monitor.render_openmetrics()
        lat = [line for line in text.splitlines()
               if line.startswith("serving_request_latency_seconds_bucket")
               and 'server="exemplary"' in line]
        assert any('# {trace_id="cafe000011112222"}' in line for line in lat)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# the ladder autotuner
# ---------------------------------------------------------------------------
def _tune_storm(cli, sizes, repeats, seed=0):
    rng = np.random.RandomState(seed)
    for i in range(repeats):
        n = sizes[i % len(sizes)]
        cli.infer({"x": rng.uniform(-1, 1, (n, IN_DIM)).astype(np.float32)})


def test_online_replan_builds_no_entry_under_a_request(mlp_dir):
    preds = [_mlp_predictor(mlp_dir), _mlp_predictor(mlp_dir)]
    srv = InferenceServer(preds, max_batch_size=16, batch_timeout_ms=1, queue_capacity=64,
                          name="tune-srv")
    try:
        srv.warmup()
        assert srv.bucket_ladder == [1, 2, 4, 8, 16]
        cli = Client(srv)
        sizes = (3, 3, 5, 3)  # off the power-of-two rungs

        def waste():
            m = srv.metrics()
            return m["padded_rows"], m["rows"]

        _tune_storm(cli, sizes, 40, seed=1)
        padded1, valid1 = waste()
        w1 = 1 - valid1 / padded1
        assert w1 > 0
        result = srv.replan_ladder()
        assert result["changed"] and 3 in result["ladder"] and 5 in result["ladder"]
        assert result["barrier_compiles"] == 2 * 2  # rungs 3 and 5 on both replicas
        assert srv.metrics()["ladder_replans"] == 1
        misses0 = [p.jit_cache_stats()["misses"] for p in preds]
        _tune_storm(cli, sizes, 40, seed=2)
        padded2, valid2 = waste()
        assert srv.metrics()["recompiles"] == 0
        assert [p.jit_cache_stats()["misses"] for p in preds] == misses0
        assert 1 - (valid2 - valid1) / (padded2 - padded1) < w1
        assert not srv.replan_ladder()["changed"]  # the same histogram: no change
        assert srv.metrics()["ladder_replans"] == 1
    finally:
        srv.stop(drain=True)


def test_periodic_autotuner_thread(mlp_dir):
    srv = InferenceServer(_mlp_predictor(mlp_dir), max_batch_size=8, batch_timeout_ms=1,
                          queue_capacity=64, name="tune-thread")
    try:
        srv.warmup()
        cli = Client(srv)
        _tune_storm(cli, (3,), 20, seed=4)
        srv.start_autotuner(interval_s=0.1)
        thread = srv._autotune_thread
        srv.start_autotuner(interval_s=0.1)  # idempotent
        assert srv._autotune_thread is thread
        deadline = time.monotonic() + 10.0
        while srv.metrics()["ladder_replans"] == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.metrics()["ladder_replans"] >= 1 and 3 in srv.bucket_ladder
        _tune_storm(cli, (3,), 10, seed=5)
        assert srv.metrics()["recompiles"] == 0
    finally:
        srv.stop(drain=True)  # joins the tuner thread
    assert not thread.is_alive()


def test_replan_explicit_ladder_validates(mlp_dir):
    srv = InferenceServer(_mlp_predictor(mlp_dir), max_batch_size=8, batch_timeout_ms=1,
                          name="tune-explicit")
    try:
        srv.warmup()
        with pytest.raises(ValueError):
            srv.replan_ladder(ladder=[1, 2, 4])  # must top out at max
        out = srv.replan_ladder(ladder=[2, 8], batch_timeout_ms=3.0)
        assert out["ladder"] == [2, 8] and srv.metrics()["batch_timeout_ms"] == 3.0
        _tune_storm(Client(srv), (1, 2), 8, seed=6)
        assert srv.metrics()["recompiles"] == 0
    finally:
        srv.stop(drain=True)


def test_load_and_replica_stats_shape():
    server = InferenceServer([SlowPredictor(), SlowPredictor()], max_batch_size=2,
                             queue_capacity=8, name="shape")
    try:
        assert set(server.load()) == {"queue_depth", "admit_limit", "brownout_level"}
        stats = server.replica_stats()
        assert set(stats) == {"r0", "r1"}
        assert set(stats["r0"]) == {"alive", "in_flight", "executed", "failed", "nonblocking"}
        assert stats["r0"]["nonblocking"] is False  # the stub's run_padded takes no return_numpy
        assert server.num_replicas == 2
        with pytest.raises(ValueError, match="at least one predictor"):
            InferenceServer([], name="empty")
    finally:
        server.stop()
