"""The port's ``FleetBalancer`` over serving child processes on the CPU:
children run ``python -m paddle_tpu_torch.serving.wire.launch`` with
``place="cpu"`` (the card is their default; on a box without one a child
that was not asked for the CPU exits before READY).

Held here: the two-child fleet end to end (warmup, no entry built after
it, one merged span tree per request, a child SIGKILLed mid-traffic with
no accepted request lost and the requeue counted), ``rolling_replace``
under traffic, the typed failures (every backend dead, an expired
deadline, ``pipeline_stages`` naming A10), the JAX package's fault drills
against the port's fleet (``wire.send`` corruption, ``fleet.dispatch``
errors, half-open readmission after a heal), and a decode endpoint
written by the JAX package's ``save_decode_endpoint``, streamed by a port
child, giving the JAX package's greedy tokens exactly.

Every child and request has a deadline (``ready_timeout_s``,
``timeout_ms``).  The MLP's answers are held to the in-process port
predictor within 1e-5 (fp32, the same kernels on the same CPU).
"""
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import faults, monitor
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.serving import wire
from paddle_tpu_torch.serving.errors import DeadlineExceeded, ServingError
from paddle_tpu_torch.serving.server import InferenceServer
from paddle_tpu_torch.serving.wire import fleet as fleet_mod

IN_DIM, OUT_DIM = 16, 4
TOL = 1e-5
READY_S = 120.0
CHILD = dict(max_batch_size=4, batch_timeout_ms=2, queue_capacity=256, place="cpu",
             ready_timeout_s=READY_S)


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()


def _rows(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, IN_DIM)).astype("float32")


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fleet") / "mlp")
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 7
    with tfluid.program_guard(prog, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [IN_DIM])
        h = tfluid.layers.fc(x, 32, act="relu")
        pred = tfluid.layers.fc(h, OUT_DIM, act="softmax")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(d, ["x"], [pred], exe, main_program=prog, scope=scope)
    return d


@pytest.fixture(scope="module")
def mlp_ref(mlp_dir):
    cfg = AnalysisConfig(mlp_dir)
    cfg.disable_gpu()
    pred = create_paddle_predictor(cfg)
    return lambda x: np.asarray(pred.run({"x": x})[0])


class StubPredictor:
    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return ["y"]

    def input_specs(self):
        return {"x": ((IN_DIM,), np.dtype("float32"))}

    def jit_cache_stats(self):
        return {"entries": 0, "hits": 0, "misses": 0}

    def run_padded(self, feed, n_valid=None):
        return [np.asarray(feed["x"][:n_valid]).sum(axis=1, keepdims=True)]


def _stub_wire_server(name, **kw):
    srv = InferenceServer(StubPredictor(), max_batch_size=8, batch_timeout_ms=1, name=name, **kw)
    sp = wire.ServingProcess(srv)
    sp.start()
    return sp


def _statusz(be):
    host, port = be.transport.address
    return json.load(urllib.request.urlopen("http://%s:%d/statusz" % (host, port), timeout=10))


def _storm(fleet, ref, n_threads, seed0):
    """Client threads sending mixed-size requests until ``stop`` is set:
    (stop event, threads, completed count, errors)."""
    errs, completed, lock = [], [0], threading.Lock()
    stop = threading.Event()

    def run(t):
        rng = np.random.RandomState(seed0 + t)
        i = 0
        while not stop.is_set():
            n = 1 + (t + i) % 3
            i += 1
            x = rng.rand(n, IN_DIM).astype("float32")
            try:
                out, = fleet.infer({"x": x}, timeout_ms=15000)
                np.testing.assert_allclose(out, ref(x), rtol=0, atol=TOL)
                with lock:
                    completed[0] += 1
            except Exception as e:  # noqa: BLE001 — the assertion target
                errs.append(repr(e))
                return

    threads = [threading.Thread(target=run, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    return stop, threads, completed, errs


# ---------------------------------------------------------------------------
# the process fleet
# ---------------------------------------------------------------------------
def test_process_fleet_end_to_end(mlp_dir, mlp_ref):
    """Two CPU children: fleet-wide warmup, one merged span tree per
    request under one trace id, a child SIGKILLed mid-traffic with every
    accepted request answered (requeued to the survivor, counted), and no
    entry built after warmup on the survivor."""
    fleet = wire.FleetBalancer.from_launch(
        mlp_dir, n=2, name="t-acceptfleet",
        launch_kwargs=dict(CHILD, flight_slow_ms=0.0), health_interval_s=0.5)
    try:
        assert fleet.warmup() > 0 and fleet.metrics()["warmed_up"]
        fr = monitor.flight_recorder(slow_ms=0.0)
        try:
            x = _rows(3, seed=9)
            out, = fleet.infer({"x": x}, timeout_ms=30000)
            np.testing.assert_allclose(out, mlp_ref(x), rtol=0, atol=TOL)
            tid = fleet.last_trace_id
            rec = fr.get_record(tid)
            assert rec is not None
            spans = rec["spans"]
            names = {s["name"] for s in spans}
            for want in ("serving/client_infer", "wire/request", "wire/server_request",
                         "serving/queue_wait", "predictor/run_padded",
                         "executor/device_execute"):
                assert want in names, (want, sorted(names))
            for s in spans:
                assert s.get("trace_ids") == [tid], s
            by_id = {s["id"]: s for s in spans if s.get("id")}
            ws = next(s for s in spans if s["name"] == "wire/server_request")
            wr = by_id[ws["parent"]]
            assert wr["name"] == "wire/request"
            assert by_id[wr["parent"]]["name"] == "serving/client_infer"
            qw = next(s for s in spans if s["name"] == "serving/queue_wait")
            assert qw["parent"] == ws["id"]
        finally:
            fr.close()

        stop, threads, completed, errs = _storm(fleet, mlp_ref, 4, 300)
        time.sleep(0.5)
        req0 = monitor.counter_value("serving_requeued_total", server="t-acceptfleet")
        victim = next(be for be in fleet._backends if be.handle)
        victim.handle.kill()  # SIGKILL: the lost-process event
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(60)
        assert errs == [], "accepted requests were lost: %s" % errs[:3]
        assert completed[0] > 20
        assert monitor.counter_value("serving_requeued_total", server="t-acceptfleet") > req0
        stats = fleet.backend_stats()
        assert sum(1 for b in stats.values() if b["alive"]) == 1, stats
        survivor = next(be for be in fleet._backends
                        if be.alive and be.handle and be.handle.poll() is None)
        doc = _statusz(survivor)
        assert doc["metrics"]["recompiles"] == 0 and doc["metrics"]["completed"] > 0
        assert doc["hand_kernels"] == {}  # the CPU runs the plain versions, no kernel
    finally:
        fleet.stop(shutdown_backends=True)
    assert _flight.get() is None
    assert all(be.handle.poll() is not None for be in fleet._backends)


def test_rolling_replace_under_traffic(mlp_dir, mlp_ref):
    """Each child is replaced by a warmed fresh one while traffic flows:
    no request lost, the old children exit 0, the new ones build nothing
    after their warmup."""
    fleet = wire.FleetBalancer.from_launch(mlp_dir, n=2, name="t-rollfleet",
                                           launch_kwargs=CHILD, health_interval_s=None)
    try:
        fleet.warmup()
        olds = [be.handle for be in fleet._backends]
        stop, threads, completed, errs = _storm(fleet, mlp_ref, 3, 500)
        time.sleep(0.3)
        fresh = fleet.rolling_replace(drain_timeout_s=30.0)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(60)
        assert errs == [] and completed[0] > 0
        assert len(fresh) == 2 and all(h.poll() is None for h in fresh)
        assert [h.wait(30) for h in olds] == [0, 0]
        assert fleet.num_backends == 2
        for be in fleet._backends:
            if be.alive:
                doc = _statusz(be)
                assert doc["metrics"]["recompiles"] == 0
                assert doc["metrics"]["warmed_up"] is True
    finally:
        fleet.stop(shutdown_backends=True)
    assert all(h.poll() == 0 for h in fresh)


def test_child_without_cpu_place_refuses_to_start_on_a_cardless_box(mlp_dir):
    """No CPU fallback: the child's default place is the card, so on this
    box it exits before READY and ``launch_server`` raises with its
    stderr tail."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA card: the child would start on it")
    with pytest.raises(RuntimeError, match="failed before ready") as got:
        wire.launch_server(mlp_dir, name="t-nocard", ready_timeout_s=READY_S)
    assert "CUDA" in str(got.value) and "CPUPlace" in str(got.value)


def test_launch_refusals_name_what_they_wait_for(mlp_dir):
    with pytest.raises(NotImplementedError, match="A10"):
        wire.launch_server(mlp_dir, pipeline_stages=2, place="cpu")
    with pytest.raises(ValueError, match="place"):
        wire.launch_server(mlp_dir, place="tpu")


# ---------------------------------------------------------------------------
# typed failures over in-process wire servers (fast)
# ---------------------------------------------------------------------------
def test_fleet_all_backends_dead_fails_typed():
    sp = _stub_wire_server("t-lone")
    fleet = wire.FleetBalancer([sp.address], name="t-lonefleet", health_interval_s=None)
    fleet.infer({"x": _rows(1)})
    sp.stop(drain=False)
    for _ in range(fleet_mod._BACKEND_FAIL_LIMIT + 1):
        with pytest.raises(ServingError):
            fleet.infer({"x": _rows(1)}, timeout_ms=5000)
    assert fleet.num_backends == 0
    with pytest.raises(ServingError, match="no live backends"):
        fleet.infer({"x": _rows(1)})
    fleet.stop()


def test_fleet_expired_deadline_stays_typed_and_does_not_retire():
    sp = _stub_wire_server("t-dl")
    fleet = wire.FleetBalancer([sp.address], name="t-dlfleet", health_interval_s=None)
    try:
        fleet.infer({"x": _rows(1)})
        for _ in range(fleet_mod._BACKEND_FAIL_LIMIT + 1):
            with pytest.raises(DeadlineExceeded):
                fleet.infer({"x": _rows(1)}, timeout_ms=0.0001)
        stats = fleet.backend_stats()
        assert all(b["alive"] and b["failed"] == 0 for b in stats.values()), stats
        fleet.infer({"x": _rows(1)})
    finally:
        fleet.stop()
        sp.stop()


def test_fleet_requeues_off_a_stopped_in_process_backend():
    sps = [_stub_wire_server("t-fb%d" % i) for i in range(2)]
    fleet = wire.FleetBalancer([sp.address for sp in sps], name="t-stubfleet",
                               health_interval_s=0.2)
    ref = lambda x: x.sum(axis=1, keepdims=True)  # noqa: E731
    try:
        stop, threads, completed, errs = _storm(fleet, ref, 4, 0)
        time.sleep(0.25)
        req0 = monitor.counter_value("serving_requeued_total", server="t-stubfleet")
        sps[0].stop(drain=False)
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(60)
        assert errs == [] and completed[0] > 0
        assert monitor.counter_value("serving_requeued_total", server="t-stubfleet") > req0
        assert monitor.counter_value("wire_backend_retired_total", fleet="t-stubfleet") >= 1
        fleet.infer({"x": _rows(1)})
    finally:
        fleet.stop()
        sps[1].stop()


# ---------------------------------------------------------------------------
# the JAX package's chaos drills (tests/chaos/test_chaos_serving.py) on the port
# ---------------------------------------------------------------------------
def test_wire_send_corruption_requeues_and_completes():
    sps = [_stub_wire_server("t-cor%d" % i) for i in range(2)]
    fleet = wire.FleetBalancer([sp.address for sp in sps], name="t-corruptfleet",
                               health_interval_s=None)
    try:
        fleet.infer({"x": _rows(1)})
        req0 = monitor.counter_value("serving_requeued_total", server="t-corruptfleet")
        f0 = monitor.counter_value("faults_injected_total", point="wire.send")
        with faults.armed("wire.send=corrupt,times=2"):
            x = _rows(3, seed=1)
            out, = fleet.infer({"x": x}, timeout_ms=15000)
        np.testing.assert_allclose(out, x.sum(axis=1, keepdims=True), rtol=1e-6)
        assert monitor.counter_value("faults_injected_total", point="wire.send") - f0 == 2
        assert monitor.counter_value("serving_requeued_total", server="t-corruptfleet") - req0 >= 1
    finally:
        fleet.stop()
        for sp in sps:
            sp.stop()


def test_fleet_dispatch_error_injection_never_leaks_inflight_slot():
    sp = _stub_wire_server("t-slot")
    fleet = wire.FleetBalancer([sp.address], name="t-slotfleet", health_interval_s=None,
                               max_in_flight=1)
    try:
        fleet.infer({"x": _rows(1)})
        with faults.armed("fleet.dispatch=error:ConnectionError,times=2"):
            for _ in range(2):
                with pytest.raises(ConnectionError):
                    fleet.infer({"x": _rows(1)}, timeout_ms=5000)
        out, = fleet.infer({"x": _rows(2, seed=9)}, timeout_ms=5000)
        assert out.shape == (2, 1)
        with fleet._route_cv:
            assert all(b.in_flight == 0 for b in fleet._backends)
    finally:
        fleet.stop()
        sp.stop()


def test_retired_wire_backend_readmitted_after_heal():
    sp = _stub_wire_server("t-ho")
    fleet = wire.FleetBalancer([sp.address], name="t-halfopen", health_interval_s=0.1,
                               cooldown_s=0.3)
    try:
        fleet.infer({"x": _rows(1)})
        h0 = monitor.counter_value("backend_halfopen_probes_total", pool="fleet/t-halfopen")
        with faults.armed("wire.send=error:BackendUnavailable,times=3"):
            while fleet.num_backends:
                with pytest.raises(ServingError):
                    fleet.infer({"x": _rows(1)}, timeout_ms=2000)
        assert monitor.counter_value("wire_backend_retired_total", fleet="t-halfopen") >= 1
        deadline = time.monotonic() + 10
        while fleet.num_backends == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fleet.num_backends == 1
        assert monitor.counter_value("backend_halfopen_probes_total",
                                     pool="fleet/t-halfopen") > h0
        out, = fleet.infer({"x": _rows(2, seed=4)})
        assert out.shape == (2, 1)
    finally:
        fleet.stop()
        sp.stop()


# ---------------------------------------------------------------------------
# a JAX-written decode endpoint streamed by a port child
# ---------------------------------------------------------------------------
LM = dict(vocab_size=23, d_model=16, n_layer=2, n_head=2, d_inner=32)
EOS = 9
PROMPTS = [[2, 3, 4], [5], [7, 8], [11, 12, 13, 14]]
CAPS = [10, 6, 12, 8]


def test_jax_decode_endpoint_streamed_by_a_port_child(tmp_path):
    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving import decode as jdecode

    state = jdec.random_transformer_lm_state(np.random.RandomState(7), vocab=LM["vocab_size"],
                                             d_model=16, n_layer=2, n_head=2, d_inner=32,
                                             max_pos=32)
    d = jdecode.save_decode_endpoint(str(tmp_path / "lm"), state, eos_id=EOS, max_seq_len=32,
                                     max_slots=2, steps_per_tick=3, **LM)
    jsrv = jdecode.load_decode_endpoint(d)
    jsrv.warmup(configure_cache=False)
    try:
        reqs = [jsrv.submit({"tokens": np.array(p, np.int32)}, max_new_tokens=c)
                for p, c in zip(PROMPTS, CAPS)]
        want = [np.asarray(r.result(timeout=120.0)[0]).tolist() for r in reqs]
    finally:
        jsrv.stop(drain=False)
    handle = wire.launch_server(d, name="t-lm", place="cpu", ready_timeout_s=READY_S)
    fleet = None
    try:
        cli = wire.RemoteClient(handle.address)
        assert cli.healthz()["streaming"] is True
        for p, c, w in zip(PROMPTS, CAPS, want):
            chunks = list(cli.infer_stream({"tokens": np.array(p, np.int32)}, max_new_tokens=c,
                                           timeout_ms=60000))
            assert len(chunks) >= 2
            assert np.concatenate(chunks).tolist() == w
            assert cli.last_stream_final["chunks"] == len(chunks)
        fleet = wire.FleetBalancer([handle], name="t-lmfleet", health_interval_s=None)
        chunks = list(fleet.infer_stream({"tokens": np.array(PROMPTS[2], np.int32)},
                                         max_new_tokens=CAPS[2], timeout_ms=60000))
        assert np.concatenate(chunks).tolist() == want[2]
        cli.close()
    finally:
        if fleet is not None:
            fleet.stop()
        assert handle.shutdown(timeout_s=30) == 0
