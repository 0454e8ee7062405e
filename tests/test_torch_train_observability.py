"""paddle_tpu_torch's training control tower (monitor/train.py) and
Executor.train_from_dataset's six observability and checkpoint arguments,
against the JAX package's: under one injected clock the same ledger calls
give the same phase totals and step table, the same loss series gives the
same anomalies, the same Program gives the same static FLOPs (desc
parity), the step logs replay alike; then the port's executor under the
control tower on the CPU: the ledger's phases sum to the epoch, spans
carry the epoch's trace id, the admin endpoints answer, NaN halts typed."""
import json
import math
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.monitor import train as jtrain
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.monitor import spans as tspans
from paddle_tpu_torch.monitor import train as ttrain


class _Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _fake_time(clock):
    return types.SimpleNamespace(perf_counter=clock, time=clock, monotonic=clock)


def _ledger_run(mod, monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", _fake_time(clock))
    led = mod.StepPhaseLedger(peak_flops=1e12, flops_per_step=2e9, metrics=False)
    led.begin_epoch()
    rows = []
    for step in range(5):
        tok = led.window_begin()
        clock.t += 0.003  # the wait for the batch
        led.window_end(tok, "data_wait")
        tok = led.window_begin()
        clock.t += 0.001
        led.charge("h2d", 0.001)  # a nested charge: excluded from the window
        clock.t += 0.010
        led.window_end(tok, "device_execute")
        if step == 2:
            tok = led.window_begin()
            clock.t += 0.050
            led.window_end(tok, "checkpoint", detail="sync")
        clock.t += 0.0005
        rows.append(led.step_done(step, 0.0145, examples=8, loss=1.0 / (step + 1)))
    tok = led.window_begin()
    clock.t += 0.02
    led.window_end(tok, "checkpoint", detail="commit")
    led.finish_epoch()
    snap = led.snapshot()
    return rows, snap


def test_ledgers_agree_under_one_clock(monkeypatch):
    jrows, jsnap = _ledger_run(jtrain, monkeypatch)
    trows, tsnap = _ledger_run(ttrain, monkeypatch)
    assert trows == jrows
    assert tsnap == jsnap
    assert tsnap["phases"]["device_execute"] == pytest.approx(0.05)
    assert tsnap["checkpoint"] == {"sync_s": 0.05, "commit_s": 0.02}
    assert sum(tsnap["phases"].values()) == pytest.approx(tsnap["wall_s"])


def test_ledger_overcount_raises_alike(monkeypatch):
    for mod in (jtrain, ttrain):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", _fake_time(clock))
        led = mod.StepPhaseLedger(metrics=False, peak_flops=1.0)
        led.begin_epoch()
        clock.t += 1.0
        led.charge("h2d", 5.0)  # more than the wall clock: charged twice somewhere
        with pytest.raises(AssertionError, match="overcount"):
            led.finish_epoch()


LOSSES = [2.0, 1.9, 1.85, 1.8, 1.7, 1.72, 1.69, 1.66, 1.6, 1.61, 1.58, 9.5, 1.55, float("nan"),
          1.5]
TIMES = [0.05] * 10 + [0.4, 0.05, 0.05, 0.05, 0.05]


@pytest.mark.parametrize("halt_on", [("nan_loss",), ()])
def test_watchdogs_agree(halt_on):
    out = []
    for mod in (jtrain, ttrain):
        clock = _Clock()
        wd = mod.TrainWatchdog(warmup_steps=4, z_threshold=4.0, halt_on=halt_on, clock=clock)
        found, halted = [], None
        for step, (loss, t) in enumerate(zip(LOSSES, TIMES)):
            clock.t += 1
            got = wd.observe_step(step, loss=loss, grad_norm=1.0 + 0.01 * step, step_time_s=t)
            found.extend(got)
            try:
                wd.raise_if_halt(got)
            except mod.TrainAnomalyError as e:
                halted = (e.kind, e.step)
        state = wd.state()
        out.append((found, halted, state["halted"], state["steps_observed"]))
    assert out[0] == out[1]
    kinds = {a["kind"] for a in out[1][0]}
    assert {"nan_loss", "loss_spike", "step_time_regression"} <= kinds
    assert (out[1][1] is not None) == bool(halt_on)


def _lenet(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [1, 28, 28])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        c = fluid.layers.conv2d(img, 6, 5, act="relu")
        p = fluid.layers.pool2d(c, 2, pool_stride=2)
        fc = fluid.layers.fc(p, 10)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(fc, lbl))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main


def _lm(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [16], dtype="int64")
        labels = fluid.layers.data("labels", [16, 1], dtype="int64")
        from importlib import import_module

        transformer = import_module(fluid.__name__ + ".models.transformer")
        loss, _ = transformer.transformer_lm(ids, labels, vocab_size=50, d_model=32, n_layer=2,
                                             n_head=2, d_inner=64, max_pos=64, seq_len=16,
                                             dropout_rate=0.0, fused_attention=True)
        fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main


@pytest.mark.parametrize("build", [_lenet, _lm], ids=["lenet", "lm"])
@pytest.mark.parametrize("batch", [1, 8])
def test_static_flops_agree_by_desc(build, batch):
    j = jtrain.estimate_block_flops(build(jfluid), batch=batch)
    t = ttrain.estimate_block_flops(build(tfluid), batch=batch)
    assert t == j and t > 0


def test_batch_examples_agree():
    for feed in ({"x": np.zeros((5, 3))}, {"a": [1, 2, 3]}, {}, None, {"s": np.float32(1)}):
        assert ttrain.batch_examples(feed) == jtrain.batch_examples(feed)


def test_step_logs_replay_alike(tmp_path):
    recs = [{"step": i, "duration_s": 0.01 * (i + 1), "examples": 4,
             "phases": {"device_execute": 0.008, "h2d": 0.001}, "loss": 1.0 / (i + 1)}
            for i in range(6)]
    recs[3]["anomalies"] = [{"kind": "loss_spike", "step": 3}]
    out = []
    for mod, name in ((jtrain, "j.jsonl"), (ttrain, "t.jsonl")):
        path = str(tmp_path / name)
        log = mod.StepLog(path)
        for r in recs:
            log.write(r)
        log.write({"event": "train/resume", "step": 3})
        log.close()
        doc = mod.replay_step_log(path)
        doc.pop("path")
        out.append(doc)
    assert out[0] == out[1] and out[1]["n_steps"] == 6 and len(out[1]["events"]) == 1


def test_peak_flops_for_the_card(monkeypatch):
    import torch

    monkeypatch.delenv("PADDLE_TPU_PEAK_FLOPS", raising=False)
    assert ttrain._default_peak_flops("cpu") == jtrain._default_peak_flops() == 1e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    assert ttrain._default_peak_flops("cuda:0") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert ttrain._default_peak_flops("cuda:0") is None
    led = ttrain.StepPhaseLedger(device="cuda:0", metrics=False, flops_per_step=1e9)
    led.begin_epoch()
    led.step_done(0, 0.1)
    assert led.snapshot()["mfu_ratio"] == 0.0 and led.peak_flops is None
    monkeypatch.setenv("PADDLE_TPU_PEAK_FLOPS", "5e12")
    assert ttrain._default_peak_flops("cuda:0") == 5e12


def _reg_program():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 9
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.data("y", [1])
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(tfluid.layers.fc(x, 1), y))
        tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return main, startup, loss


def _feeds(n, nan_at=None):
    rng = np.random.RandomState(1)
    out = []
    for i in range(n):
        x = rng.rand(4, 4).astype("float32")
        if i == nan_at:
            x[0, 0] = np.nan
        out.append({"x": x, "y": x.sum(1, keepdims=True)})
    return out


@pytest.fixture
def tower_run(tmp_path):
    main, startup, loss = _reg_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    runs0 = tmonitor.counter_value("executor_runs_total")
    log = str(tmp_path / "steps.jsonl")
    with tmonitor.trace_session() as sess:
        out = exe.train_from_dataset(main, _feeds(6), scope=scope, thread=2, fetch_list=[loss],
                                     phase_ledger=True, watchdog=True, train_log=log,
                                     trace_id="epoch-1", checkpoint_dir=str(tmp_path / "ck"),
                                     checkpoint_every=2, checkpoint_async=True)
    return exe, sess, out, log, runs0


def test_train_from_dataset_under_the_control_tower(tower_run):
    exe, sess, out, log, runs0 = tower_run
    assert len(out) == 6
    snap = exe.trainz()["ledger"]
    assert snap["finished"] and snap["n_steps"] == 6 and len(snap["steps"]) == 6
    assert sum(snap["phases"].values()) == pytest.approx(snap["wall_s"], rel=0.01)
    assert snap["phases"]["device_execute"] > 0 and snap["checkpoint"]["sync_s"] > 0
    assert snap["flops_per_step"] == ttrain.estimate_block_flops(
        exe_program := _reg_program()[0], batch=4) and exe_program
    assert [c["step"] for c in exe.trainz()["checkpoint"]["history"]] == [2, 4, 6]
    assert exe.last_train_trace_id == "epoch-1" and exe.trainz()["trace_id"] == "epoch-1"
    recs = [json.loads(ln) for ln in open(log)]
    assert [r["step"] for r in recs] == list(range(6))
    assert all(r["trace_id"] == "epoch-1" and "loss" in r for r in recs)
    assert tmonitor.counter_value("executor_runs_total") - runs0 == 6


def test_the_epochs_spans_carry_its_trace_id(tower_run):
    _, sess, _, _, _ = tower_run
    steps = [s for s in sess.spans if s["name"] == "executor/train_step"]
    epoch = [s for s in sess.spans if s["name"] == "executor/train_epoch"]
    assert len(steps) == 6 and len(epoch) == 1
    assert all(s["trace_ids"] == ["epoch-1"] or s["trace_ids"] == ("epoch-1",) for s in steps)
    assert all(s["parent"] == epoch[0]["id"] for s in steps)
    phases = {s["name"] for s in sess.spans if s.get("parent") in {st["id"] for st in steps}}
    assert {"executor/h2d_feed", "executor/device_execute", "executor/d2h_fetch"} <= phases


def test_the_train_admin_endpoints(tower_run):
    exe = tower_run[0]
    host, port = exe.start_train_admin(port=0)
    try:
        assert exe.start_train_admin() == (host, port)  # a repeat start reuses it
        base = "http://%s:%d" % (host, port)

        def get(path, accept=None):
            req = urllib.request.Request(base + path, headers={"Accept": accept} if accept else {})
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read().decode()

        st, ct, body = get("/metrics")
        assert st == 200 and "train_phase_seconds_total" in body and "executor_runs_total" in body
        _, ct, body = get("/metrics", accept="application/openmetrics-text")
        assert "openmetrics" in ct and body.rstrip().endswith("# EOF")
        trainz = json.loads(get("/trainz")[2])
        assert trainz["role"] == "trainer" and len(trainz["ledger"]["steps"]) == 6
        for path in ("/statusz", "/tracez", "/eventz", "/healthz"):
            assert get(path)[0] == 200
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        exe.stop_train_admin()
    assert exe.train_admin_address is None


def test_a_nan_loss_halts_typed_after_it_is_logged(tmp_path):
    main, startup, loss = _reg_program()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    log = str(tmp_path / "steps.jsonl")
    with pytest.raises(ttrain.TrainAnomalyError) as e:
        exe.train_from_dataset(main, _feeds(6, nan_at=3), scope=scope, fetch_list=[loss],
                               phase_ledger=True, watchdog=True, train_log=log)
    assert e.value.kind == "nan_loss" and e.value.step == 3
    recs = [json.loads(ln) for ln in open(log)]
    assert recs[-1]["step"] == 3 and recs[-1]["anomalies"][0]["kind"] == "nan_loss"
    assert exe._train_ledger is None  # run()'s charges disarmed on the way out


def test_trainz_docs_agree_for_a_bare_executor():
    j = jtrain.trainz_doc(jfluid.Executor(jfluid.CPUPlace()))
    t = ttrain.trainz_doc(tfluid.Executor(tfluid.CPUPlace()))
    assert t["checkpoint"].pop("history") == []
    assert t == j


def test_executor_phase_spans_match_the_jax_package():
    """The same three runs under a trace session record the same phase
    span names, less the JAX package's XLA trace and compile (the port
    traces and compiles nothing on the CPU; on the card its capture is
    executor/jit_compile)."""
    names = []
    for fluid, mon in ((jfluid, __import__("paddle_tpu.monitor", fromlist=["x"])), (tfluid, tmonitor)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [4])
            out = fluid.layers.fc(x, 2)
        exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            with mon.trace_session() as sess:
                for _ in range(3):
                    exe.run(main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[out])
        names.append({s["name"] for s in sess.spans})
    assert names[1] == names[0] - {"executor/jit_compile", "lowering/trace_block"}


def test_executor_counters_survive_a_finalizer_inside_their_lock():
    """A dead executor's finalizer can run in a garbage collection that
    fires while its thread holds the counters' lock (a scrape summing
    them): it must not wait for that lock, and its runs stay counted."""
    import threading

    from paddle_tpu_torch import executor as texecutor

    main, startup, _ = _reg_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=tfluid.Scope())
    runs0 = tmonitor.counter_value("executor_runs_total")
    stats = exe._cache_stats

    def collect_inside_the_lock():
        with texecutor._exec_stats_lock:
            texecutor._retire_exec_stats(stats)  # as a collection would call it

    t = threading.Thread(target=collect_inside_the_lock, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert tmonitor.counter_value("executor_runs_total") == runs0
    assert not any(d is stats for d in texecutor._exec_stats)
