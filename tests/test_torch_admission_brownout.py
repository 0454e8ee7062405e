"""The port's overload control on the CPU: the brownout ladder
(``serving.admission.BrownoutController``), the queue's pressure and retry
hints, the batcher's eager mode and precision grouping, and the
``InferenceServer`` behaviours they drive (priority shedding, the
admission-time deadline fail-fast, the L3 door shed and its descent).
The ladder is held to the JAX package's controller on the same seeded
(ratio, clock) series.  The predictors are host stubs: these paths run
no kernel.
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import admission as jadmission
from paddle_tpu_torch import monitor, serving
from paddle_tpu_torch.serving import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AdmissionQueue,
    BrownoutController,
    DeadlineExceeded,
    DynamicBatcher,
    InferenceServer,
    ServerOverloaded,
    ServingRequest,
)

IN_DIM = 16


class Req:
    """Duck-typed queue entry: the attributes admission reads."""

    def __init__(self, deadline=None, priority=PRIORITY_NORMAL, tag=None):
        self.deadline = deadline
        self.priority = priority
        self.submit_t = time.perf_counter()
        self.tag = tag
        self.error = None

    def fail(self, e):
        self.error = e


class SlowPredictor:
    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s

    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return ["y"]

    def input_specs(self):
        return {"x": ((IN_DIM,), np.dtype("float32"))}

    def jit_cache_stats(self):
        return {"entries": 0, "hits": 0, "misses": 0}

    def run_padded(self, feed, n_valid=None):
        if self.delay_s:
            time.sleep(self.delay_s)
        return [np.asarray(feed["x"][:n_valid]).sum(axis=1, keepdims=True)]


def _rows(n, seed=0):
    return np.random.RandomState(seed).uniform(-1, 1, (n, IN_DIM)).astype("float32")


def _sreq(n=1, deadline_ms=None, priority=PRIORITY_NORMAL, precision=None):
    deadline = time.monotonic() + deadline_ms / 1e3 if deadline_ms is not None else None
    return ServingRequest({"x": np.zeros((n, 4), np.float32)}, n, deadline, priority=priority,
                          precision=precision)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------
def test_brownout_ladder_climbs_one_rung_after_hold():
    clk = [100.0]
    b = BrownoutController("ladder", hold_s=1.0, clock=lambda: clk[0])
    assert b.update(0.95) == 0          # pending, not yet held
    clk[0] += 0.5
    assert b.update(0.95) == 0          # still inside hold_s
    clk[0] += 0.6
    assert b.update(0.95) == 1          # held >= hold_s: one rung
    assert b.update(0.95) == 1          # the transition re-arms the hold
    clk[0] += 1.1
    assert b.update(0.95) == 2
    assert b.update(0.95) == 2
    clk[0] += 1.1
    assert b.update(0.95) == 3
    clk[0] += 1.1
    assert b.update(0.95) == 3          # MAX_LEVEL caps the ladder
    assert monitor.REGISTRY.value("serving_brownout_level", server="ladder") == 3
    b.close()


def test_brownout_descends_slower_than_it_climbs():
    clk = [0.0]
    b = BrownoutController("hyst", hold_s=1.0, clock=lambda: clk[0])
    b.update(0.95)
    clk[0] += 1.1
    assert b.update(0.95) == 1
    assert b.update(0.0) == 1           # descent needs 4x the hold
    clk[0] += 2.0
    assert b.update(0.0) == 1
    clk[0] += 2.5
    assert b.update(0.0) == 0
    b.close()


def test_brownout_blip_does_not_flap():
    clk = [0.0]
    b = BrownoutController("blip", hold_s=1.0, clock=lambda: clk[0])
    b.update(0.95)
    clk[0] += 0.5
    b.update(0.0)   # the blip ends: the pending ascent resets
    clk[0] += 0.6
    assert b.update(0.95) == 0
    b.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brownout_ladder_matches_the_jax_package(seed):
    """The same (ratio, clock) series through both packages' controllers
    gives the same level after every sample."""
    rng = np.random.RandomState(seed)
    clk = [0.0]
    ours = BrownoutController("parity%d" % seed, hold_s=0.3, clock=lambda: clk[0])
    ref = jadmission.BrownoutController("parity%d" % seed, hold_s=0.3, clock=lambda: clk[0])
    levels = []
    for _ in range(400):
        clk[0] += float(rng.uniform(0.0, 0.2))
        ratio = float(rng.choice([0.0, 0.4, 0.6, 0.8, 0.95, 1.0]))
        a, b = ours.update(ratio), ref.update(ratio)
        assert a == b
        levels.append(a)
    assert set(levels) >= {0, 1}  # the series moved the ladder
    ours.close()
    ref.close()


def test_cache_only_rung_raises_naming_a8b_part2():
    """A8b part 2 is ported: the 4-rung ladder builds (it raised naming A8b
    part 2 before) and climbs to the cache-only rung level for level with
    the JAX package's, and an InferenceServer given an embedding cache
    builds it; a descending ladder still raises."""
    from paddle_tpu_torch.serving.embedding_cache import EmbeddingRowCache

    thresholds = BrownoutController.THRESHOLDS + (BrownoutController.CACHE_ONLY_THRESHOLD,)
    clk = [0.0]
    ours = BrownoutController("l4", hold_s=0.3, clock=lambda: clk[0], thresholds=thresholds)
    ref = jadmission.BrownoutController("l4", hold_s=0.3, clock=lambda: clk[0],
                                        thresholds=thresholds)
    rng = np.random.RandomState(4)
    levels = []
    for _ in range(400):
        clk[0] += float(rng.uniform(0.0, 0.2))
        ratio = float(rng.choice([0.0, 0.6, 0.95, 0.98, 1.0]))
        levels.append(ours.update(ratio))
        assert levels[-1] == ref.update(ratio)
    assert ours.max_level == 4 and 4 in levels
    ours.close()
    ref.close()
    cache = EmbeddingRowCache(capacity_rows=4, name="l4srv")
    srv = InferenceServer(SlowPredictor(), embedding_cache=cache, name="l4srv")
    try:
        assert srv._brownout.max_level == 4
    finally:
        srv.stop(drain=False)
        cache.close()
    with pytest.raises(ValueError, match="ascend"):
        BrownoutController("bad", thresholds=(0.9, 0.5))


# ---------------------------------------------------------------------------
# the queue's pressure and hints
# ---------------------------------------------------------------------------
def test_depth_ratio_wait_ewma_and_retry_hint():
    q = AdmissionQueue(8, name="ratio", adaptive=False)
    assert q.depth_ratio() == 0.0
    for i in range(6):
        q.offer(Req(tag=i))
    assert q.depth_ratio() == pytest.approx(6 / 8)
    assert q.retry_after_ms() >= 1.0  # never a 0 hint
    time.sleep(0.02)
    with q.cv:
        q.pop_locked()
    assert q.wait_ewma_ms > 0.0
    assert monitor.REGISTRY.value("serving_admit_limit", server="ratio") == 8
    q.close()
    assert "ratio" not in monitor.render_text().split("serving_admit_limit")[-1].split("\n")[0]


def test_unbounded_queue_has_no_pressure():
    q = AdmissionQueue(0, name="unbounded")
    for i in range(50):
        admitted, _, shed, _ = q.offer(Req(tag=i))
        assert admitted and not shed
    assert q.depth_ratio() == 0.0
    q.close()


# ---------------------------------------------------------------------------
# the batcher
# ---------------------------------------------------------------------------
def test_batcher_coalesces_in_deadline_order():
    b = DynamicBatcher(8, 0.0, 16, name="edfbatch")
    late, soon, mid = _sreq(deadline_ms=30000), _sreq(deadline_ms=10000), _sreq(deadline_ms=20000)
    for r in (late, soon, mid):
        b.offer(r)
    assert b.next_batch(threading.Event(), lambda r: None) == [soon, mid, late]
    assert b.depth_ratio() == 0.0
    b.close()


def test_eager_mode_skips_the_coalescing_window():
    b = DynamicBatcher(8, 5000.0, 16, name="eager")  # a 5 s window
    b.eager = True
    b.offer(_sreq())
    t0 = time.perf_counter()
    assert len(b.next_batch(threading.Event(), lambda r: None)) == 1
    assert time.perf_counter() - t0 < 1.0
    b.close()


def test_batches_never_mix_precisions():
    b = DynamicBatcher(8, 0.0, 16, name="precbatch")
    reqs = [_sreq(), _sreq(precision="fp32"), _sreq(), _sreq(precision="fp32")]
    for r in reqs:
        b.offer(r)
    stop = threading.Event()
    seen = []
    while len(seen) < len(reqs):
        batch = b.next_batch(stop, lambda r: None, block=False)
        assert batch, "a queued request was lost"
        assert len({r.precision for r in batch}) == 1
        seen.extend(batch)
    assert sorted(map(id, seen)) == sorted(map(id, reqs))
    b.close()


def test_batcher_default_hooks_fail_typed():
    b = DynamicBatcher(8, 0.0, 1, name="hooks")
    first = _sreq(priority=PRIORITY_LOW)
    b.offer(first)
    b.offer(_sreq(priority=PRIORITY_HIGH))  # evicts `first`
    with pytest.raises(ServerOverloaded) as ei:
        first.result()
    assert ei.value.retry_after_ms is not None
    b.close()


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def test_server_sheds_low_priority_for_high_under_pressure():
    srv = InferenceServer(SlowPredictor(delay_s=0.25), max_batch_size=1, batch_timeout_ms=0,
                          queue_capacity=2, name="prioserver")
    try:
        pipelined = []
        for _ in range(3):  # fill the replica's in-flight slots and the dispatcher
            pipelined.append(srv.submit({"x": _rows(1)}, priority=PRIORITY_LOW))
            wait_until = time.monotonic() + 5.0
            while srv._batcher.qsize() > 0 and time.monotonic() < wait_until:
                time.sleep(0.01)
        assert srv._batcher.qsize() == 0
        queued = [srv.submit({"x": _rows(1)}, priority=PRIORITY_LOW) for _ in range(2)]
        vip = srv.submit({"x": _rows(1)}, priority=PRIORITY_HIGH)
        outcomes = []
        for r in queued:
            try:
                r.result()
                outcomes.append("ok")
            except ServerOverloaded as e:
                outcomes.append("shed")
                assert e.retry_after_ms is not None and e.retry_after_ms >= 1
        assert outcomes.count("shed") == 1  # exactly one low evicted
        vip.result()
        for r in pipelined:
            r.result()
        assert srv.metrics()["shed"] == 1
    finally:
        srv.stop(drain=True)


def test_expired_deadline_fails_fast_at_admission():
    srv = InferenceServer(SlowPredictor(), max_batch_size=4, batch_timeout_ms=0,
                          queue_capacity=8, name="expsrv")
    try:
        before = monitor.counter_value("admission_expired_total", default=0.0, server="expsrv")
        with pytest.raises(DeadlineExceeded):
            srv.submit({"x": _rows(1)}, timeout_ms=-5.0)
        assert monitor.counter_value("admission_expired_total", server="expsrv") == before + 1
        assert srv.metrics()["expired"] >= 1
    finally:
        srv.stop(drain=True)


def test_brownout_level3_sheds_lowest_class_at_the_door():
    srv = InferenceServer(SlowPredictor(), max_batch_size=4, batch_timeout_ms=0,
                          queue_capacity=8, name="l3srv")
    try:
        srv._brownout.level = 3
        with pytest.raises(ServerOverloaded) as ei:
            srv.submit({"x": _rows(1)}, priority=PRIORITY_LOW)
        assert ei.value.retry_after_ms is not None
        srv.submit({"x": _rows(1)}, priority=PRIORITY_NORMAL).result()
        srv.submit({"x": _rows(1)}, priority=PRIORITY_HIGH).result()
    finally:
        srv.stop(drain=True)


def test_brownout_descends_under_low_priority_only_traffic():
    """At L3 the door sheds low priority before anything enqueues, so the
    submit path samples the ladder too, or the level would latch."""
    srv = InferenceServer(SlowPredictor(), max_batch_size=4, batch_timeout_ms=0,
                          queue_capacity=8, name="l3descend", brownout_hold_s=0.05)
    try:
        srv._brownout.level = 3
        deadline = time.monotonic() + 5.0
        accepted = False
        while time.monotonic() < deadline:
            try:
                srv.submit({"x": _rows(1)}, priority=PRIORITY_LOW).result()
                accepted = True
                break
            except ServerOverloaded:
                time.sleep(0.02)
        assert accepted, "brownout latched at L3 under low-only traffic"
        assert srv._brownout.level < 3
    finally:
        srv.stop(drain=True)


def test_burst_climbs_to_l3_sheds_only_low_then_descends():
    """A burst beyond the queue's capacity on a slow replica, one request
    in four of the high class: the ladder climbs to 3 (eager batching
    from 2), only the low class is shed (at the door, or evicted for a
    high arrival), and once the burst drains the ladder comes back to 0."""
    srv = InferenceServer(SlowPredictor(delay_s=0.02), max_batch_size=2, batch_timeout_ms=1,
                          queue_capacity=8, name="burst", brownout_hold_s=0.02)
    try:
        shed = {PRIORITY_HIGH: 0, PRIORITY_LOW: 0}
        futs, peak, eager = [], 0, False
        deadline = time.monotonic() + 10.0
        i = 0
        while peak < 3 and time.monotonic() < deadline:
            prio = PRIORITY_LOW if i % 4 else PRIORITY_HIGH
            try:
                futs.append((prio, srv.submit({"x": _rows(1, seed=i)}, priority=prio)))
            except ServerOverloaded:
                shed[prio] += 1
            peak = max(peak, srv.metrics()["brownout_level"])
            eager = eager or srv._batcher.eager
            i += 1
            time.sleep(0.002)
        assert peak == 3 and eager
        for prio, f in futs:
            try:
                f.result(timeout=30)
            except ServerOverloaded:
                shed[prio] += 1
        assert shed[PRIORITY_HIGH] == 0 and shed[PRIORITY_LOW] > 0
        deadline = time.monotonic() + 10.0
        while srv.load()["brownout_level"] > 0 and time.monotonic() < deadline:
            srv.submit({"x": _rows(1)}, priority=PRIORITY_HIGH).result(timeout=30)
            time.sleep(0.02)
        assert srv.load()["brownout_level"] == 0
        assert not srv._batcher.eager
    finally:
        srv.stop(drain=True)


def test_server_load_report_shape():
    srv = InferenceServer(SlowPredictor(), max_batch_size=4, batch_timeout_ms=0,
                          queue_capacity=8, name="loadsrv")
    try:
        load = srv.load()
        assert set(load) == {"queue_depth", "admit_limit", "brownout_level"}
        assert load["admit_limit"] == 8 and load["brownout_level"] == 0
        m = srv.metrics()
        assert m["admit_limit"] == 8 and m["brownout_level"] == 0
    finally:
        srv.stop(drain=True)
    # stop() retires the server's gauges from the exposition
    assert 'server="loadsrv"' not in monitor.render_text()


def test_client_priority_plumbs_through():
    srv = InferenceServer(SlowPredictor(), max_batch_size=4, batch_timeout_ms=0,
                          queue_capacity=8, name="cliprio")
    try:
        cli = serving.Client(srv)
        out, = cli.infer({"x": _rows(2)}, priority=PRIORITY_HIGH)
        assert out.shape == (2, 1)
        assert len(cli.infer_many([{"x": _rows(1)}, {"x": _rows(1, seed=1)}],
                                  priority=PRIORITY_LOW)) == 2
    finally:
        srv.stop(drain=True)
