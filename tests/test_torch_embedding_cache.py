"""``paddle_tpu_torch.serving.embedding_cache`` on the CPU: the JAX
package's cases (``tests/test_embedding_cache.py``) against the port —
bounded capacity and LRU eviction, read-through accounting and the
hit-ratio gauge, invalidation on a sync push, an async push (the
Communicator's ``on_pushed``) and a checkpoint restore, the cache-only
fallback tier, the brownout ladder's cache-only rung, and Zipf(1.0)
absorption — plus the JAX cache and the port's on one Zipf stream (equal
rows and equal ``stats()``), the L4 mirror on a real
``InferenceServer(embedding_cache=)``, async training through the
executor wiring ``on_pushed``, and the JAX package's two chaos drills of
the cache through a PS outage (``tests/chaos/test_chaos_sparse.py``).

Training through the cache equals training without it within rtol 1e-6
(the same pulls and the same fp32 step; measured equal).  Servers are
in-process ``ParameterServer``s on 127.0.0.1.
"""
import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import faults, framework, monitor
from paddle_tpu_torch.distributed.ps import ParameterServer, PSClient
from paddle_tpu_torch.serving.embedding_cache import EmbeddingRowCache
from paddle_tpu_torch.serving.errors import BackendUnavailable


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()


def _ps_with_table(name="tbl", dim=4, n_rows=0, seed=0):
    server = ParameterServer().start()
    client = PSClient([server.endpoint])
    client.create_table(name, dim, initializer="uniform", seed=seed)
    if n_rows:
        client.pull_sparse(name, np.arange(n_rows, dtype=np.int64))
    return server, client


# ---------------------------------------------------------------------------
# Capacity, eviction, accounting
# ---------------------------------------------------------------------------
def test_bounded_capacity_and_lru_eviction():
    server, client = _ps_with_table(dim=3)
    try:
        cache = EmbeddingRowCache(capacity_rows=4, name="cap")
        cache.lookup_through(client, "tbl", np.arange(4, dtype=np.int64))
        assert len(cache) == 4
        # touch id 0 (MRU), then insert two more: 1 and 2 evict
        cache.lookup_through(client, "tbl", np.array([0], np.int64))
        cache.lookup_through(client, "tbl", np.array([10, 11], np.int64))
        assert len(cache) == 4
        assert cache.get("tbl", 0) is not None     # recently used: kept
        assert cache.get("tbl", 1) is None         # LRU: evicted
        assert cache.get("tbl", 2) is None
        cache.close()
    finally:
        client.close()
        server.stop()


def test_read_through_values_and_hit_ratio_gauge_math():
    server, client = _ps_with_table(dim=4, seed=3)
    try:
        cache = EmbeddingRowCache(capacity_rows=64, name="gauge")
        ids = np.array([5, 9, 5, 13], np.int64)
        uniq, counts = np.unique(ids, return_counts=True)
        truth = client.pull_sparse("tbl", uniq)
        rows = cache.lookup_through(client, "tbl", uniq, counts=counts)
        np.testing.assert_array_equal(rows, truth)
        # all cold: occurrence-weighted misses = 4 (id 5 counts twice)
        s = cache.stats()
        assert (s["hits"], s["misses"]) == (0, 4)
        rows2 = cache.lookup_through(client, "tbl", uniq, counts=counts)
        np.testing.assert_array_equal(rows2, truth)
        s = cache.stats()
        assert (s["hits"], s["misses"]) == (4, 4)
        assert s["hit_ratio"] == pytest.approx(0.5)
        # the gauge carries hits / (hits + misses) exactly
        snap = monitor.REGISTRY.snapshot()[
            "serving_embedding_cache_hit_ratio"]
        series = {tuple(x["labels"].items()): x["value"]
                  for x in snap["series"]}
        assert series[(("cache", "gauge"),)] == pytest.approx(0.5)
        # padding entries (n_valid) never count
        padded = np.concatenate([uniq, np.full(5, uniq[0], np.int64)])
        rows3 = cache.lookup_through(client, "tbl", padded, n_valid=3)
        np.testing.assert_array_equal(rows3[:3], truth)
        np.testing.assert_array_equal(rows3[3:],
                                      np.broadcast_to(truth[0], (5, 4)))
        s = cache.stats()
        assert (s["hits"], s["misses"]) == (7, 4)  # +3 unweighted hits
        cache.close()
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# Invalidation: push + checkpoint restore (stale-row regressions)
# ---------------------------------------------------------------------------
def _train_model(V=30, D=4, table="inv_table", seed=17):
    prog, startup = framework.Program(), framework.Program()
    prog.random_seed = startup.random_seed = seed
    with framework.program_guard(prog, startup):
        ids = fluid.layers.data("ids", [1], dtype="int64")
        y = fluid.layers.data("y", [1])
        emb = fluid.layers.embedding(
            ids, [V, D], is_sparse=True, is_distributed=True,
            param_attr=fluid.ParamAttr(name=table))
        pred = fluid.layers.fc(emb, 1, name="head")
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    return prog, startup, loss


def test_push_invalidates_cached_rows_no_stale_training():
    """Training THROUGH the cache matches training without it exactly:
    every step's push invalidates the pushed rows, so step N+1's
    prefetch re-pulls the post-optimizer values.  (Without the
    invalidation hook the second step would train on stale rows and
    the loss trajectories diverge — the pinned regression.)"""
    V, B = 30, 12
    rng = np.random.RandomState(1)
    feeds = [
        {"ids": rng.randint(0, V, (B, 1)).astype("int64"),
         "y": rng.randn(B, 1).astype("float32")}
        for _ in range(8)
    ]

    def train(with_cache):
        server = ParameterServer().start()
        try:
            prog, startup, loss = _train_model(V=V)
            fluid.distributed.bind_distributed_tables(
                prog, [server.endpoint], optimizer="sgd", lr=0.1,
                initializer="zeros")
            cache = None
            if with_cache:
                cache = EmbeddingRowCache(capacity_rows=V, name="inv")
                cache.bind(prog)
            exe = fluid.Executor(fluid.CPUPlace())
            out = []
            with fluid.scope_guard(fluid.Scope()):
                exe.run(startup)
                for f in feeds:
                    (l,) = exe.run(prog, feed=dict(f), fetch_list=[loss])
                    out.append(float(np.asarray(l)))
            if cache is not None:
                assert cache.stats()["misses"] > 0  # it WAS in the loop
                cache.close()
            return out
        finally:
            server.stop()

    np.testing.assert_allclose(train(True), train(False),
                               rtol=1e-6, atol=1e-8)


def test_async_push_invalidates_after_server_apply():
    """The async (Communicator) path invalidates via ``on_pushed`` —
    AFTER the merged push lands server-side, never at enqueue time (an
    enqueue-time invalidation lets a concurrent read-through re-cache
    the pre-update row permanently)."""
    from paddle_tpu_torch.distributed.communicator import Communicator

    server, client = _ps_with_table(name="async_tbl", dim=3, seed=1)
    try:
        cache = EmbeddingRowCache(capacity_rows=16, name="async")
        ids = np.arange(4, dtype=np.int64)
        stale = cache.lookup_through(client, "async_tbl", ids).copy()
        comm = Communicator(client).start()
        comm.on_pushed = cache.invalidate_ids
        comm.push("async_tbl", ids, np.ones((4, 3), np.float32))
        comm.flush()  # barrier: the merged push has applied
        # the pushed ids are gone from the cache, so the next
        # read-through serves the post-optimizer rows
        assert all(cache.get("async_tbl", int(i)) is None for i in ids)
        fresh = cache.lookup_through(client, "async_tbl", ids)
        assert not np.allclose(fresh, stale)
        comm.stop()
        cache.close()
    finally:
        client.close()
        server.stop()


def test_checkpoint_restore_invalidates_cache(tmp_path):
    """A checkpoint restore rewrites rows server-side by value; a cache
    warmed on the PRE-restore rows must not serve them afterwards."""
    from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint

    server, client = _ps_with_table(name="ckpt_tbl", dim=3, seed=5)
    try:
        prog = framework.Program()  # carrier for the cache binding
        prog._ps_client = client
        cache = EmbeddingRowCache(capacity_rows=32, name="ckpt")
        cache.bind(prog)
        ids = np.arange(6, dtype=np.int64)
        rows_a = client.pull_sparse("ckpt_tbl", ids).copy()

        ckpt = TrainCheckpoint(str(tmp_path), every_n_steps=1)
        scope = fluid.Scope()
        ckpt.save(prog, scope, step=1, epoch=0, ps_client=client)

        # mutate the rows after the save (training moved on)...
        client.push_sparse("ckpt_tbl", ids,
                           np.ones((len(ids), 3), np.float32))
        rows_b = client.pull_sparse("ckpt_tbl", ids).copy()
        assert not np.allclose(rows_a, rows_b)
        # ...warm the cache on the post-save rows...
        cache.lookup_through(client, "ckpt_tbl", ids)
        # ...then restore: the cache must be invalidated, so the next
        # read-through serves the RESTORED rows, not the cached copy
        ckpt.restore(prog, scope, ps_client=client)
        assert len(cache) == 0
        got = cache.lookup_through(client, "ckpt_tbl", ids)
        np.testing.assert_allclose(got, rows_a, rtol=1e-6)
        cache.close()
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# Cache-only tier + the brownout rung
# ---------------------------------------------------------------------------
def test_cache_only_mode_serves_fallback_rows_counted():
    server, client = _ps_with_table(dim=4, seed=9)
    try:
        cache = EmbeddingRowCache(capacity_rows=16, name="fb")
        warm = np.arange(4, dtype=np.int64)
        truth = cache.lookup_through(client, "tbl", warm).copy()
        fb0 = monitor.counter_value(
            "serving_embedding_cache_fallback_rows_total")
        cache.set_cache_only(True)
        mixed = np.array([0, 1, 100, 101], np.int64)
        rows = cache.lookup_through(client, "tbl", mixed)
        np.testing.assert_array_equal(rows[:2], truth[:2])  # hits exact
        mean = truth.mean(axis=0)
        np.testing.assert_allclose(rows[2], mean, rtol=1e-5)  # mean row
        np.testing.assert_allclose(rows[3], mean, rtol=1e-5)
        s = cache.stats()
        assert s["fallback_rows"] == 2
        assert monitor.counter_value(
            "serving_embedding_cache_fallback_rows_total") == fb0 + 2
        # zero-fallback variant
        zc = EmbeddingRowCache(capacity_rows=8, name="fbz",
                               fallback="zero")
        zc.lookup_through(client, "tbl", warm)
        zc.set_cache_only(True)
        rows = zc.lookup_through(client, "tbl", np.array([500], np.int64))
        np.testing.assert_array_equal(rows, np.zeros((1, 4), np.float32))
        zc.close()
        cache.close()
    finally:
        client.close()
        server.stop()


def test_brownout_cache_only_rung_enters_and_exits_with_hysteresis():
    """The 4-threshold ladder an embedding-cache endpoint builds: the
    cache-only rung engages one hold above L3 and releases 4x slower
    (same hysteresis machinery as every other rung), and the server's
    _apply_brownout mirrors the level into the cache mode."""
    from paddle_tpu_torch.serving.admission import BrownoutController

    clk = [0.0]
    b = BrownoutController(
        "l4", hold_s=1.0, clock=lambda: clk[0],
        thresholds=BrownoutController.THRESHOLDS
        + (BrownoutController.CACHE_ONLY_THRESHOLD,))
    assert b.max_level == 4
    for expect in (1, 2, 3, 4):
        b.update(0.98)
        clk[0] += 1.1
        assert b.update(0.98) == expect
    clk[0] += 5.0
    assert b.update(0.98) == 4  # capped
    # descent: one rung per 4*hold
    assert b.update(0.0) == 4
    clk[0] += 2.0
    assert b.update(0.0) == 4   # inside the slow hold
    clk[0] += 2.5
    assert b.update(0.0) == 3   # released: back below the L4 rung
    b.close()

    # the server-side mirror: level >= 4 flips the cache mode on; a
    # lower level flips it back off
    class _Srv:
        from paddle_tpu_torch.serving.server import InferenceServer as _IS
        _apply_brownout = _IS._apply_brownout

    srv = _Srv()
    srv._batcher = type("_Batcher", (), {"eager": False})()
    srv._embedding_cache = EmbeddingRowCache(capacity_rows=4, name="mir")
    srv._apply_brownout(4)
    assert srv._embedding_cache.cache_only
    srv._apply_brownout(3)
    assert not srv._embedding_cache.cache_only
    srv._embedding_cache.close()

    # the default ladder (no cache) still stops at 3
    b3 = BrownoutController("l3", hold_s=1.0, clock=lambda: clk[0])
    assert b3.max_level == 3
    b3.close()


def test_brownout_thresholds_must_ascend():
    from paddle_tpu_torch.serving.admission import BrownoutController

    with pytest.raises(ValueError, match="ascend"):
        BrownoutController("bad", thresholds=(0.9, 0.5))


# ---------------------------------------------------------------------------
# Acceptance: Zipf(1.0) absorption
# ---------------------------------------------------------------------------
def test_zipf_stream_hit_ratio_above_080_at_5pct_capacity():
    """Under a Zipf(1.0) id stream over the table's active id range, a
    cache sized at 5% of the table absorbs >= 0.8 of served rows after
    warm (occurrence-weighted, the cache's own accounting).  The table
    is provisioned for the full hash space (the CTR sizing reality);
    traffic follows Zipf over the live ids."""
    TABLE_ROWS = 100_000
    ACTIVE = 10_000
    CAPACITY = 5_000  # 5% of the table
    B, WARM, MEAS = 1024, 25, 25

    server, client = _ps_with_table(name="zipf", dim=4, seed=2)
    try:
        cache = EmbeddingRowCache(capacity_rows=CAPACITY, name="zipf")
        assert CAPACITY <= 0.05 * TABLE_ROWS
        rng = np.random.RandomState(0)
        p = 1.0 / np.arange(1, ACTIVE + 1)
        p /= p.sum()
        cdf = np.cumsum(p)

        def batch():
            ids = np.searchsorted(cdf, rng.rand(B)).astype(np.int64)
            uniq, counts = np.unique(ids, return_counts=True)
            return uniq, counts

        for _ in range(WARM):
            uniq, counts = batch()
            cache.lookup_through(client, "zipf", uniq, counts=counts)
        s0 = cache.stats()
        for _ in range(MEAS):
            uniq, counts = batch()
            cache.lookup_through(client, "zipf", uniq, counts=counts)
        s1 = cache.stats()
        d_hits = s1["hits"] - s0["hits"]
        d_miss = s1["misses"] - s0["misses"]
        ratio = d_hits / (d_hits + d_miss)
        assert ratio >= 0.8, (ratio, s1)
        assert s1["size_rows"] <= CAPACITY
        cache.close()
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# Against the JAX package's cache
# ---------------------------------------------------------------------------
class _TableClient:
    """A PS client over fixed numpy tables (``pull_sparse`` only): both
    packages' caches read the same rows from it."""

    def __init__(self, tables):
        self.tables = tables
        self.pulled = 0

    def pull_sparse(self, table, ids):
        ids = np.asarray(ids).reshape(-1)
        self.pulled += len(ids)
        return self.tables[table][ids].copy()


@pytest.mark.parametrize("fallback", ["mean", "zero"])
def test_port_and_jax_caches_agree_on_one_zipf_stream(fallback):
    from paddle_tpu.serving.embedding_cache import EmbeddingRowCache as JCache

    rng = np.random.RandomState(4)
    tables = {"a": rng.randn(3000, 8).astype(np.float32),
              "b": rng.randn(500, 3).astype(np.float32)}
    ours = EmbeddingRowCache(capacity_rows=300, name="par-" + fallback, fallback=fallback)
    ref = JCache(capacity_rows=300, name="par-" + fallback, fallback=fallback)
    oc, rc = _TableClient(tables), _TableClient(tables)
    p = 1.0 / np.arange(1, 2001)
    cdf = np.cumsum(p / p.sum())
    for step in range(60):
        table = "a" if step % 3 else "b"
        ids = np.searchsorted(cdf, rng.rand(256)).astype(np.int64) % len(tables[table])
        uniq, counts = np.unique(ids, return_counts=True)
        n_valid = len(uniq)
        padded = np.concatenate([uniq, np.full(8, uniq[0], np.int64)])
        if step == 40:
            for c in (ours, ref):
                c.set_cache_only(True)
        if step == 50:
            for c in (ours, ref):
                c.set_cache_only(False)
                c.invalidate_ids("a", uniq[:20])
        if step == 55:
            for c in (ours, ref):
                c.invalidate("b")
        got = ours.lookup_through(oc, table, padded, n_valid=n_valid, counts=counts)
        want = ref.lookup_through(rc, table, padded, n_valid=n_valid, counts=counts)
        np.testing.assert_array_equal(got, want)
        assert ours.stats() == ref.stats()
    assert oc.pulled == rc.pulled > 0
    assert ours.stats()["fallback_rows"] > 0 and ours.hit_ratio() == ref.hit_ratio()
    ours.close()
    ref.close()


# ---------------------------------------------------------------------------
# The server's L4 mirror on a real InferenceServer
# ---------------------------------------------------------------------------
def test_inference_server_binds_the_cache_and_mirrors_l4(tmp_path):
    from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
    from paddle_tpu_torch.serving.admission import BrownoutController
    from paddle_tpu_torch.serving.server import InferenceServer

    d = str(tmp_path / "mlp")
    prog, startup = framework.Program(), framework.Program()
    with framework.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [6])
        out = fluid.layers.fc(x, 2)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(d, ["x"], [out], exe, main_program=prog, scope=scope)
    preds = []
    for _ in range(2):
        cfg = AnalysisConfig(d)
        cfg.disable_gpu()
        preds.append(create_paddle_predictor(cfg))
    cache = EmbeddingRowCache(capacity_rows=8, name="srv-l4")
    srv = InferenceServer(preds, max_batch_size=4, name="srv-l4", embedding_cache=cache)
    try:
        assert all(p._program._embedding_cache is cache for p in preds)
        assert srv._brownout.max_level == 4
        assert srv._brownout.thresholds[-1] == BrownoutController.CACHE_ONLY_THRESHOLD
        # the side effects of each level (the ladder's own climb and
        # hysteresis are held above, on a controller with an injected clock)
        for level in (0, 1, 2, 3, 4, 3, 0):
            srv._apply_brownout(level)
            assert cache.cache_only == (level >= 4) and srv._batcher.eager == (level >= 2)
        # served answers are unchanged, and the cache's block is reported
        y, = fluid.serving.Client(srv).infer({"x": np.ones((2, 6), np.float32)})
        assert y.shape == (2, 2)
        assert srv.metrics()["embedding_cache"] == cache.stats()
        assert srv.statusz()["metrics"]["embedding_cache"]["capacity_rows"] == 8
    finally:
        srv.stop(drain=False)
        cache.close()
    plain = InferenceServer(preds, max_batch_size=4, name="srv-l3")
    try:
        assert plain._brownout.max_level == 3 and "embedding_cache" not in plain.metrics()
    finally:
        plain.stop(drain=False)


def test_async_training_through_the_executor_invalidates_via_on_pushed():
    """An async-mode program with a cache bound: the executor wires the
    Communicator's ``on_pushed`` to the cache, so after ``flush()`` no
    pushed row is left cached, and the next read-through serves the
    server's rows."""
    V, B = 30, 12
    rng = np.random.RandomState(2)
    feeds = [{"ids": rng.randint(0, V, (B, 1)).astype("int64"),
              "y": rng.randn(B, 1).astype("float32")} for _ in range(4)]
    server = ParameterServer().start()
    try:
        prog, startup, loss = _train_model(V=V, table="async_exe_tbl")
        client = fluid.distributed.bind_distributed_tables(
            prog, [server.endpoint], optimizer="sgd", lr=0.1, initializer="uniform",
            async_mode=True)
        cache = EmbeddingRowCache(capacity_rows=V, name="async-exe").bind(prog)
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            for f in feeds:
                exe.run(prog, feed=dict(f), fetch_list=[loss])
        comm = prog._ps_communicator
        comm.flush()
        assert comm.on_pushed == cache.invalidate_ids
        pushed = np.unique(np.concatenate([f["ids"].reshape(-1) for f in feeds]))
        assert all(cache.get("async_exe_tbl", int(i)) is None for i in pushed)
        assert cache.stats()["misses"] > 0
        rows = cache.lookup_through(client, "async_exe_tbl", pushed)
        np.testing.assert_array_equal(rows, client.pull_sparse("async_exe_tbl", pushed))
        comm.stop()
        cache.close()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# The JAX package's chaos drills: the cache tier through a PS outage
# ---------------------------------------------------------------------------
def test_cache_serves_hits_through_ps_outage_misses_fail_typed():
    server, client = _ps_with_table(name="hot", dim=4, seed=7)
    try:
        cache = EmbeddingRowCache(capacity_rows=32, name="outage")
        hot = np.arange(8, dtype=np.int64)
        truth = cache.lookup_through(client, "hot", hot).copy()
        with faults.armed("ps.pull=error:BackendUnavailable"):
            rows = cache.lookup_through(client, "hot", hot)
            np.testing.assert_array_equal(rows, truth)
            with pytest.raises(BackendUnavailable, match="injected fault"):
                cache.lookup_through(client, "hot", np.array([100, 101], np.int64))
        s = cache.stats()
        assert s["hits"] >= 8 and s["fallback_rows"] == 0
        cache.close()
    finally:
        client.close()
        server.stop()


def test_cache_only_rung_holds_serving_available_through_outage():
    server, client = _ps_with_table(name="zipf", dim=4, seed=11)
    try:
        cache = EmbeddingRowCache(capacity_rows=64, name="rung")
        hot = np.arange(16, dtype=np.int64)
        truth = cache.lookup_through(client, "zipf", hot).copy()
        fb0 = monitor.counter_value("serving_embedding_cache_fallback_rows_total")
        cache.set_cache_only(True)
        with faults.armed("ps.pull=error:BackendUnavailable"):
            mixed = np.concatenate([hot[:12], np.array([900, 901], np.int64)])
            rows = cache.lookup_through(client, "zipf", mixed)
            np.testing.assert_array_equal(rows[:12], truth[:12])
            mean = truth.mean(axis=0)
            np.testing.assert_allclose(rows[12], mean, rtol=1e-5)
            np.testing.assert_allclose(rows[13], mean, rtol=1e-5)
        assert monitor.counter_value("serving_embedding_cache_fallback_rows_total") == fb0 + 2
        cache.set_cache_only(False)
        real = cache.lookup_through(client, "zipf", np.array([900, 901], np.int64))
        assert not np.allclose(real[0], mean)
        cache.close()
    finally:
        client.close()
        server.stop()
