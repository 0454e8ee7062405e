"""``paddle_tpu_torch.serving.decode`` and ``serving.kv_pool`` on the CPU:
the JAX package's scheduler tests (``tests/test_decode.py``) over a torch
chain model, the pool's units, and the transformer LM served by the
port's ``DecodeServer`` against the JAX package's on the same weights.

Two model tiers, as the JAX tests use: a "chain" step (next token =
previous + 1 mod V; no cache math) exercises the scheduler — admission,
slot reuse, EOS/cap termination, TTFT, ticks accounting, streaming —
and a small transformer LM (V = 23, d_model 16, 2 layers, 2 heads,
max_pos 32, weights from ``RandomState(7)``) holds the numbers: its
greedy tokens equal the JAX package's ``DecodeServer``'s and the port's
scalar cached step's exactly, and ``make_slot_decode_fns``'s state after
an admit and three chunks equals the JAX package's (ids and flags
exactly, the cache within 1e-5).
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import decoding as tdec
from paddle_tpu_torch import monitor
from paddle_tpu_torch.serving.client import Client
from paddle_tpu_torch.serving.decode import DecodeServer
from paddle_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
    ServingError,
)
from paddle_tpu_torch.serving.kv_pool import KVSlotPool, default_len_ladder

EOS = 9
V = 23
CPU = tfluid.CPUPlace()
LM_DIMS = dict(vocab=V, d_model=16, n_layer=2, n_head=2, d_inner=32, max_pos=32)
DIMS = [LM_DIMS[k] for k in ("vocab", "d_model", "n_layer", "n_head", "d_inner")]
CACHE_TOL = 1e-5


# ---------------------------------------------------------------------------
# model builders
# ---------------------------------------------------------------------------
def chain_model():
    """next token = (consumed token + 1) % V; the cache is a dummy leaf.
    From prompt [..., p] the generated chain is p+1, p+2, ... — EOS is
    reached exactly when the chain passes 9."""

    def step_fn(cache, tokens, ts):
        logits = torch.nn.functional.one_hot((tokens.long() + 1) % V, V).float() * 10.0
        return logits, cache

    def make_cache(n_rows, seq_len, device="cpu"):
        return {"z": torch.zeros((n_rows, seq_len), device=device)}

    step_fn.device = torch.device("cpu")
    return step_fn, make_cache


def slow_chain_model(pause_s=0.005):
    """The chain model with a 5 ms pause a step, so decode takes
    human-scale time and the mid-decode timing tests have room (the JAX
    test's model burns about that in a matmul; a pause takes the same
    time however busy the CPU is)."""

    def step_fn(cache, tokens, ts):
        time.sleep(pause_s)
        logits = torch.nn.functional.one_hot((tokens.long() + 1) % V, V).float() * 10.0
        return logits, cache

    def make_cache(n_rows, seq_len, device="cpu"):
        return {"z": torch.zeros((n_rows, seq_len), device=device)}

    step_fn.device = torch.device("cpu")
    return step_fn, make_cache


def expected_chain(prompt, total_len):
    out = []
    cur = prompt[-1]
    for _ in range(total_len - len(prompt)):
        cur = (cur + 1) % V
        out.append(cur)
        if cur == EOS:
            break
    return out


@pytest.fixture(scope="module")
def slow_server():
    step_fn, make_cache = slow_chain_model()
    srv = DecodeServer(step_fn, make_cache, eos_id=EOS, max_seq_len=64, max_slots=4,
                       len_ladder=[64], steps_per_tick=1, name="slowchain")
    srv.warmup()
    yield srv
    srv.stop(drain=False)


@pytest.fixture(scope="module")
def chain_server():
    step_fn, make_cache = chain_model()
    srv = DecodeServer(step_fn, make_cache, eos_id=EOS, max_seq_len=16, max_slots=4,
                       steps_per_tick=2, name="chain")
    srv.warmup()
    yield srv
    srv.stop(drain=False)


@pytest.fixture(scope="module")
def lm_state():
    return tdec.random_transformer_lm_state(np.random.RandomState(7), **LM_DIMS)


def _ref_continuation(state, prompt, total_len):
    """Greedy continuation via the port's SCALAR cached step fn."""
    step_fn, make_cache = tdec.make_transformer_lm_step_fn(state, *DIMS, LM_DIMS["max_pos"],
                                                           place=CPU)
    cache = make_cache(1)
    logits = None
    for t, tok in enumerate(prompt):
        logits, cache = step_fn(cache, torch.tensor([tok]), t)
    out, pos = [], len(prompt)
    while pos < total_len:
        nxt = int(torch.argmax(logits[0]))
        out.append(nxt)
        if nxt == EOS:
            break
        logits, cache = step_fn(cache, torch.tensor([nxt]), pos)
        pos += 1
    return out


# ---------------------------------------------------------------------------
# KVSlotPool units
# ---------------------------------------------------------------------------
def test_default_len_ladder_shape():
    assert default_len_ladder(64) == [8, 16, 32, 64]
    assert default_len_ladder(48) == [8, 16, 32, 48]
    assert default_len_ladder(8) == [8]
    assert default_len_ladder(6) == [6]
    with pytest.raises(ValueError):
        default_len_ladder(0)


def test_pool_alloc_resize_and_rungs():
    step_fn, make_cache = chain_model()
    pool = KVSlotPool(step_fn, make_cache, eos_id=EOS, max_slots=4, max_seq_len=32, steps=2)
    st = pool.alloc(2, 8)
    assert pool.state_rungs(st) == (2, 8)
    assert st["tokens"].shape == (2, 8) and st["tokens"].dtype == torch.int32
    st["tokens"][:] = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    st["pos"][:] = torch.tensor([3, 5])
    up = pool.resize(st, 4, 16)
    assert pool.state_rungs(up) == (4, 16)
    np.testing.assert_array_equal(up["tokens"][:2, :8].numpy(), np.arange(16).reshape(2, 8))
    assert int(up["tokens"][2:].sum()) == 0 and int(up["tokens"][:2, 8:].sum()) == 0
    np.testing.assert_array_equal(up["pos"][:2].numpy(), [3, 5])
    down = pool.resize(up, 2, 8)
    assert torch.equal(down["tokens"], st["tokens"])
    assert pool.resize(down, 2, 8) is down


def test_pool_warmup_covers_every_rung_pair_then_zero_misses():
    step_fn, make_cache = chain_model()
    pool = KVSlotPool(step_fn, make_cache, eos_id=EOS, max_slots=4, max_seq_len=16, steps=2)
    n = pool.warmup()
    assert n == len(pool.rung_pairs()) * 3  # chunk + admit + release
    assert pool.warmup() == 0  # re-warm is free
    recompiles = []
    pool._on_recompile = lambda: recompiles.append(1)
    for s, t in pool.rung_pairs():
        st = pool.alloc(s, t)
        st = pool.admit(st, 0, np.array([2, 3], np.int32), 2, t)
        st = pool.chunk(st)
        st = pool.release(st, [0])
    stats = pool.jit_cache_stats()
    assert stats["misses"] == 0 and not recompiles
    assert stats["hits"] >= len(pool.rung_pairs()) * 3
    # an entry missing after warmup is built and counted as a recompile
    pool._exe.pop(("chunk", 1, 8))
    pool.chunk(pool.alloc(1, 8))
    assert pool.jit_cache_stats()["misses"] == 1 and recompiles == [1]


def test_functional_step_fn_results_land_in_the_pool_state():
    """A step fn that returns fresh cache tensors (the JAX package's
    functional contract) still leaves its results in the pool's buffers:
    each consumed token is recorded in the cache at its position."""

    def step_fn(cache, tokens, ts):
        z = cache["z"].clone()
        z[torch.arange(z.shape[0]), ts.long()] = tokens.float()
        logits = torch.nn.functional.one_hot((tokens.long() + 1) % V, V).float() * 10.0
        return logits, {"z": z}

    def make_cache(n_rows, seq_len, device="cpu"):
        return {"z": torch.zeros((n_rows, seq_len), device=device)}

    step_fn.device = torch.device("cpu")
    pool = KVSlotPool(step_fn, make_cache, eos_id=EOS, max_slots=2, max_seq_len=16, steps=2)
    st = pool.alloc(2, 16)
    st = pool.admit(st, 0, np.array([2, 3], np.int32), 2, 12)
    st = pool.chunk(pool.chunk(st))
    assert int(st["pos"][0]) == 4
    np.testing.assert_array_equal(st["cache"]["z"][0, :4].numpy(), [2, 3, 4, 5])
    np.testing.assert_array_equal(st["tokens"][0, :5].numpy(), [2, 3, 4, 5, 6])


def test_pool_state_bytes_and_meta_spec(lm_state):
    """The state spec comes from meta tensors (no allocation);
    ``kv_rung_bytes`` counts the stored dtypes, as the JAX package's."""
    import jax

    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving.kv_pool import KVSlotPool as JPool

    for kv in ("fp32", "int8"):
        sf, mc = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype=kv, place=CPU)
        pool = KVSlotPool(sf, mc, eos_id=EOS, max_slots=4, max_seq_len=32, kv_dtype=kv)
        jsf, jmc = jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype=kv)
        jpool = JPool(jsf, jmc, eos_id=EOS, max_slots=4, max_seq_len=32, kv_dtype=kv)
        assert pool.rung_pairs() == jpool.rung_pairs()
        for s, t in pool.rung_pairs():
            assert pool.kv_rung_bytes(s, t) == jpool.kv_rung_bytes(s, t), (kv, s, t)
        meta = pool._state_spec(4, 32)
        assert all(x.device.type == "meta" for x in tdec.kv_tree_leaves(meta))
        jspec = jpool._state_spec(4, 32)
        jleaves = jax.tree_util.tree_leaves(jspec)
        tleaves = tdec.kv_tree_leaves(meta)
        assert [tuple(x.shape) for x in jleaves] == [tuple(x.shape) for x in tleaves]
        assert pool.state_bytes() == 0  # no card buffers on the CPU


# ---------------------------------------------------------------------------
# scheduler semantics (chain model)
# ---------------------------------------------------------------------------
def test_generation_eos_and_cap_termination(chain_server):
    req = chain_server.submit({"tokens": np.array([4, 5], np.int32)})
    assert req.result()[0].tolist() == [6, 7, 8, 9]
    req = chain_server.submit({"tokens": np.array([10], np.int32)}, max_new_tokens=5)
    assert req.result()[0].tolist() == [11, 12, 13, 14, 15]
    req = chain_server.submit({"tokens": np.array([[4, 5]], np.int32)})
    assert req.result()[0].tolist() == [6, 7, 8, 9]
    assert chain_server.submit([np.array([5], np.int32)]).result()[0].tolist() == [6, 7, 8, 9]


def test_seq_len_histogram_feeds_kv_ladder_proposal(chain_server):
    from paddle_tpu import serving as jserving  # noqa: F401 — the JAX copy's plan is the yardstick
    from paddle_tpu.serving import autotune as jautotune
    from paddle_tpu_torch.serving import autotune

    before = chain_server.seq_len_histogram().get(8, 0)
    chain_server.submit({"tokens": np.array([10, 11, 12], np.int32)},
                        max_new_tokens=5).result()  # total = 3 + 5 = 8
    hist = chain_server.seq_len_histogram()
    assert hist.get(8, 0) == before + 1
    assert chain_server.metrics()["decode"]["seq_len_histogram"]["8"] >= 1
    doc = autotune.plan_kv_ladder(hist, chain_server.max_seq_len)
    assert doc["len_ladder"][-1] == chain_server.max_seq_len
    assert doc == jautotune.plan_kv_ladder(hist, chain_server.max_seq_len)
    assert chain_server.metrics()["decode"]["kv_ladder_plan"] == autotune.plan_kv_ladder(
        chain_server.seq_len_histogram(), 16, current_ladder=[8, 16])


def test_submit_validation(chain_server):
    with pytest.raises(ValueError):
        chain_server.submit({"tokens": np.zeros((2, 3), np.int32)})
    with pytest.raises(ValueError):
        chain_server.submit({"tokens": np.array([], np.int32)})
    with pytest.raises(ValueError):  # prompt leaves no room to generate
        chain_server.submit({"tokens": np.arange(16, dtype=np.int32)})
    with pytest.raises(ValueError):
        chain_server.submit({"wrong": np.array([1], np.int32)})
    with pytest.raises(ValueError):  # a 0 cap must not generate a token
        chain_server.submit({"tokens": np.array([2], np.int32)}, max_new_tokens=0)
    with pytest.raises(DeadlineExceeded):
        chain_server.submit({"tokens": np.array([2], np.int32)}, timeout_ms=0)
    with pytest.raises(ValueError):  # no draft model attached
        chain_server.submit({"tokens": np.array([2], np.int32)}, speculative=True)


def test_stream_yields_chunks_before_completion(slow_server):
    req = slow_server.submit({"tokens": np.array([10], np.int32)}, max_new_tokens=20)
    it = req.stream()
    first = next(it)
    assert not req.done()  # tokens in hand, sequence still in flight
    rest = [c for c in it]
    got = [t for c in [first] + rest for t in c.tolist()]
    assert got == expected_chain([10], 21)
    assert len(rest) >= 1
    assert req.result()[0].tolist() == got


def test_mixed_storm_zero_recompiles_and_isolation(chain_server):
    misses0 = chain_server._pool.jit_cache_stats()["misses"]
    results, errs = {}, []

    def one(i):
        plen = 1 + i % 4
        start = 10 + (i % 7)
        prompt = np.arange(start, start + plen, dtype=np.int32) % V
        cap = 2 + i % 9
        try:
            if i % 2:
                got = [t for c in Client(chain_server).infer_stream(
                    {"tokens": prompt}, max_new_tokens=cap) for t in c.tolist()]
            else:
                got = chain_server.submit({"tokens": prompt},
                                          max_new_tokens=cap).result()[0].tolist()
            results[i] = (prompt.tolist(), cap, got)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(results) == 24
    for prompt, cap, got in results.values():
        total = min(len(prompt) + cap, chain_server.max_seq_len)
        assert got == expected_chain(prompt, total)
    assert chain_server._pool.jit_cache_stats()["misses"] == misses0
    assert chain_server.metrics().get("recompiles", 0) == 0


def test_continuous_batching_beats_request_at_a_time(chain_server):
    def workload():
        return [(np.array([10], np.int32), 14) if i % 4 == 0 else (np.array([12], np.int32), 2)
                for i in range(16)]

    def ticks():
        return chain_server.metrics()["decode"]["ticks"]

    t0 = ticks()
    for g in range(0, 16, chain_server.max_batch_size):
        group = [chain_server.submit({"tokens": p}, max_new_tokens=c)
                 for p, c in workload()[g:g + chain_server.max_batch_size]]
        for r in group:
            r.result()
    rat_ticks = ticks() - t0
    t0 = ticks()
    reqs = [chain_server.submit({"tokens": p}, max_new_tokens=c) for p, c in workload()]
    outs = [r.result()[0].tolist() for r in reqs]
    cont_ticks = ticks() - t0
    for (p, c), got in zip(workload(), outs):
        assert got == expected_chain(p.tolist(), len(p) + c)
    assert rat_ticks >= 2 * cont_ticks, (rat_ticks, cont_ticks)


def test_late_arrival_first_token_before_batch_finishes(slow_server):
    longs = [slow_server.submit({"tokens": np.array([10], np.int32)}, max_new_tokens=40)
             for _ in range(2)]
    deadline = time.monotonic() + 10.0
    while slow_server.metrics()["decode"]["slot_occupancy"] == 0.0:
        assert time.monotonic() < deadline
        time.sleep(0.002)
    late = slow_server.submit({"tokens": np.array([4, 5], np.int32)})
    first_chunk = next(late.stream())
    assert first_chunk.tolist()[0] == 6
    for r in longs:
        assert r.result(timeout=30.0)[0].tolist() == expected_chain([10], 41)
    assert late.first_token_t is not None
    assert late.first_token_t < min(r.done_t for r in longs)


def test_deadline_mid_decode_frees_slot(slow_server):
    """A deadline of a quarter of a measured full decode (the faster of
    two, so a cold first run cannot stretch the budget) fails the request
    typed mid-decode and frees its slot."""
    full = []
    for _ in range(2):
        t0 = time.perf_counter()
        slow_server.submit({"tokens": np.array([10], np.int32)},
                           max_new_tokens=40).result(timeout=30.0)
        full.append(time.perf_counter() - t0)
    full_ms = min(full) * 1e3
    req = slow_server.submit({"tokens": np.array([10], np.int32)},
                             timeout_ms=full_ms / 4.0, max_new_tokens=40)
    with pytest.raises(DeadlineExceeded):
        req.result(timeout=30.0)
    deadline = time.monotonic() + 10.0
    while slow_server._active_count():
        assert time.monotonic() < deadline
        time.sleep(0.005)


@pytest.mark.parametrize("started", [True, False])
def test_abandoned_stream_frees_slot(slow_server, started):
    """An abandoned stream aborts its decode: closed after its first
    chunk, or dropped before its first ``next()`` (only the GC finalizer
    can abort that one; the token delta shows it stopped early)."""
    import gc

    g0 = int(slow_server.metrics()["decode"]["generated_tokens"])
    it = Client(slow_server).infer_stream({"tokens": np.array([10], np.int32)},
                                          max_new_tokens=40)
    if started:
        next(it)
        it.close()
    else:
        while not slow_server._active_count():
            time.sleep(0.005)
        del it
        gc.collect()
    deadline = time.monotonic() + 10.0
    while slow_server._active_count():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    if not started:
        assert int(slow_server.metrics()["decode"]["generated_tokens"]) - g0 < 12


def test_stream_on_non_decode_server_raises_typed():
    class NotDecode:
        _predictor = type("P", (), {"get_output_names": lambda self: ["y"]})()

    with pytest.raises(ServingError):
        Client(NotDecode()).infer_stream({"tokens": [1]})


def test_overload_shed_carries_retry_hint():
    step_fn, make_cache = chain_model()
    srv = DecodeServer(step_fn, make_cache, eos_id=EOS, max_seq_len=16, max_slots=1,
                       slot_ladder=[1], len_ladder=[16], steps_per_tick=1, queue_capacity=2,
                       name="tiny")
    srv.warmup()
    try:
        reqs = []
        with pytest.raises(ServerOverloaded) as ei:
            for _ in range(12):
                reqs.append(srv.submit({"tokens": np.array([10], np.int32)}, max_new_tokens=14))
        assert ei.value.retry_after_ms >= 1.0
        for r in reqs:
            r.result(timeout=30.0)
    finally:
        srv.stop(drain=False)


def test_stop_drain_finishes_queued_and_abort_fails_typed():
    step_fn, make_cache = chain_model()
    srv = DecodeServer(step_fn, make_cache, eos_id=EOS, max_seq_len=16, max_slots=2,
                       steps_per_tick=2, name="draining")
    srv.warmup()
    reqs = [srv.submit({"tokens": np.array([10 + i], np.int32)}, max_new_tokens=4)
            for i in range(6)]
    srv.stop(drain=True, timeout=30.0)
    for i, r in enumerate(reqs):
        assert r.result()[0].tolist() == expected_chain([10 + i], 5)
    with pytest.raises(ServerClosed):
        srv.submit({"tokens": np.array([2], np.int32)})
    srv2 = DecodeServer(step_fn, make_cache, eos_id=EOS, max_seq_len=16, max_slots=2,
                        steps_per_tick=2, name="aborting")
    srv2.warmup()
    reqs = [srv2.submit({"tokens": np.array([10], np.int32)}, max_new_tokens=14)
            for _ in range(4)]
    srv2.stop(drain=False, timeout=30.0)
    for r in reqs:
        with pytest.raises(ServerClosed):
            r.result()


def test_decode_metrics_series(chain_server):
    chain_server.submit({"tokens": np.array([2, 3, 4], np.int32)}, max_new_tokens=4).result()
    d = chain_server.metrics()["decode"]
    assert d["generated_tokens"] > 0 and d["prefill_tokens"] > 0
    assert d["ticks"] > 0
    assert d["slot_ladder"] == [1, 2, 4] and d["len_ladder"] == [8, 16]
    assert d["kv_dtype"] == "fp32"
    snap = monitor.snapshot()
    for name in ("serving_decode_tokens_total", "serving_decode_prefill_tokens_total",
                 "serving_decode_ticks_total", "serving_decode_ttft_seconds",
                 "serving_decode_slot_occupancy", "serving_kv_cache_bytes",
                 "serving_requests_total", "serving_request_latency_seconds"):
        assert name in snap, name
    st = chain_server.statusz()
    assert st["jit_cache"]["misses"] == 0 and st["metrics"]["warmed_up"]


def test_decode_step_fault_fails_typed_and_keeps_serving(chain_server):
    """An armed ``decode.step`` fault fails the in-flight requests typed;
    the next request is served."""
    from paddle_tpu_torch import faults

    with faults.armed("decode.step=error:RuntimeError,times=1") as plan:
        req = chain_server.submit({"tokens": np.array([3], np.int32)}, max_new_tokens=3)
        with pytest.raises(RuntimeError):
            req.result(timeout=30.0)
        assert plan.triggers().get("decode.step") == 1
    assert chain_server.submit({"tokens": np.array([4, 5], np.int32)}).result(
        timeout=30.0)[0].tolist() == [6, 7, 8, 9]


def test_decode_tick_spans_carry_trace_ids(chain_server):
    with monitor.trace_session() as sess:
        c = Client(chain_server)
        chunks = list(c.infer_stream({"tokens": np.array([10], np.int32)}, max_new_tokens=6))
    got = [t for ch in chunks for t in ch.tolist()]
    assert got == expected_chain([10], 7)
    ticks = [s for s in sess.spans if s["name"] == "serving/decode_tick"]
    assert ticks and any(c.last_trace_id in s.get("trace_ids", ()) for s in ticks)
    assert any(s["name"] == "serving/client_stream" for s in sess.spans)


# ---------------------------------------------------------------------------
# the builders against the JAX package's
# ---------------------------------------------------------------------------
def _jax_slot_fns(lm_state, steps):
    from paddle_tpu import decoding as jdec

    jsf, jmc = jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS)
    return jdec.make_slot_decode_fns(jsf, EOS, steps), jmc


def test_slot_decode_fns_match_jax_after_admit_and_three_chunks(lm_state):
    """Two admits (prompts of 3 and 5 tokens, caps 9 and 12), then three
    chunks of 3 steps: tokens, pos, active, finished and n_gen equal the
    JAX package's; the cache within 1e-5."""
    import jax
    import jax.numpy as jnp

    (jchunk, jadmit, _), jmc = _jax_slot_fns(lm_state, 3)
    sf, mc = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, place=CPU)
    chunk, admit, _ = tdec.make_slot_decode_fns(sf, EOS, 3)
    S, T = 2, 16
    i32 = np.int32
    jst = {"cache": jmc(S, T), "tokens": jnp.zeros((S, T), i32), "pos": jnp.zeros(S, i32),
           "prompt_len": jnp.zeros(S, i32), "total_len": jnp.zeros(S, i32),
           "active": jnp.zeros(S, bool), "finished": jnp.zeros(S, bool), "n_gen": jnp.zeros(S, i32)}
    tst = {"cache": mc(S, T), "tokens": torch.zeros((S, T), dtype=torch.int32),
           "pos": torch.zeros(S, dtype=torch.int32), "prompt_len": torch.zeros(S, dtype=torch.int32),
           "total_len": torch.zeros(S, dtype=torch.int32), "active": torch.zeros(S, dtype=torch.bool),
           "finished": torch.zeros(S, dtype=torch.bool), "n_gen": torch.zeros(S, dtype=torch.int32)}
    for slot, prompt, total in ((0, [2, 3, 4], 12), (1, [5, 7, 11, 13, 1], 17)):
        buf = np.zeros(T, i32)
        buf[:len(prompt)] = prompt
        mask = np.arange(S) == slot
        total = min(total, T)
        jst = jadmit(jst, jnp.asarray(mask), jnp.asarray(buf), jnp.asarray(len(prompt), i32),
                     jnp.asarray(total, i32))
        tst = admit(tst, torch.from_numpy(mask), torch.from_numpy(buf),
                    torch.tensor(len(prompt), dtype=torch.int32),
                    torch.tensor(total, dtype=torch.int32))
    for _ in range(3):
        jst = jchunk(jst)
        tst = chunk(tst)
    for k in ("tokens", "pos", "active", "finished", "n_gen", "prompt_len", "total_len"):
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]), err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(jst["cache"]), tdec.kv_tree_leaves(tst["cache"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=CACHE_TOL)
    assert int(tst["n_gen"].sum()) > 0


@pytest.mark.parametrize("case", [
    ((2, 16), 16),       # the transformer cache [S, H, T, Dh]
    ((3, 5), 5),         # [S, T]: T final
    ((2, 4, 8, 8), 8),   # H == T == Dh: T is the last non-final match
    ((2, 4, 7, 5), 9),   # no axis of the length: None
    ((3, 16), 16),       # wrong slot count: None
    ((2,), 2),           # rank 1: None
])
def test_kv_leaf_seq_axis_matches_jax(case):
    from paddle_tpu import decoding as jdec

    shape, t = case
    assert tdec.kv_leaf_seq_axis(shape, 2, t) == jdec.kv_leaf_seq_axis(shape, 2, t)


# ---------------------------------------------------------------------------
# end to end: the port's DecodeServer against the JAX package's
# ---------------------------------------------------------------------------
PROMPTS = [[2, 3, 4], [5], [7, 8], [11, 12, 13, 14]]
CAPS = [10, 6, 12, 8]


def _serve(server, prompts=PROMPTS, caps=CAPS):
    reqs = [server.submit({"tokens": np.array(p, np.int32)}, max_new_tokens=c)
            for p, c in zip(prompts, caps)]
    return [r.result(timeout=120.0)[0].tolist() for r in reqs]


def test_lm_tokens_equal_jax_decode_server_and_scalar_step(lm_state):
    """The whole slot-pool machinery — per-row positions, interleaved
    prefill/decode, rung growth, slot reuse — gives the JAX package's
    DecodeServer's greedy tokens, and the port's scalar cached step's."""
    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving.decode import DecodeServer as JServer

    kw = dict(eos_id=EOS, max_seq_len=32, max_slots=2, slot_ladder=[1, 2], len_ladder=[16, 32],
              steps_per_tick=3)
    jsrv = JServer(*jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS), name="jlm", **kw)
    jsrv.warmup(configure_cache=False)
    try:
        want = _serve(jsrv)
    finally:
        jsrv.stop(drain=False)
    srv = DecodeServer(*tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, place=CPU),
                       name="lm", **kw)
    srv.warmup()
    try:
        got = _serve(srv)
        assert srv._pool.jit_cache_stats()["misses"] == 0
    finally:
        srv.stop(drain=False)
    assert got == want
    for p, c, toks in zip(PROMPTS, CAPS, got):
        assert toks == _ref_continuation(lm_state, p, len(p) + c), p
