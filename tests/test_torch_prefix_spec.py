"""The decode tier-2 modes of ``paddle_tpu_torch.serving`` on the CPU:
the prefix KV cache (``serving.prefix_cache``, ``make_prefix_admit_fn``,
``KVSlotPool.extract_kv`` / ``admit_prefix``), speculative decode
(``serving.speculative``, ``make_transformer_lm_pooled_verify_fn``),
saved decode endpoints read and written across both packages, the
``decode.prefix_admit`` fault point, and the hot-path guard over the
decode files.

Each is held against the JAX package on the same numpy inputs: the
prefix cache's answers to the same offers and probes are the JAX copy's;
the verify fn's logits within 1e-5 of the JAX one's; the retained KV
leaves within 1e-5; greedy tokens equal the JAX package's
``DecodeServer``'s exactly (V = 23, d_model 16, 2 layers, 2 heads; the
draft d_model 8, 1 layer; weights from ``RandomState(7)`` and (8)).
"""
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import decoding as tdec
from paddle_tpu_torch.serving.decode import (
    DecodeServer,
    is_decode_endpoint,
    load_decode_endpoint,
    save_decode_endpoint,
)
from paddle_tpu_torch.serving.kv_pool import KVSlotPool
from paddle_tpu_torch.serving.prefix_cache import PrefixKVCache
from paddle_tpu_torch.serving.speculative import SpeculativeConfig, make_lm_speculative

V = 23
EOS = 9
CPU = tfluid.CPUPlace()
LM = dict(vocab=V, d_model=16, n_layer=2, n_head=2, d_inner=32, max_pos=32)
DIMS = [LM[k] for k in ("vocab", "d_model", "n_layer", "n_head", "d_inner")]
DRAFT = dict(d_model=8, n_layer=1, n_head=1, d_inner=16)
LOGIT_TOL = 1e-5
KV_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lm_state():
    return tdec.random_transformer_lm_state(np.random.RandomState(7), **LM)


@pytest.fixture(scope="module")
def draft_state():
    return tdec.random_transformer_lm_state(np.random.RandomState(8), vocab=V,
                                            max_pos=LM["max_pos"], name="draft", **DRAFT)


def _spec_kw(lm_state, draft_state, k=4):
    return dict(vocab_size=V, d_model=LM["d_model"], n_layer=LM["n_layer"], n_head=LM["n_head"],
                d_inner=LM["d_inner"], draft_state=draft_state, draft_d_model=DRAFT["d_model"],
                draft_n_layer=DRAFT["n_layer"], draft_n_head=DRAFT["n_head"],
                draft_d_inner=DRAFT["d_inner"], k=k)


def _wait(pred, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _caches(impl):
    if impl == "port":
        return PrefixKVCache
    from paddle_tpu.serving.prefix_cache import PrefixKVCache as JCache

    return JCache


def _leaves(m):
    """A fake extract: one KV leaf whose content encodes ``m``."""
    return [np.full((m, 2), m, np.float32), None]


# ---------------------------------------------------------------------------
# PrefixKVCache units: the port and the JAX copy give the same answers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["port", "jax"])
def test_probe_matches_longest_block_aligned_proper_prefix(impl):
    c = _caches(impl)(capacity_bytes=1 << 20, block_tokens=4, name="t-probe-" + impl)
    try:
        prompt = np.arange(12, dtype=np.int32)
        assert c.probe(prompt) == (0, None)
        assert c.offer(prompt, consumed=12, extract=_leaves)
        assert c.probe(prompt) == (0, None)  # capped one short of the prompt
        m, kv = c.probe(np.concatenate([prompt, [99]]).astype(np.int32))
        assert m == 12 and kv[0].shape == (12, 2)
    finally:
        c.close()


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_probe_cap_and_block_boundaries(impl):
    c = _caches(impl)(capacity_bytes=1 << 20, block_tokens=4, name="t-bounds-" + impl)
    try:
        prompt = np.arange(12, dtype=np.int32)
        assert c.offer(prompt, consumed=9, extract=_leaves)
        assert c.stats()["entries"] == 1
        m, kv = c.probe(np.concatenate([prompt[:8], [99, 98]]).astype(np.int32))
        assert m == 8 and kv[0].shape == (8, 2) and kv[1] is None
        assert c.probe(prompt[:9])[0] == 8
        assert c.probe(prompt[:8]) == (0, None)
        assert c.probe(prompt[:3]) == (0, None)
        st = c.stats()
        assert st["hits"] == 2 and st["misses"] >= 2
    finally:
        c.close()


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_hash_collision_never_serves_wrong_tokens(monkeypatch, impl):
    cls = _caches(impl)
    c = cls(capacity_bytes=1 << 20, block_tokens=4, name="t-collide-" + impl)
    try:
        monkeypatch.setattr(cls, "_hash", staticmethod(lambda tokens: "same"))
        a = np.arange(8, dtype=np.int32)
        assert c.offer(a, consumed=8, extract=_leaves)
        assert c.probe(np.concatenate([a + 100, [1, 2]]).astype(np.int32)) == (0, None)
        assert c.probe(np.concatenate([a, [1, 2]]).astype(np.int32))[0] == 8
    finally:
        c.close()


@pytest.mark.parametrize("impl", ["port", "jax"])
def test_lru_byte_eviction_and_bytes_accounting(impl):
    def extract(m):
        return [np.zeros((m, 2), np.float32)]

    c = _caches(impl)(capacity_bytes=500, block_tokens=16, name="t-lru-" + impl)
    try:
        p1, p2, p3 = (np.arange(b, b + 16, dtype=np.int32) for b in (0, 100, 200))
        assert c.offer(p1, 16, extract) and c.offer(p2, 16, extract)
        assert c.probe(np.concatenate([p1, [7]]).astype(np.int32))[0] == 16
        assert c.offer(p3, 16, extract)
        st = c.stats()
        assert st["evictions"] == 1 and st["entries"] == 2 and st["bytes"] <= 500
        assert c.probe(np.concatenate([p2, [7]]).astype(np.int32)) == (0, None)
        assert c.probe(np.concatenate([p3, [7]]).astype(np.int32))[0] == 16
        assert not c.offer(p3, 16, extract)
        assert c.stats()["entries"] == 2
        c.invalidate()
        assert c.stats()["entries"] == 0 and c.stats()["bytes"] == 0
    finally:
        c.close()


@pytest.mark.parametrize("kw", [{"capacity_bytes": 0}, {"block_tokens": 0}])
def test_cache_rejects_bad_budgets(kw):
    with pytest.raises(ValueError):
        PrefixKVCache(**kw)


def test_prefix_cache_stats_equal_jax_on_one_sequence():
    """One mixed sequence of offers and probes: the two copies' stats,
    probe lengths and retained leaves are the same."""
    from paddle_tpu.serving.prefix_cache import PrefixKVCache as JCache

    rng = np.random.RandomState(11)
    head = rng.randint(0, 50, 24).astype(np.int32)
    caches = [PrefixKVCache(4096, 8, name="t-seq"), JCache(4096, 8, name="t-seq-j")]
    try:
        seen = []
        for i in range(12):
            n = 8 + rng.randint(0, 20)
            prompt = np.concatenate([head[:n], rng.randint(0, 50, 3)]).astype(np.int32)
            consumed = rng.randint(0, len(prompt) + 1) if i % 3 else len(prompt)
            row = []
            for c in caches:
                m, kv = c.probe(prompt)
                c.offer(prompt, consumed, _leaves)
                row.append((m, None if kv is None else kv[0].tolist()))
            seen.append(row)
        assert all(a == b for a, b in seen)
        assert caches[0].stats() == caches[1].stats()
    finally:
        for c in caches:
            c.close()


# ---------------------------------------------------------------------------
# the device half: extract_kv / admit_prefix, and the verify fn
# ---------------------------------------------------------------------------
def test_extract_kv_and_admit_prefix_match_jax(lm_state):
    """Seat a prompt, run two chunks, extract its first 8 KV positions
    from each package's pool (within 1e-5 of each other), then install
    them into a fresh state's slot 1 with ``admit_prefix``: the state
    equals the JAX package's (ids exactly, the cache within 1e-5)."""
    import jax

    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving.kv_pool import KVSlotPool as JPool

    kw = dict(eos_id=EOS, max_slots=2, max_seq_len=16, slot_ladder=[2], len_ladder=[16],
              steps=4, prefix=True)
    jpool = JPool(*jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS), **kw)
    pool = KVSlotPool(*tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, place=CPU), **kw)
    prompt = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], np.int32)
    jst = jpool.admit(jpool.alloc(2, 16), 0, prompt, len(prompt), 16)
    st = pool.admit(pool.alloc(2, 16), 0, prompt, len(prompt), 16)
    for _ in range(2):
        jst, st = jpool.chunk(jst), pool.chunk(st)
    jkv, tkv = jpool.extract_kv(jst, 0, 8), pool.extract_kv(st, 0, 8)
    assert [None if x is None else x.shape for x in jkv] == [
        None if x is None else x.shape for x in tkv]
    for a, b in zip(jkv, tkv):
        np.testing.assert_allclose(b, a, rtol=0, atol=KV_TOL)
    suffix = np.concatenate([prompt[:8], [7, 7]]).astype(np.int32)
    jst2 = jpool.admit_prefix(jpool.alloc(2, 16), 1, suffix, len(suffix), 16, jkv, 8)
    st2 = pool.admit_prefix(pool.alloc(2, 16), 1, suffix, len(suffix), 16, jkv, 8)
    for k in ("tokens", "pos", "prompt_len", "total_len", "active", "finished", "n_gen"):
        np.testing.assert_array_equal(st2[k].numpy(), np.asarray(jst2[k]), err_msg=k)
    for a, b in zip(jax.tree_util.tree_leaves(jst2["cache"]), tdec.kv_tree_leaves(st2["cache"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=KV_TOL)
    assert int(st2["pos"][1]) == 8


def test_verify_fn_fp32_matches_jax(lm_state):
    """The K-wide verify's logits within 1e-5 of the JAX one's, and the
    cache equal at the written rows, at mixed positions (K = 4)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu import decoding as jdec

    rng = np.random.RandomState(3)
    jstep, jmc = jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS)
    jstep = jax.jit(jstep)
    tstep, tmc = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, place=CPU)
    jc, tc = jmc(3, 16), tmc(3, 16)
    for i in range(5):  # fill some history first
        toks = rng.randint(0, V, 3).astype(np.int32)
        ts = np.array([i, i, i], np.int32)
        _, jc = jstep(jc, jnp.asarray(toks), jnp.asarray(ts))
        _, tc = tstep(tc, torch.from_numpy(toks), torch.from_numpy(ts))
    jv = jax.jit(jdec.make_transformer_lm_pooled_verify_fn(lm_state, *DIMS))
    tv = tdec.make_transformer_lm_pooled_verify_fn(lm_state, *DIMS, place=CPU)
    vt = rng.randint(0, V, (3, 4)).astype(np.int32)
    ts = np.array([2, 5, 11], np.int32)
    jl, jc = jv(jc, jnp.asarray(vt), jnp.asarray(ts))
    tl, tc = tv(tc, torch.from_numpy(vt), torch.from_numpy(ts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jc), tdec.kv_tree_leaves(tc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=LOGIT_TOL)


def test_speculative_config_contract(lm_state, draft_state):
    with pytest.raises(ValueError):
        SpeculativeConfig(None, None, None, k=1)
    cfg = make_lm_speculative(lm_state, place=CPU, **_spec_kw(lm_state, draft_state))
    assert cfg.k == 4 and cfg.draft_meta["n_layer"] == DRAFT["n_layer"]
    assert cfg.verify_fn.device.type == "cpu"


# ---------------------------------------------------------------------------
# the servers: the port's against the JAX package's
# ---------------------------------------------------------------------------
# one rung pair, so the JAX side compiles few executables (the port's
# rung growth is held in test_torch_decode_server.py)
SERVER_KW = dict(eos_id=EOS, max_seq_len=24, max_slots=2, slot_ladder=[2], len_ladder=[24],
                 steps_per_tick=2)


def _jax_server(lm_state, name, prefix=None, spec=None):
    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving.decode import DecodeServer as JServer
    from paddle_tpu.serving.prefix_cache import PrefixKVCache as JCache
    from paddle_tpu.serving.speculative import make_lm_speculative as jspec

    kw = {}
    if prefix:
        kw["prefix_cache"] = JCache(capacity_bytes=1 << 20, block_tokens=4, name=name)
    if spec is not None:
        kw["speculative"] = jspec(lm_state, **spec)
    srv = JServer(*jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS), name=name,
                  **SERVER_KW, **kw)
    srv.warmup(configure_cache=False)
    return srv


def _port_server(lm_state, name, prefix=None, spec=None):
    kw = {}
    if prefix:
        kw["prefix_cache"] = PrefixKVCache(capacity_bytes=1 << 20, block_tokens=4, name=name)
    if spec is not None:
        kw["speculative"] = make_lm_speculative(lm_state, place=CPU, **spec)
    srv = DecodeServer(*tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, place=CPU),
                       name=name, **SERVER_KW, **kw)
    srv.warmup()
    return srv


def _prefix_run(srv):
    rng = np.random.RandomState(3)
    prefix = rng.randint(2, V, 8).astype(np.int32)
    out = []
    for sfx in ([3, 5], [7, 4], [6, 2]):
        prompt = np.concatenate([prefix, sfx]).astype(np.int32)
        p0 = int(srv.metrics()["decode"]["prefill_tokens"])
        toks = srv.submit({"tokens": prompt}, max_new_tokens=6).result(timeout=60.0)[0]
        out.append((np.asarray(toks).tolist(),
                    int(srv.metrics()["decode"]["prefill_tokens"]) - p0))
        assert _wait(lambda: srv.prefix_cache.stats()["entries"] >= 1)
    return out


def test_shared_prefix_admit_cuts_prefill_and_equals_jax(lm_state):
    """Three prompts sharing an 8-token prefix through a prefix-cached
    server: the port's tokens and prefill counts equal the JAX
    package's (the first prefills 10 tokens, the next ones 2)."""
    jsrv = _jax_server(lm_state, "j-prefix", prefix=True)
    try:
        want = _prefix_run(jsrv)
    finally:
        jsrv.stop(drain=False)
    srv = _port_server(lm_state, "t-prefix", prefix=True)
    try:
        got = _prefix_run(srv)
        st = srv.prefix_cache.stats()
        assert st["hits"] >= 1 and st["fallbacks"] == 0
        assert srv.metrics()["decode"]["prefix_cache"]["hits"] >= 1
        assert srv._pool.jit_cache_stats()["misses"] == 0
    finally:
        srv.stop(drain=False)
    assert got == want
    assert [d for _, d in got] == [10, 2, 2]


def test_prefix_admit_fault_degrades_to_full_prefill(lm_state):
    """An armed ``decode.prefix_admit`` fault falls back to the plain
    admit: the tokens stay right, the fallback is counted."""
    from paddle_tpu_torch import faults

    srv = _port_server(lm_state, "t-prefix-fault", prefix=True)
    try:
        first = _prefix_run(srv)
        with faults.armed("decode.prefix_admit=error:RuntimeError") as plan:
            again = _prefix_run(srv)
            assert plan.triggers().get("decode.prefix_admit", 0) >= 1
        assert [t for t, _ in again] == [t for t, _ in first]
        assert srv.metrics()["prefix_fallback"] >= 1
        assert srv.prefix_cache.stats()["fallbacks"] >= 1
    finally:
        srv.stop(drain=False)


SPEC_PROMPTS = ([2, 3, 4], [5], [7, 8], [3, 5, 2])


def _spec_run(srv):
    reqs = [srv.submit({"tokens": np.asarray(p, np.int32)}, max_new_tokens=10,
                       speculative=bool(i % 2)) for i, p in enumerate(SPEC_PROMPTS)]
    return [np.asarray(r.result(timeout=60.0)[0]).tolist() for r in reqs]


@pytest.mark.parametrize("draft", ["random", "self"])
def test_speculative_tokens_equal_jax_and_plain(lm_state, draft_state, draft):
    """Mixed speculative and plain requests: the port's tokens equal the
    JAX package's speculative server's and the port's plain greedy ones,
    with a random draft (mostly rejected) and the target as its own
    draft (accepted)."""
    if draft == "self":
        spec = _spec_kw(lm_state, lm_state)
        spec.update(draft_d_model=LM["d_model"], draft_n_layer=LM["n_layer"],
                    draft_n_head=LM["n_head"], draft_d_inner=LM["d_inner"], draft_name="lm")
    else:
        spec = _spec_kw(lm_state, draft_state)
    jsrv = _jax_server(lm_state, "j-spec-" + draft, spec=spec)
    try:
        want = _spec_run(jsrv)
    finally:
        jsrv.stop(drain=False)
    srv = _port_server(lm_state, "t-spec-" + draft, spec=spec)
    plain = _port_server(lm_state, "t-plain-" + draft)
    try:
        got = _spec_run(srv)
        ref = [np.asarray(plain.submit({"tokens": np.asarray(p, np.int32)}, max_new_tokens=10)
                          .result(timeout=60.0)[0]).tolist() for p in SPEC_PROMPTS]
        s = srv.metrics()["decode"]["speculative"]
        assert s["k"] == 4 and s["proposed_tokens"] > 0
        assert 0 <= s["accepted_tokens"] <= s["proposed_tokens"]
        assert sum(s["accepted_len_histogram"].values()) > 0
        if draft == "self":
            # the target drafting for itself is always right; only each
            # request's last round, cut by its cap or EOS, drops proposals
            n_spec = sum(1 for i in range(len(SPEC_PROMPTS)) if i % 2)
            assert s["accepted_tokens"] >= s["proposed_tokens"] - (s["k"] - 1) * n_spec
        assert srv._pool.jit_cache_stats()["misses"] == 0
    finally:
        srv.stop(drain=False)
        plain.stop(drain=False)
    assert got == want == ref


def test_all_modes_on_zero_recompiles_after_warmup(lm_state, draft_state):
    srv = _port_server(lm_state, "t-all", prefix=True, spec=_spec_kw(lm_state, draft_state))
    try:
        rng = np.random.RandomState(5)
        prefix = rng.randint(2, V, 8).astype(np.int32)
        for i in range(6):
            sfx = rng.randint(2, V, 1 + i % 3).astype(np.int32)
            prompt = np.concatenate([prefix, sfx]).astype(np.int32)
            srv.submit({"tokens": prompt}, max_new_tokens=4 + i % 5,
                       speculative=bool(i % 2)).result(timeout=60.0)
            _wait(lambda: srv.prefix_cache.stats()["entries"] >= 1)
        m = srv.metrics()
        assert srv.prefix_cache.stats()["hits"] >= 1
        assert m["decode"]["speculative"]["proposed_tokens"] > 0
        assert int(m.get("recompiles", 0)) == 0
        assert srv._pool.jit_cache_stats()["misses"] == 0
        kinds = {k for k, _, _ in srv._pool._exe}
        assert kinds == {"chunk", "admit", "release", "admit_prefix", "spec_chunk"}
    finally:
        srv.stop(drain=False)


# ---------------------------------------------------------------------------
# saved endpoints across the two packages
# ---------------------------------------------------------------------------
def _save_kw(draft_state):
    return dict(vocab_size=V, d_model=LM["d_model"], n_layer=LM["n_layer"], n_head=LM["n_head"],
                d_inner=LM["d_inner"], eos_id=EOS, max_seq_len=24, max_slots=2,
                steps_per_tick=2,
                draft={"state": draft_state, "d_model": DRAFT["d_model"],
                       "n_layer": DRAFT["n_layer"], "n_head": DRAFT["n_head"],
                       "d_inner": DRAFT["d_inner"], "name": "draft", "k": 4},
                prefix_cache_bytes=1 << 20)


def _endpoint_tokens(srv, jax_side):
    if jax_side:
        srv.warmup(configure_cache=False)
    else:
        srv.warmup()
    try:
        out = []
        for spec in (True, False):
            out.append(np.asarray(srv.submit({"tokens": np.array([2, 3, 4], np.int32)},
                                             max_new_tokens=8, speculative=spec)
                                  .result(timeout=60.0)[0]).tolist())
        return out
    finally:
        srv.stop(drain=False)


def test_endpoint_written_by_either_package_loads_in_the_other(tmp_path, lm_state, draft_state):
    """A directory ``save_decode_endpoint`` wrote in the JAX package loads
    in the port and gives the same tokens, and the other way round; the
    two manifests are JSON-equal and the weight archives hold the same
    arrays."""
    from paddle_tpu.serving import decode as jdecode

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jdecode.save_decode_endpoint(jdir, lm_state, **_save_kw(draft_state))
    save_decode_endpoint(tdir, {k: torch.from_numpy(v) for k, v in lm_state.items()},
                         **_save_kw(draft_state))
    with open(os.path.join(jdir, "decode.json")) as f, \
            open(os.path.join(tdir, "decode.json")) as g:
        assert json.load(f) == json.load(g)
    for name in ("weights.npz", "draft_weights.npz"):
        a, b = np.load(os.path.join(jdir, name)), np.load(os.path.join(tdir, name))
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert is_decode_endpoint(jdir) and not is_decode_endpoint(str(tmp_path))
    rungs = dict(slot_ladder=[2], len_ladder=[24])
    want = _endpoint_tokens(jdecode.load_decode_endpoint(jdir, **rungs), True)
    port_srv = load_decode_endpoint(jdir, place=CPU, **rungs)
    assert port_srv.speculative_k == 4 and port_srv.prefix_cache.capacity_bytes == 1 << 20
    assert _endpoint_tokens(port_srv, False) == want
    assert _endpoint_tokens(jdecode.load_decode_endpoint(tdir, **rungs), True) == want
    assert want[0] == want[1]  # speculation changes speed, not tokens


def test_endpoint_refuses_a_short_positional_table(tmp_path, lm_state):
    with pytest.raises(ValueError, match="pos_emb"):
        save_decode_endpoint(str(tmp_path / "x"), lm_state, vocab_size=V, d_model=LM["d_model"],
                             n_layer=LM["n_layer"], n_head=LM["n_head"], d_inner=LM["d_inner"],
                             eos_id=EOS, max_seq_len=64)


def test_load_without_a_card_raises_without_a_place(tmp_path, lm_state):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is usable")
    d = str(tmp_path / "e")
    save_decode_endpoint(d, lm_state, vocab_size=V, d_model=LM["d_model"], n_layer=LM["n_layer"],
                         n_head=LM["n_head"], d_inner=LM["d_inner"], eos_id=EOS, max_seq_len=24)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_decode_endpoint(d)


# ---------------------------------------------------------------------------
# the hot-path guard over the decode files
# ---------------------------------------------------------------------------
DECODE_FILES = ["paddle_tpu_torch/quant.py", "paddle_tpu_torch/serving/kv_pool.py",
                "paddle_tpu_torch/serving/decode.py"]


def test_hot_path_guard_covers_the_decode_regions():
    from paddle_tpu_torch.tools import check_hot_path

    assert check_hot_path.check_files(REPO) == []
    assert set(DECODE_FILES) <= set(check_hot_path.CHECKED_FILES)
    labels = set()
    for rel in DECODE_FILES:
        with open(os.path.join(REPO, rel)) as f:
            for line in f:
                m = check_hot_path._BEGIN.search(line)
                if m:
                    labels.add(m.group("label"))
    assert {"kv_chunk", "kv_admit", "kv_admit_prefix", "decode_tick", "int8_quant"} <= labels


def test_hot_path_guard_fails_on_a_sync_in_decode_tick(tmp_path):
    from paddle_tpu_torch.tools import check_hot_path

    for rel in check_hot_path.CHECKED_FILES:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), dst)
    path = tmp_path / "paddle_tpu_torch/serving/decode.py"
    src = path.read_text()
    marker = "                    state = self._pool.chunk(self._state)\n"
    assert marker in src
    path.write_text(src.replace(
        marker, marker + "                    n = int(state['pos'].sum().item())\n", 1))
    bad = check_hot_path.check_files(str(tmp_path))
    assert len(bad) == 1 and bad[0][0].endswith("serving/decode.py") and bad[0][2] == ".item()"
