"""The int8 KV cache of ``paddle_tpu_torch`` on the CPU, against the JAX
package: ``quant.quantize_rows`` / ``dequantize_rows`` (codes and scales
bit for bit), the int8 pooled step and verify fns (logits within 1e-5,
codes equal and scales within 1e-6 at the written rows), the plain
version of kernel B3 (``kernels.decode_attention``) within 1e-6 of the
JAX package's dequant-at-attend, the pool's byte accounting (at least
1.8x the concurrent sequences of fp32 at a fixed budget, at every rung
pair), and the int8 ``DecodeServer``'s greedy tokens, alone and with
the prefix cache and a draft, equal to the JAX package's.

Small sizes: the LM of ``tests/test_int8_kv.py`` (V = 64, d_model 32,
2 layers, 4 heads, max_pos 64, weights from ``RandomState(7)``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import decoding as tdec
from paddle_tpu_torch import quant as tquant
from paddle_tpu_torch.kernels import decode_attention as kda
from paddle_tpu_torch.serving.decode import DecodeServer
from paddle_tpu_torch.serving.kv_pool import KVSlotPool
from paddle_tpu_torch.serving.prefix_cache import PrefixKVCache
from paddle_tpu_torch.serving.speculative import make_lm_speculative

V = 64
LM = dict(vocab=V, d_model=32, n_layer=2, n_head=4, d_inner=64, max_pos=64)
DIMS = [LM[k] for k in ("vocab", "d_model", "n_layer", "n_head", "d_inner")]
DRAFT = dict(d_model=16, n_layer=1, n_head=2, d_inner=32)
EOS = V - 1
CPU = tfluid.CPUPlace()
LOGIT_TOL = 1e-5
SCALE_TOL = 1e-6
PLAIN_TOL = 1e-6
SEQS_FLOOR = 1.8  # the JAX package's acceptance floor (bench_serving.py)


@pytest.fixture(scope="module")
def lm_state():
    return tdec.random_transformer_lm_state(np.random.RandomState(7), **LM)


# ---------------------------------------------------------------------------
# quant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((7, 16), 1.0), ((3, 5, 64), 3.0), ((2, 4, 9, 32), 1e-3),
                                         ((6, 8), 1e4)])
def test_quantize_rows_bit_for_bit_with_jax(shape, scale):
    import jax.numpy as jnp

    from paddle_tpu import quant as jquant

    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * scale).astype(np.float32)
    x.reshape(-1, shape[-1])[0] = 0.0                            # a zero row
    x.reshape(-1, shape[-1])[1, :4] = [0.5, -0.5, 1.5, -127.0]   # rounding ties
    jq, js = jquant.quantize_rows(jnp.asarray(x))
    tq, ts = tquant.quantize_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    jd = jquant.dequantize_rows(jq, js)
    td = tquant.dequantize_rows(tq, ts)
    np.testing.assert_array_equal(td.numpy().view(np.uint32), np.asarray(jd).view(np.uint32))


def test_quantize_rows_identity_and_zero_rows():
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(9, 24).astype(np.float32))
    x[3] = 0.0
    q, s = tquant.quantize_rows(x)
    assert (q.abs().amax(-1)[torch.arange(9) != 3] == 127).all()  # the max lands on ±127
    assert (q[3] == 0).all() and float(s[3]) == float(np.float32(tquant.INT8_SCALE_FLOOR))
    assert (tquant.dequantize_rows(q, s)[3] == 0).all()
    q2, s2 = tquant.quantize_rows(tquant.dequantize_rows(q, s))
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert tquant.INT8_SCALE_FLOOR == 1e-8


def test_kv_dtype_normalization():
    assert tdec.KV_DTYPES == ("fp32", "int8")
    assert tdec.normalize_kv_dtype(None) == "fp32"
    assert tdec.normalize_kv_dtype("float32") == "fp32"
    assert tdec.normalize_kv_dtype("int8") == "int8"
    with pytest.raises(ValueError):
        tdec.normalize_kv_dtype("fp8")


# ---------------------------------------------------------------------------
# kernel B3's plain version
# ---------------------------------------------------------------------------
def _jax_dequant_attend(q, kc, ks, vc, vs, ts, scale):
    """The JAX package's int8 attention (decoding.py's verify fn math,
    K queries a slot; K = 1 is the step's)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.quant import dequantize_rows

    S, K = q.shape[:2]
    T = kc.shape[2]
    p = jnp.minimum(jnp.asarray(ts)[:, None] + jnp.arange(K)[None, :], T - 1)
    pos_ok = jnp.arange(T)[None, None, None, :] <= p[:, :, None, None]
    kf = dequantize_rows(jnp.asarray(kc), jnp.asarray(ks))
    vf = dequantize_rows(jnp.asarray(vc), jnp.asarray(vs))
    scores = jnp.einsum("skhd,shtd->skht", jnp.asarray(q), kf) * scale
    w = jax.nn.softmax(jnp.where(pos_ok, scores, -1e9), axis=-1)
    return np.asarray(jnp.einsum("skht,shtd->skhd", w, vf))


def _b3_inputs(rng, S, H, T, Dh, K):
    q = rng.randn(S, K, H, Dh).astype(np.float32)
    k = rng.randn(S, H, T, Dh).astype(np.float32) * rng.uniform(0.1, 4.0, (S, H, T, 1))
    v = rng.randn(S, H, T, Dh).astype(np.float32)
    kc, ks = tquant.quantize_rows(torch.from_numpy(k.astype(np.float32)))
    vc, vs = tquant.quantize_rows(torch.from_numpy(v))
    ts = np.concatenate([[0, T - 1, T - K], rng.randint(0, T - K + 1, S - 3)]).astype(np.int32)
    return q, kc.numpy(), ks.numpy(), vc.numpy(), vs.numpy(), ts


@pytest.mark.parametrize("K", [1, 4])
def test_decode_attention_plain_matches_jax(K):
    rng = np.random.RandomState(K)
    S, H, T, Dh = 6, 4, 40, 16
    q, kc, ks, vc, vs, ts = _b3_inputs(rng, S, H, T, Dh, K)
    scale = 1.0 / np.sqrt(Dh)
    want = _jax_dequant_attend(q, kc, ks, vc, vs, ts, scale)
    args = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs, ts)]
    got = kda.decode_attention(*args, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PLAIN_TOL)
    assert torch.equal(got, kda.decode_attention_plain(*args, scale))
    meta = kda.decode_attention(*(a.to("meta") for a in args), scale)
    assert meta.shape == got.shape and meta.device.type == "meta"


def test_decode_attention_reads_nothing_past_the_position():
    """Codes and scales past ``ts + j`` do not change the answer (the
    kernel skips them; the plain version masks them)."""
    rng = np.random.RandomState(5)
    q, kc, ks, vc, vs, ts = _b3_inputs(rng, 4, 2, 24, 16, 4)
    args = [torch.from_numpy(a) for a in (q, kc, ks, vc, vs, ts)]
    base = kda.decode_attention(*args, 0.25)
    for s in range(4):
        lim = min(int(ts[s]) + 3, 23)
        for a in (args[1], args[3]):
            a[s, :, lim + 1:] = 77
        for a in (args[2], args[4]):
            a[s, :, lim + 1:] = 1e6
    assert torch.equal(kda.decode_attention(*args, 0.25), base)


# ---------------------------------------------------------------------------
# the int8 builders against the JAX package's
# ---------------------------------------------------------------------------
def _cache_equal_at(jcache, tcache, rows_ts):
    import jax

    for a, b in zip(jax.tree_util.tree_leaves(jcache), tdec.kv_tree_leaves(tcache)):
        a = np.asarray(a)
        b = b.numpy()
        for r, t in rows_ts:
            if a.dtype == np.int8:
                np.testing.assert_array_equal(b[r, :, t], a[r, :, t])
            else:
                np.testing.assert_allclose(b[r, :, t], a[r, :, t], rtol=SCALE_TOL, atol=0)


def test_int8_pooled_step_matches_jax(lm_state):
    import jax
    import jax.numpy as jnp

    from paddle_tpu import decoding as jdec

    jstep, jmc = jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8")
    jstep = jax.jit(jstep)
    tstep, tmc = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8",
                                                         place=CPU)
    jc, tc = jmc(3, 24), tmc(3, 24)
    assert {str(x.dtype) for x in tdec.kv_tree_leaves(tc)} == {"torch.int8", "torch.float32"}
    rng = np.random.RandomState(2)
    written = []
    for i in range(8):
        toks = rng.randint(0, V, 3).astype(np.int32)
        ts = np.array([i, (2 * i) % 24, 23 - i], np.int32)
        jl, jc = jstep(jc, jnp.asarray(toks), jnp.asarray(ts))
        tl, tc = tstep(tc, torch.from_numpy(toks), torch.from_numpy(ts))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
        written += [(r, int(t)) for r, t in enumerate(ts)]
    _cache_equal_at(jc, tc, written)


def test_int8_verify_fn_matches_jax(lm_state):
    import jax
    import jax.numpy as jnp

    from paddle_tpu import decoding as jdec

    jstep, jmc = jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8")
    tstep, tmc = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8",
                                                         place=CPU)
    jc, tc = jmc(2, 16), tmc(2, 16)
    rng = np.random.RandomState(4)
    for i in range(4):
        toks = rng.randint(0, V, 2).astype(np.int32)
        ts = np.array([i, i], np.int32)
        _, jc = jax.jit(jstep)(jc, jnp.asarray(toks), jnp.asarray(ts))
        _, tc = tstep(tc, torch.from_numpy(toks), torch.from_numpy(ts))
    jv = jax.jit(jdec.make_transformer_lm_pooled_verify_fn(lm_state, *DIMS, kv_dtype="int8"))
    tv = tdec.make_transformer_lm_pooled_verify_fn(lm_state, *DIMS, kv_dtype="int8", place=CPU)
    vt = rng.randint(0, V, (2, 4)).astype(np.int32)
    ts = np.array([4, 9], np.int32)
    jl, jc = jv(jc, jnp.asarray(vt), jnp.asarray(ts))
    tl, tc = tv(tc, torch.from_numpy(vt), torch.from_numpy(ts))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_TOL)
    _cache_equal_at(jc, tc, [(r, int(t) + j) for r, t in enumerate(ts) for j in range(4)])


def test_int8_greedy_tracks_fp32(lm_state):
    """Greedy decode from the int8 cache tracks the fp32 one token for
    token over 12 steps (the JAX package's drill)."""
    s32, m32 = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, place=CPU)
    s8, m8 = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8", place=CPU)
    c32, c8 = m32(2, 24), m8(2, 24)
    tok32 = tok8 = torch.tensor([3, 5], dtype=torch.int32)
    for i in range(12):
        ts = torch.full((2,), i, dtype=torch.int32)
        l32, c32 = s32(c32, tok32, ts)
        l8, c8 = s8(c8, tok8, ts)
        tok32 = torch.argmax(l32, -1).to(torch.int32)
        tok8 = torch.argmax(l8, -1).to(torch.int32)
        assert torch.equal(tok32, tok8)


def test_pool_bytes_and_sequences_at_fixed_hbm(lm_state):
    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving.kv_pool import KVSlotPool as JPool

    pools = {}
    for dt in ("fp32", "int8"):
        sf, mc = tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype=dt, place=CPU)
        pools[dt] = KVSlotPool(sf, mc, eos_id=EOS, max_slots=4, max_seq_len=32, steps=2,
                               kv_dtype=dt)
        assert pools[dt].kv_dtype == dt
        jpool = JPool(*jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype=dt),
                      eos_id=EOS, max_slots=4, max_seq_len=32, steps=2, kv_dtype=dt)
        for s, t in pools[dt].rung_pairs():
            assert pools[dt].kv_rung_bytes(s, t) == jpool.kv_rung_bytes(s, t)
    for s, t in pools["fp32"].rung_pairs():
        b32 = pools["fp32"].kv_rung_bytes(s, t)
        b8 = pools["int8"].kv_rung_bytes(s, t)
        budget = 4 * b32
        assert (budget // b8) * s >= SEQS_FLOOR * (budget // b32) * s, (s, t)
    st8 = pools["int8"].alloc(2, 16)
    assert pools["int8"].kv_state_bytes(st8) == pools["int8"].kv_rung_bytes(2, 16)


# ---------------------------------------------------------------------------
# the int8 servers against the JAX package's
# ---------------------------------------------------------------------------
PROMPTS = [[3, 5, 7], [11], [2, 4, 6, 8, 10], [13, 1]]
CAPS = [9, 12, 6, 10]
SERVER_KW = dict(eos_id=EOS, max_seq_len=32, max_slots=2, slot_ladder=[2], len_ladder=[32],
                 steps_per_tick=3, kv_dtype="int8")


def _spec_kw(lm_state):
    draft = tdec.random_transformer_lm_state(np.random.RandomState(8), vocab=V,
                                             max_pos=LM["max_pos"], name="draft", **DRAFT)
    return dict(vocab_size=V, d_model=LM["d_model"], n_layer=LM["n_layer"], n_head=LM["n_head"],
                d_inner=LM["d_inner"], draft_state=draft, draft_d_model=DRAFT["d_model"],
                draft_n_layer=DRAFT["n_layer"], draft_n_head=DRAFT["n_head"],
                draft_d_inner=DRAFT["d_inner"], k=4, kv_dtype="int8")


def _serve(srv, spec=False):
    shared = [1, 2, 3, 4, 5, 6, 7, 8]
    out = []
    for p, c in zip(PROMPTS, CAPS):
        out.append(np.asarray(srv.submit({"tokens": np.asarray(p, np.int32)}, max_new_tokens=c,
                                         speculative=spec).result(timeout=60.0)[0]).tolist())
    if srv.prefix_cache is not None:  # two prompts over a shared 8-token head
        for sfx in ([9], [10, 11]):
            out.append(np.asarray(srv.submit({"tokens": np.asarray(shared + sfx, np.int32)},
                                             max_new_tokens=6, speculative=spec)
                                  .result(timeout=60.0)[0]).tolist())
            deadline = 100
            while srv.prefix_cache.stats()["entries"] == 0 and deadline:
                import time

                time.sleep(0.01)
                deadline -= 1
    return out


@pytest.mark.parametrize("mode", ["plain", "prefix_spec"])
def test_int8_server_tokens_equal_jax(lm_state, mode):
    from paddle_tpu import decoding as jdec
    from paddle_tpu.serving.decode import DecodeServer as JServer
    from paddle_tpu.serving.prefix_cache import PrefixKVCache as JCache
    from paddle_tpu.serving.speculative import make_lm_speculative as jspec

    jkw, tkw = {}, {}
    spec = mode == "prefix_spec"
    if spec:
        jkw = dict(prefix_cache=JCache(1 << 20, 4, name="j8"), speculative=jspec(lm_state,
                                                                              **_spec_kw(lm_state)))
        tkw = dict(prefix_cache=PrefixKVCache(1 << 20, 4, name="t8"),
                   speculative=make_lm_speculative(lm_state, place=CPU, **_spec_kw(lm_state)))
    jsrv = JServer(*jdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8"),
                   name="j8-" + mode, **SERVER_KW, **jkw)
    jsrv.warmup(configure_cache=False)
    try:
        want = _serve(jsrv, spec)
    finally:
        jsrv.stop(drain=False)
    srv = DecodeServer(*tdec.make_transformer_lm_pooled_step_fn(lm_state, *DIMS, kv_dtype="int8",
                                                               place=CPU),
                       name="t8-" + mode, **SERVER_KW, **tkw)
    srv.warmup()
    try:
        got = _serve(srv, spec)
        m = srv.metrics()["decode"]
        assert m["kv_dtype"] == "int8" and srv.kv_dtype == "int8"
        assert srv._pool.jit_cache_stats()["misses"] == 0
        if spec:
            assert srv.prefix_cache.stats()["hits"] >= 1
            assert m["speculative"]["proposed_tokens"] > 0
    finally:
        srv.stop(drain=False)
    assert got == want


def test_int8_endpoint_manifest_round_trip(tmp_path, lm_state):
    from paddle_tpu.serving import decode as jdecode
    from paddle_tpu_torch.serving.decode import load_decode_endpoint, save_decode_endpoint

    kw = dict(vocab_size=V, d_model=LM["d_model"], n_layer=LM["n_layer"], n_head=LM["n_head"],
              d_inner=LM["d_inner"], eos_id=EOS, max_seq_len=32, max_slots=2, kv_dtype="int8")
    d = str(tmp_path / "e8")
    save_decode_endpoint(d, lm_state, **kw)
    srv = load_decode_endpoint(d, place=CPU, slot_ladder=[2], len_ladder=[32])
    jsrv = jdecode.load_decode_endpoint(d, slot_ladder=[2], len_ladder=[32])
    try:
        assert srv.kv_dtype == "int8" and jsrv.kv_dtype == "int8"
        srv.warmup()
        jsrv.warmup(configure_cache=False)
        prompt = {"tokens": np.array([3, 5, 7], np.int32)}
        got = srv.submit(prompt, max_new_tokens=8).result(timeout=60.0)[0]
        want = jsrv.submit(prompt, max_new_tokens=8).result(timeout=60.0)[0]
        assert np.asarray(got).tolist() == np.asarray(want).tolist()
        assert srv.metrics()["decode"]["kv_cache_bytes"] == 0  # idle again
    finally:
        srv.stop(drain=False)
        jsrv.stop(drain=False)
