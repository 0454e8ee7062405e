"""``paddle_tpu_torch.decoding`` (its fp32 half) against the JAX
package's ``decoding.py``: greedy and beam search over a Transformer NMT
program (full prefix, ``make_program_logits_fn``), with and without a
length penalty; the KV-cached beam and greedy search of a
``transformer_lm`` against its full-prefix decode; and beams over
constructed ties (uniform logits), where ``jax.lax.top_k`` puts the
lower index first.

Small sizes (vocab 23, d_model 32, 2 layers, 4 heads; sources 9 long,
targets 7; 3 sources, beam 3); weights from the JAX package's startup,
inputs from a numpy seed.  Tokens exactly equal to the JAX package's,
scores within 1e-4 (rtol and atol); cached and full-prefix tokens equal
in the port, scores within 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import decoding as jdec
from paddle_tpu.models import seq2seq as js2s
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch import decoding as tdec
from paddle_tpu_torch.models import seq2seq as ts2s
from paddle_tpu_torch.models import transformer as ttr
from torch_parity_util import jax_startup_state

V, D, L, H, DI = 23, 32, 2, 4, 64
S, TGT, B, K = 9, 7, 3, 3
BOS, EOS = 1, 2
TOL = dict(rtol=1e-4, atol=1e-4)
CPU = tfluid.CPUPlace()


def _nmt(fluid, s2s):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 61
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [S], dtype="int64")
        tgt = fluid.layers.data("tgt", [TGT], dtype="int64")
        smask = fluid.layers.data("smask", [S])
        _, logits = s2s.transformer_nmt(src, tgt, None, src_mask=smask, src_vocab=V, tgt_vocab=V,
                                        d_model=D, n_layer=L, n_head=H, d_inner=DI, src_len=S,
                                        tgt_len=TGT, is_test=True)
    return main, startup, logits


def _jax_arrays(state):
    """The JAX package's decode loop indexes its weights with traced ids:
    they must be jax arrays, not numpy."""
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in state.items()}


@pytest.fixture(scope="module")
def nmt():
    jm, js, jl = _nmt(jfluid, js2s)
    tm, _, tl = _nmt(tfluid, ts2s)
    state = jax_startup_state(js, jm)
    feeds = ["src", "tgt", "smask"]
    jfn = jdec.make_program_logits_fn(jm, _jax_arrays(state), feeds, jl.name)
    tfn = tdec.make_program_logits_fn(tm, state, feeds, tl.name, place=CPU)
    rng = np.random.RandomState(62)
    src = rng.randint(3, V, (B, S)).astype("int64")
    lens = np.array([9, 5, 7])
    smask = (np.arange(S)[None, :] < lens[:, None]).astype("float32")
    return jfn, tfn, src, smask


@pytest.mark.parametrize("penalty", [0.0, 0.6])
@pytest.mark.parametrize("beam", [1, K])
def test_nmt_beam_and_greedy(nmt, beam, penalty):
    jfn, tfn, src, smask = nmt
    kw = dict(beam_size=beam, max_len=TGT, length_penalty=penalty)
    jt, js_ = jdec.beam_search(jfn, src, BOS, EOS, extra_feeds={"smask": smask}, **kw)
    tt, ts_ = tdec.beam_search(tfn, src, BOS, EOS, extra_feeds={"smask": smask}, **kw)
    assert tfn.device == torch.device("cpu") and tt.device.type == "cpu"
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), **TOL)
    if beam == 1 and penalty == 0.0:
        jg, jgs = jdec.greedy_search(jfn, src, BOS, EOS, max_len=TGT, extra_feeds={"smask": smask})
        tg, tgs = tdec.greedy_search(tfn, src, BOS, EOS, max_len=TGT, extra_feeds={"smask": smask})
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_allclose(tgs.numpy(), np.asarray(jgs), **TOL)
        np.testing.assert_array_equal(tg.numpy(), tt[:, 0].numpy())


def test_nmt_logits_fn_matches_the_program(nmt):
    jfn, tfn, src, smask = nmt
    tgt = np.random.RandomState(63).randint(0, V, (B, TGT)).astype("int64")
    feeds = {"src": src, "tgt": tgt, "smask": smask}
    np.testing.assert_allclose(tfn(feeds).numpy(), np.asarray(jfn(feeds)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("beam", [1, K])
def test_uniform_logits_ties(beam):
    """Every token equally likely: each step keeps the lowest-index
    tokens, in the JAX package's order."""
    def jfn(feeds):
        import jax.numpy as jnp
        return jnp.zeros((feeds["tgt"].shape[0], TGT, V), "float32")

    def tfn(feeds):
        return torch.zeros((feeds["tgt"].shape[0], TGT, V))

    src = np.zeros((B, 1), "int64")
    jt, js_ = jdec.beam_search(jfn, src, BOS, EOS, beam_size=beam, max_len=TGT)
    tt, ts_ = tdec.beam_search(tfn, torch.from_numpy(src), BOS, EOS, beam_size=beam, max_len=TGT)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), **TOL)
    if beam == 1:
        np.testing.assert_array_equal(tt.numpy()[:, 0, 1:], 0)  # the lowest index wins each tie


LM = dict(vocab=19, d_model=16, n_layer=2, n_head=2, d_inner=32, max_pos=10)


def _lm_state_and_logits(seed):
    """transformer_lm's unfused inference program at LM's widths, with
    random_transformer_lm_state's weights: its logits_fn in each package."""
    state = jdec.random_transformer_lm_state(np.random.RandomState(seed), **LM)
    fns = []
    for fluid, tr, dec in ((jfluid, jtr, jdec), (tfluid, ttr, tdec)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data("src", [LM["max_pos"]], dtype="int64")
            _, logits = tr.transformer_lm(ids, None, vocab_size=LM["vocab"], d_model=LM["d_model"],
                                          n_layer=LM["n_layer"], n_head=LM["n_head"],
                                          d_inner=LM["d_inner"], seq_len=LM["max_pos"],
                                          max_pos=LM["max_pos"], dropout_rate=0.0, is_test=True,
                                          fused_attention=False)
        assert {p.name for p in main.all_parameters()} == set(state)
        if dec is tdec:
            pfn = dec.make_program_logits_fn(main, state, ["src"], logits.name, place=CPU)
        else:
            pfn = dec.make_program_logits_fn(main, _jax_arrays(state), ["src"], logits.name)
        fns.append(lambda feeds, pfn=pfn: pfn({"src": feeds["tgt"]}))
    return state, fns


def test_cached_decode_matches_full_prefix_and_jax():
    state, (jfull, tfull) = _lm_state_and_logits(3)
    ML, dims = LM["max_pos"], [LM[k] for k in ("vocab", "d_model", "n_layer", "n_head", "d_inner")]
    jstep, jcache = jdec.make_transformer_lm_step_fn(_jax_arrays(state), *dims, ML)
    tstep, tcache = tdec.make_transformer_lm_step_fn(state, *dims, ML, place=CPU)
    src = torch.zeros((B, 1), dtype=torch.int64)
    t_full = tdec.beam_search(tfull, src, BOS, EOS, beam_size=K, max_len=ML)
    t_c = tdec.beam_search_cached(tstep, tcache(B * K), B, BOS, EOS, beam_size=K, max_len=ML)
    j_c = jdec.beam_search_cached(jstep, jcache(B * K), B, BOS, EOS, beam_size=K, max_len=ML)
    np.testing.assert_array_equal(t_c[0].numpy(), t_full[0].numpy())
    np.testing.assert_allclose(t_c[1].numpy(), t_full[1].numpy(), **TOL)
    np.testing.assert_array_equal(t_c[0].numpy(), np.asarray(j_c[0]))
    np.testing.assert_allclose(t_c[1].numpy(), np.asarray(j_c[1]), **TOL)
    g_full = tdec.greedy_search(tfull, src, BOS, EOS, max_len=ML)
    g_c = tdec.greedy_search_cached(tstep, tcache(B), B, BOS, EOS, max_len=ML)
    jg_c = jdec.greedy_search_cached(jstep, jcache(B), B, BOS, EOS, max_len=ML, length_penalty=0.0)
    np.testing.assert_array_equal(g_c[0].numpy(), g_full[0].numpy())
    np.testing.assert_array_equal(g_c[0].numpy(), np.asarray(jg_c[0]))
    np.testing.assert_allclose(g_c[1].numpy(), np.asarray(jg_c[1]), **TOL)


def test_cached_step_logits_under_teacher_forcing():
    """Each position's cached-step logits equal the full program's at
    that position, for a fixed token sequence (within 1e-4)."""
    state, (_, tfull) = _lm_state_and_logits(4)
    ML, dims = LM["max_pos"], [LM[k] for k in ("vocab", "d_model", "n_layer", "n_head", "d_inner")]
    tstep, tcache = tdec.make_transformer_lm_step_fn(state, *dims, ML, place=CPU)
    toks = torch.from_numpy(np.random.RandomState(5).randint(0, LM["vocab"], (2, ML)))
    full = tfull({"tgt": toks})
    cache = tcache(2)
    for t in range(ML):
        logits, cache = tstep(cache, toks[:, t], t)
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), rtol=1e-4, atol=1e-4)


def test_int8_kv_and_entry_points_without_a_card():
    with pytest.raises(NotImplementedError, match="A8"):
        tdec._lm_forward_one({}, "lm", [{"k": torch.zeros(1, 1, 2, 1)}], torch.zeros(1, 1), 0,
                             1, 1, 1, 1, 1.0, kv_int8=True)
    assert tdec.normalize_kv_dtype("float32") == "fp32"
    if not torch.cuda.is_available():
        state = tdec.random_transformer_lm_state(np.random.RandomState(0), **LM)
        with pytest.raises(RuntimeError, match="CUDA"):
            tdec.make_transformer_lm_step_fn(state, 19, 16, 2, 2, 32, 10)
