"""The seq2seq slice of paddle_tpu_torch against paddle_tpu:
``models.seq2seq.transformer_nmt`` and the Fluid book's two RNN
translation programs (``tests/book/test_machine_translation.py`` and
``tests/book/test_rnn_encoder_decoder.py``).

Small sizes: NMT vocab 40/48, d_model 32, 2+2 layers, 4 heads, d_inner
64, sources 10 long and targets 7 (``src_len != tgt_len``), batch 4 with
ragged source lengths carried by ``src_mask``; the book programs at the
book tests' sizes.  Inputs from a numpy seed; both packages start from
the JAX package's startup state.

* NMT desc parity in fp32 and bf16 AMP (main and startup).
* NMT run parity: loss within rtol 1e-5 and logits within 1e-5 at step
  0; then 3 Adam steps, losses within rtol 1e-4 and every parameter
  within atol 1e-5 (rtol 1e-4).  As in tests/test_torch_transformer_lm.py,
  the key-projection biases (``*_k_b``) have a zero true gradient (a
  bias on every key adds one constant to a query's logits), so both
  frameworks compute rounding noise there that Adam scales up to an
  update of size lr; they are held to 2 lr a step instead.  A padded
  source position moves neither the loss nor the logits (``src_mask``
  reaches the encoder bias and the cross bias).
* The two book programs: desc parity, and 3 steps (Adam, Adagrad) to the
  same losses and parameters (rtol 1e-4, atol 1e-5).
* The JAX package's ``save_inference_model`` of the book's
  ``While(max_trip_count=...)`` beam decode, served by the port's
  ``AnalysisPredictor``: the same ``SentenceIds``, scores within 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import seq2seq as js2s
from paddle_tpu_torch.models import seq2seq as ts2s
from torch_parity_util import assert_same_program, jax_startup_state, run_jax, run_port

PKG = {"jax": (jfluid, js2s), "torch": (tfluid, ts2s)}
NMT = dict(src_vocab=40, tgt_vocab=48, d_model=32, n_layer=2, n_head=4, d_inner=64, src_len=10,
           tgt_len=7)
BATCH = 4
LR = 1e-3
STEP_TOL = dict(rtol=1e-4, atol=1e-5)


def nmt_program(pkg, amp=False, train=True):
    fluid, s2s = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 17
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [NMT["src_len"]], dtype="int64")
        tgt = fluid.layers.data("tgt", [NMT["tgt_len"]], dtype="int64")
        lbl = fluid.layers.data("lbl", [NMT["tgt_len"], 1], dtype="int64")
        smask = fluid.layers.data("smask", [NMT["src_len"]])
        loss, logits = s2s.transformer_nmt(src, tgt, lbl, src_mask=smask, **NMT)
        if train:
            opt = fluid.optimizer.AdamOptimizer(LR)
            if amp:
                opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(loss)
    return main, startup, loss, logits


def nmt_feed(seed, rows=BATCH):
    rng = np.random.RandomState(seed)
    S, T = NMT["src_len"], NMT["tgt_len"]
    lens = rng.randint(S // 2, S + 1, rows)
    lens[0] = S
    return {"src": rng.randint(0, NMT["src_vocab"], (rows, S)).astype("int64"),
            "tgt": rng.randint(0, NMT["tgt_vocab"], (rows, T)).astype("int64"),
            "lbl": rng.randint(0, NMT["tgt_vocab"], (rows, T, 1)).astype("int64"),
            "smask": (np.arange(S)[None, :] < lens[:, None]).astype("float32")}


@pytest.mark.parametrize("amp", [False, True])
def test_nmt_desc_parity(amp):
    jm, js, jl, jlog = nmt_program("jax", amp)
    tm, ts, tl, tlog = nmt_program("torch", amp)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    assert (tl.name, tlog.name) == (jl.name, jlog.name)
    types = [op.type for op in tm.global_block().ops]
    assert "fused_attention" not in types and types.count("softmax") == 3 * NMT["n_layer"]


def test_nmt_logits_loss_and_adam_steps():
    jm, js, jl, jlog = nmt_program("jax")
    tm, _, tl, tlog = nmt_program("torch")
    state = jax_startup_state(js, jm)
    feeds = [nmt_feed(100 + i) for i in range(3)]
    jout, jscope = run_jax(jm, state, feeds, [jl.name, jlog.name], steps=3)
    tout, tscope = run_port(tm, state, feeds, [tl.name, tlog.name], steps=3)
    assert tout[0][1].shape == (BATCH, NMT["tgt_len"], NMT["tgt_vocab"])
    np.testing.assert_allclose(tout[0][1], jout[0][1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([float(o[0]) for o in tout], [float(o[0]) for o in jout], **STEP_TOL)
    for p in jm.all_parameters():
        got, want = tscope.get(p.name).numpy(), np.asarray(jscope.get(p.name))
        if p.name.endswith("_k_b"):  # zero true gradient: Adam scales rounding noise to lr
            assert np.abs(got - want).max() <= 2 * LR * 3, p.name
            continue
        np.testing.assert_allclose(got, want, err_msg=p.name, **STEP_TOL)


def test_nmt_padding_moves_nothing():
    """A token at a masked source position changes neither the loss nor
    the logits: the mask reaches the encoder's and the cross attention's
    bias."""
    jm, js, _, _ = nmt_program("jax")
    tm, _, tl, tlog = nmt_program("torch", train=False)
    state = jax_startup_state(js, jm)
    feed = nmt_feed(7)
    other = dict(feed, src=feed["src"].copy())
    other["src"][feed["smask"] == 0] = (other["src"][feed["smask"] == 0] + 1) % NMT["src_vocab"]
    assert (feed["smask"] == 0).any()
    (a,), _ = run_port(tm, state, feed, [tlog.name])
    (b,), _ = run_port(tm, state, other, [tlog.name])
    np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-6)
    c = run_port(tm, state, dict(feed, src=np.roll(feed["src"], 1, axis=1)), [tlog.name])[0][0][0]
    assert np.abs(c - a[0]).max() > 1e-3  # a real source token does move them


# ---------------------------------------------------------------------------
# the Fluid book's RNN translation programs
# ---------------------------------------------------------------------------
BV, BD, BH, BK, T_SRC, T_TGT, MAX_LEN, START, END = 30, 8, 16, 2, 6, 5, 6, 1, 2


def _mt_encoder(fluid, src, src_len):
    emb = fluid.layers.embedding(src, size=[BV, BD], param_attr=fluid.ParamAttr(name="mt_vemb"))
    fc1 = fluid.layers.fc(emb, BH * 4, num_flatten_dims=2, act="tanh",
                          param_attr=fluid.ParamAttr(name="mt_enc_fc"))
    hidden, _ = fluid.layers.dynamic_lstm(fc1, size=BH * 4, seq_len=src_len,
                                          param_attr=fluid.ParamAttr(name="mt_enc_lstm"))
    return fluid.layers.sequence_last_step(hidden, seq_len=src_len)


def _mt_decoder_step(fluid, word_emb, state):
    cur = fluid.layers.fc([word_emb, state], BH, act="tanh",
                          param_attr=[fluid.ParamAttr(name="mt_dec_word_fc"),
                                      fluid.ParamAttr(name="mt_dec_state_fc")])
    logits = fluid.layers.fc(cur, BV, param_attr=fluid.ParamAttr(name="mt_dec_score_fc"))
    return cur, logits


def machine_translation_train(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 77
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [T_SRC], dtype="int64", lod_level=1)
        src_len = main.global_block().var("src_seq_len")
        trg = fluid.layers.data("trg", [T_TGT], dtype="int64")
        nxt = fluid.layers.data("nxt", [T_TGT, 1], dtype="int64")
        context = _mt_encoder(fluid, src, src_len)
        trg_emb = fluid.layers.embedding(trg, size=[BV, BD],
                                         param_attr=fluid.ParamAttr(name="mt_vemb_t"))
        trg_len = fluid.layers.fill_constant_batch_size_like(context, shape=[-1], dtype="int32",
                                                             value=T_TGT)
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            cur_word = rnn.step_input(trg_emb, seq_len=trg_len)
            pre_state = rnn.memory(init=context)
            cur_state, logits = _mt_decoder_step(fluid, cur_word, pre_state)
            rnn.update_memory(pre_state, cur_state)
            rnn.output(logits)
        cost = fluid.layers.softmax_with_cross_entropy(rnn(), nxt)
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.AdamOptimizer(0.02).minimize(avg_cost)
    return main, startup, avg_cost


def machine_translation_decode(fluid, B):
    BKL = B * BK
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 78
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [T_SRC], dtype="int64", lod_level=1)
        src_len = main.global_block().var("src_seq_len")
        init_ids = fluid.layers.data("init_ids", [1], dtype="int64")
        init_scores = fluid.layers.data("init_scores", [1])
        context = _mt_encoder(fluid, src, src_len)
        state0 = fluid.layers.reshape(
            fluid.layers.expand(fluid.layers.reshape(context, shape=[-1, 1, BH]), [1, BK, 1]),
            shape=[BKL, BH])
        counter = fluid.layers.zeros(shape=[1], dtype="int64")
        array_len = fluid.layers.fill_constant([1], "int64", MAX_LEN)
        state_arr = fluid.layers.create_array(MAX_LEN + 1, [BKL, BH])
        ids_arr = fluid.layers.create_array(MAX_LEN + 1, [BKL, 1], "int64")
        score_arr = fluid.layers.create_array(MAX_LEN + 1, [BKL, 1])
        parent_arr = fluid.layers.create_array(MAX_LEN + 1, [BKL], "int32")
        state_arr = fluid.layers.array_write(state0, counter, state_arr)
        ids_arr = fluid.layers.array_write(fluid.layers.reshape(init_ids, shape=[BKL, 1]), counter,
                                           ids_arr)
        score_arr = fluid.layers.array_write(fluid.layers.reshape(init_scores, shape=[BKL, 1]),
                                             counter, score_arr)
        cond = fluid.layers.less_than(counter, array_len)
        loop = fluid.layers.While(cond, max_trip_count=MAX_LEN)
        with loop.block():
            pre_ids = fluid.layers.reshape(fluid.layers.array_read(ids_arr, counter),
                                           shape=[BKL, 1])
            pre_state = fluid.layers.reshape(fluid.layers.array_read(state_arr, counter),
                                             shape=[BKL, BH])
            pre_score = fluid.layers.reshape(fluid.layers.array_read(score_arr, counter),
                                             shape=[BKL, 1])
            emb = fluid.layers.reshape(
                fluid.layers.embedding(pre_ids, size=[BV, BD],
                                       param_attr=fluid.ParamAttr(name="mt_vemb_t")),
                shape=[BKL, BD])
            cur_state, logits = _mt_decoder_step(fluid, emb, pre_state)
            topk_scores, topk_indices = fluid.layers.topk(fluid.layers.softmax(logits), k=BK)
            accu = fluid.layers.elementwise_add(fluid.layers.log(topk_scores), pre_score)
            sel_ids, sel_sc, parent = fluid.layers.beam_search(
                pre_ids, pre_score, topk_indices, accu, BK, END, return_parent_idx=True)
            new_state = fluid.layers.gather(cur_state, parent)
            fluid.layers.increment(counter, value=1, in_place=True)
            fluid.layers.array_write(new_state, counter, state_arr)
            fluid.layers.array_write(sel_ids, counter, ids_arr)
            fluid.layers.array_write(sel_sc, counter, score_arr)
            fluid.layers.array_write(parent, counter, parent_arr)
            fluid.layers.less_than(counter, array_len, cond=cond)
        trans_ids, trans_scores = fluid.layers.beam_search_decode(
            ids_arr, score_arr, beam_size=BK, end_id=END, parents=parent_arr)
    return main, startup, trans_ids, trans_scores


def machine_translation_decode_feed(seed, B):
    rng = np.random.RandomState(seed)
    BKL = B * BK
    return {"src": rng.randint(3, BV, (B, T_SRC)).astype("int64"),
            "src_seq_len": rng.randint(2, T_SRC + 1, (B,)).astype("int32"),
            "init_ids": np.full((BKL, 1), START, "int64"),
            "init_scores": np.where(np.arange(BKL) % BK == 0, 0.0, -1e9).astype(
                "float32").reshape(BKL, 1)}


RED_H, RED_DEC = 12, 16


def rnn_encoder_decoder_train(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 83
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [T_SRC], dtype="int64", lod_level=1)
        src_len = main.global_block().var("src_seq_len")
        trg = fluid.layers.data("trg", [T_TGT], dtype="int64")
        nxt = fluid.layers.data("nxt", [T_TGT, 1], dtype="int64")
        src_emb = fluid.layers.embedding(src, size=[BV, BD],
                                         param_attr=fluid.ParamAttr(name="red_src_emb"))
        fwd, _ = fluid.layers.dynamic_lstm(
            fluid.layers.fc(src_emb, RED_H * 4, num_flatten_dims=2, bias_attr=True),
            size=RED_H * 4, seq_len=src_len)
        bwd, _ = fluid.layers.dynamic_lstm(
            fluid.layers.fc(src_emb, RED_H * 4, num_flatten_dims=2, bias_attr=True),
            size=RED_H * 4, is_reverse=True, seq_len=src_len)
        encoded = fluid.layers.concat([fluid.layers.sequence_last_step(fwd, seq_len=src_len),
                                       fluid.layers.sequence_first_step(bwd, seq_len=src_len)],
                                      axis=1)
        decoder_boot = fluid.layers.fc(encoded, RED_DEC, act="tanh", bias_attr=False)
        context = fluid.layers.fc(encoded, RED_DEC, bias_attr=False)
        trg_emb = fluid.layers.embedding(trg, size=[BV, BD],
                                         param_attr=fluid.ParamAttr(name="red_trg_emb"))
        cell_init = fluid.layers.fill_constant_batch_size_like(
            decoder_boot, shape=[-1, RED_DEC], dtype="float32", value=0.0)
        cell_init.stop_gradient = False
        trg_len = fluid.layers.fill_constant_batch_size_like(decoder_boot, shape=[-1],
                                                             dtype="int32", value=T_TGT)
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(trg_emb, seq_len=trg_len)
            ctx = rnn.static_input(context)
            hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
            cell_mem = rnn.memory(init=cell_init)
            x_t = fluid.layers.concat([ctx, word], axis=1)

            def linear(inputs):
                return fluid.layers.fc(inputs, RED_DEC, bias_attr=True)

            forget = fluid.layers.sigmoid(linear([hidden_mem, x_t]))
            inp = fluid.layers.sigmoid(linear([hidden_mem, x_t]))
            out_gate = fluid.layers.sigmoid(linear([hidden_mem, x_t]))
            tilde = fluid.layers.tanh(linear([hidden_mem, x_t]))
            c = fluid.layers.sums([fluid.layers.elementwise_mul(forget, cell_mem),
                                   fluid.layers.elementwise_mul(inp, tilde)])
            h = fluid.layers.elementwise_mul(out_gate, fluid.layers.tanh(c))
            rnn.update_memory(hidden_mem, h)
            rnn.update_memory(cell_mem, c)
            rnn.output(fluid.layers.fc(h, BV, bias_attr=True, act="softmax"))
        cost = fluid.layers.cross_entropy(fluid.layers.reshape(rnn(), shape=[-1, BV]),
                                          fluid.layers.reshape(nxt, shape=[-1, 1]))
        avg_cost = fluid.layers.mean(cost)
        fluid.optimizer.AdagradOptimizer(0.05).minimize(avg_cost)
    return main, startup, avg_cost


def book_train_feed(seed, B=16):
    rng = np.random.RandomState(seed)
    trg = np.empty((B, T_TGT), "int64")
    trg[:, 0] = START
    for t in range(1, T_TGT):
        trg[:, t] = (trg[:, t - 1] * 7 + 3) % BV
    return {"src": rng.randint(3, BV, (B, T_SRC)).astype("int64"),
            "src_seq_len": rng.randint(2, T_SRC + 1, (B,)).astype("int32"),
            "trg": trg, "nxt": ((trg * 7 + 3) % BV)[:, :, None].astype("int64")}


BOOK = {"machine_translation": machine_translation_train,
        "rnn_encoder_decoder": rnn_encoder_decoder_train}


@pytest.mark.parametrize("book", sorted(BOOK))
def test_book_program_trains_as_the_jax_package(book):
    jm, js, jl = BOOK[book](jfluid)
    tm, ts, tl = BOOK[book](tfluid)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    state = jax_startup_state(js, jm)
    feeds = [book_train_feed(i) for i in range(3)]
    jout, jscope = run_jax(jm, state, feeds, [jl.name], steps=3)
    tout, tscope = run_port(tm, state, feeds, [tl.name], steps=3)
    np.testing.assert_allclose([float(o[0]) for o in tout], [float(o[0]) for o in jout], **STEP_TOL)
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.get(p.name).numpy(), np.asarray(jscope.get(p.name)),
                                   err_msg=p.name, **STEP_TOL)


def test_book_beam_decode_desc_and_run_parity():
    B = 3
    jm, js, jids, jsc = machine_translation_decode(jfluid, B)
    tm, ts, tids, tsc = machine_translation_decode(tfluid, B)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    assert [op.type for op in tm.global_block().ops].count("bounded_while") == 1
    state = jax_startup_state(js, jm)
    feed = machine_translation_decode_feed(1, B)
    (jo,), _ = run_jax(jm, state, feed, [jids.name, jsc.name])
    (to,), _ = run_port(tm, state, feed, [tids.name, tsc.name])
    assert to[0].shape == (B, BK, MAX_LEN + 1)
    np.testing.assert_array_equal(to[0], jo[0])
    np.testing.assert_allclose(to[1], jo[1], rtol=1e-5, atol=1e-5)
    assert (to[1] < -1e-3).all() and (to[0][:, :, 1:] != 0).any()


def test_jax_exported_beam_decode_serves_in_the_port(tmp_path):
    """The JAX package's save_inference_model of the beam decode (a
    program with a While sub-block) loads in the port's AnalysisPredictor
    and answers with the JAX predictor's SentenceIds."""
    B = 2
    jm, js, jids, jsc = machine_translation_decode(jfluid, B)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / "mt_decode")
    feed_names = ["src", "src_seq_len", "init_ids", "init_scores"]
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.io.save_inference_model(d, feed_names, [jids, jsc], exe, main_program=jm)
    feed = machine_translation_decode_feed(5, B)
    jcfg = jfluid.inference.AnalysisConfig(d)
    jcfg.disable_gpu()
    want = jfluid.inference.create_paddle_predictor(jcfg).run(feed)
    cfg = tfluid.inference.AnalysisConfig(d)
    cfg.disable_gpu()
    pred = tfluid.inference.create_paddle_predictor(cfg)
    got = pred.run(feed)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
