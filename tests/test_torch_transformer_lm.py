"""The causal transformer LM slice of paddle_tpu_torch against paddle_tpu:
``transformer_lm`` in its fused, unfused and dropout builds, its export
served by the port, and the unfused BERT build.

Small size: vocab 64, d_model 32, 2 layers, 4 heads, d_inner 64, seq 16,
max_pos 32, batch 4; inputs from a numpy seed.  The JAX fused op takes
its einsum branch on the CPU; the port takes its plain versions.

* Desc parity: the same Program JSON (ops, attrs, vars) for the fused,
  unfused and dropout builds, the logits-only build, and under bf16 AMP.
* Run parity at dropout 0, from the JAX package's startup state carried
  over as its ``save_persistables`` ``.npy`` files: logits and loss within
  1e-5 (rtol 1e-5, atol 1e-5 on the logits), in both builds, and fused
  against unfused in the port; then 3 Adam steps: losses within rtol 1e-4
  and every parameter within atol 1e-4.  As in tests/test_torch_train.py,
  the key-projection biases (``*_att_k_b``) have a zero true gradient, so
  both frameworks compute rounding noise there that Adam scales up to an
  update of size lr; they are held to 2 lr a step instead.
* The JAX package's ``save_inference_model`` of the fused LM serves in
  the port's ``AnalysisPredictor`` and ``InferenceServer`` with the JAX
  predictor's logits (atol 1e-5).
"""
import json

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as ttransformer

LM = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64, seq_len=16, max_pos=32)
BATCH = 4
LR = 1e-3
PKG = {"jax": (jfluid, jtransformer), "torch": (tfluid, ttransformer)}
BUILDS = {  # name: (fused, dropout_rate, train, amp)
    "fused": (True, 0.0, True, False),
    "unfused": (False, 0.0, True, False),
    "dropout": (False, 0.1, True, False),
    "fused_infer": (True, 0.0, False, False),
    "dropout_infer": (False, 0.1, False, False),
    "fused_amp": (True, 0.0, True, True),
    "dropout_amp": (False, 0.1, True, True),
}


def build(pkg, name, seed=0):
    """(main, startup, loss or None, logits)."""
    fluid, transformer = PKG[pkg]
    fused, rate, train, amp = BUILDS[name]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    s = LM["seq_len"]
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [s], dtype="int64")
        labels = fluid.layers.data("labels", [s, 1], dtype="int64") if train else None
        loss, logits = transformer.transformer_lm(ids, labels, dropout_rate=rate, is_test=not train,
                                                  fused_attention=fused, **LM)
        if train:
            opt = fluid.optimizer.AdamOptimizer(LR)
            if amp:
                opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(loss)
    return main, startup, loss, logits


def lm_feed(rng, rows=BATCH):
    ids = rng.randint(0, LM["vocab_size"], (rows, LM["seq_len"] + 1)).astype("int64")
    return {"src_ids": ids[:, :-1], "labels": ids[:, 1:, None]}


def _canon(d):
    return "int64" if d in ("int32", "int64") else d


def _assert_same_desc(jp, tp):
    """Ops, attrs and vars of two programs; int32 ids in the JAX package
    (64-bit types off) match the port's int64."""
    jops, tops = jp.global_block().ops, tp.global_block().ops
    assert [o.type for o in tops] == [o.type for o in jops]
    for jo, to in zip(jops, tops):
        assert (to.inputs, to.outputs, to.attrs) == (jo.inputs, jo.outputs, jo.attrs), jo.type
    jvars, tvars = jp.global_block().vars, tp.global_block().vars
    assert list(tvars) == list(jvars)
    for n, jv in jvars.items():
        tv = tvars[n]
        assert (tv.shape, _canon(tv.dtype), tv.persistable, tv.stop_gradient) == \
            (jv.shape, _canon(jv.dtype), jv.persistable, jv.stop_gradient), n


@pytest.mark.parametrize("program", ["main", "startup"])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_desc_parity(name, program):
    jm, js, _, jlogits = build("jax", name)
    tm, ts, _, tlogits = build("torch", name)
    _assert_same_desc(*((jm, tm) if program == "main" else (js, ts)))
    assert tlogits.name == jlogits.name


def test_builds_op_types():
    """The fused build has one fused_attention op a layer and no dropout;
    the unfused build takes matmul + softmax and the causal bias
    (range, less_equal, cast, scale); the dropout build has 4 dropout ops
    a layer (attention weights, attention out, FFN hidden, FFN out)."""
    types = {n: [o.type for o in build("torch", n)[0].global_block().ops]
             for n in ("fused", "unfused", "dropout", "fused_infer")}
    n = LM["n_layer"]
    assert types["fused"].count("fused_attention") == n and "dropout" not in types["fused"]
    assert types["fused"].count("fused_attention_grad") == n
    assert "fused_attention" not in types["unfused"] and types["unfused"].count("softmax") == n
    assert {"range", "less_equal", "cast"} <= set(types["unfused"])
    assert types["dropout"].count("dropout") == 4 * n and types["dropout"].count("dropout_grad") == 4 * n
    assert len(types["fused"]) == 161 and "mean" not in types["fused_infer"]
    main = build("torch", "dropout")[0]
    seeds = [op.attr("seed") for op in main.global_block().ops if op.type == "dropout"]
    assert len(set(seeds)) == len(seeds)  # each op its own seed, from Program.next_seed


def test_fused_build_refuses_dropout_and_unfused_refuses_causal():
    for pkg in PKG:
        fluid, transformer = PKG[pkg]
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data("x", [16, 32])
            with pytest.raises(ValueError, match="dropout"):
                transformer.multi_head_attention(x, x, 32, 4, dropout_rate=0.1, fused=True)
            with pytest.raises(ValueError, match="fused-path inputs"):
                transformer.multi_head_attention(x, x, 32, 4, dropout_rate=0.0, causal=True)


# ---------------------------------------------------------------------------
# run parity from the JAX package's saved state
# ---------------------------------------------------------------------------
def _jax_state(name, tmp_path):
    """The JAX package's startup of build ``name``, run and saved with its
    save_persistables: (main, loss, logits, executor, scope, directory)."""
    jm, js, jl, jlog = build("jax", name)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / ("jax_" + name))
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.io.save_persistables(exe, d, jm)
    return jm, jl, jlog, exe, scope, d


def _port_from(name, d):
    tm, _, tl, tlog = build("torch", name)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(exe, d, tm, scope=scope)
    return tm, tl, tlog, exe, scope


@pytest.mark.parametrize("name", ["fused", "unfused"])
def test_logits_and_loss_match_jax(name, tmp_path):
    jm, jl, jlog, jexe, jscope, d = _jax_state(name, tmp_path)
    tm, tl, tlog, texe, tscope = _port_from(name, d)
    feed = lm_feed(np.random.RandomState(1))
    test_j, test_t = jm.clone(for_test=True), tm.clone(for_test=True)
    with jfluid.scope_guard(jscope):
        jloss, jlogits = jexe.run(test_j, feed=feed, fetch_list=[jl, jlog])
    tloss, tlogits = texe.run(test_t, feed=feed, fetch_list=[tl, tlog], scope=tscope)
    assert tlogits.shape == (BATCH, LM["seq_len"], LM["vocab_size"])
    np.testing.assert_allclose(tlogits, np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss), float(np.asarray(jloss)), rtol=1e-5)


def test_fused_and_unfused_agree_in_the_port(tmp_path):
    """The same weights through the fused op (causal=) and the unfused
    matmul + _causal_bias + softmax path."""
    *_, d = _jax_state("fused", tmp_path)
    feed = lm_feed(np.random.RandomState(2))
    out = {}
    for name in ("fused", "unfused"):
        tm, tl, tlog, texe, tscope = _port_from(name, d)
        out[name] = texe.run(tm.clone(for_test=True), feed=feed, fetch_list=[tl, tlog], scope=tscope)
    np.testing.assert_allclose(out["unfused"][1], out["fused"][1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(out["unfused"][0]), float(out["fused"][0]), rtol=1e-5)


@pytest.mark.parametrize("name", ["fused", "unfused"])
def test_three_adam_steps_match_jax(name, tmp_path):
    jm, jl, _, jexe, jscope, d = _jax_state(name, tmp_path)
    tm, tl, _, texe, tscope = _port_from(name, d)
    rng = np.random.RandomState(3)
    for step in range(3):
        feed = lm_feed(rng)
        with jfluid.scope_guard(jscope):
            jloss, = jexe.run(jm, feed=feed, fetch_list=[jl])
        tloss, = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        np.testing.assert_allclose(float(tloss), float(np.asarray(jloss)), rtol=1e-4, err_msg=step)
    params = [p.name for p in tm.all_parameters()]
    for n in params:
        j = np.asarray(jscope.get(n))
        t = tfluid.scope.to_numpy(tscope.get(n)).reshape(j.shape)
        limit = 2 * LR * 3 if n.endswith("_att_k_b") else 1e-4
        assert np.abs(t - j).max() <= limit, (n, np.abs(t - j).max())


def test_dropout_lm_trains_and_repeats(tmp_path):
    """The dropout build trains in the port, and its masks are functions
    of the ops' seeds: two runs from one state give the same losses."""
    *_, d = _jax_state("dropout", tmp_path)
    feed = lm_feed(np.random.RandomState(4))
    runs = []
    for _ in range(2):
        tm, tl, _, texe, tscope = _port_from("dropout", d)
        runs.append([float(texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)[0])
                     for _ in range(3)])
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all() and runs[0][2] < runs[0][0]


# ---------------------------------------------------------------------------
# a JAX-saved LM export, served by the port
# ---------------------------------------------------------------------------
def test_port_serves_jax_exported_lm(tmp_path):
    jm, js, _, jlog = build("jax", "fused_infer")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    rng = np.random.RandomState(5)
    feeds = [{"src_ids": lm_feed(rng, r)["src_ids"]} for r in (1, 3, 2, 4)]
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.io.save_inference_model(str(tmp_path), ["src_ids"], [jlog], exe, main_program=jm)
    jcfg = jfluid.inference.AnalysisConfig(str(tmp_path))
    jpred = jfluid.inference.create_paddle_predictor(jcfg)
    refs = [np.asarray(jpred.run(f)[0]) for f in feeds]
    cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    pred = tfluid.inference.create_paddle_predictor(cfg)
    with open(tmp_path / "__model__") as f:
        types = [op["type"] for op in json.load(f)["program"]["blocks"][0]["ops"]]
    assert types.count("fused_attention") == LM["n_layer"]
    for f, ref in zip(feeds, refs):
        out, = pred.run(f)
        assert out.shape == (f["src_ids"].shape[0], LM["seq_len"], LM["vocab_size"])
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    server = serving.InferenceServer(pred, max_batch_size=4, batch_timeout_ms=20)
    try:
        server.warmup()
        client = serving.Client(server)
        for f, ref in zip(feeds, refs):
            out, = client.infer(f)
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    finally:
        server.stop(drain=True, timeout=60)


# ---------------------------------------------------------------------------
# the unfused BERT build: the padding bias through scale
# ---------------------------------------------------------------------------
BERT = dict(vocab_size=64, d_model=32, n_layer=2, n_head=4, d_inner=64, max_pos=32, seq_len=16)


def _bert(pkg, dropout=0.0):
    fluid, transformer = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [16], dtype="int64")
        mask = fluid.layers.data("input_mask", [16])
        out = transformer.bert_encoder(ids, mask, dropout_rate=dropout, is_test=False,
                                       fused_attention=False, **BERT)
    return main, startup, out


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_unfused_bert_matches_jax(dropout, tmp_path):
    jm, js, jout = _bert("jax", dropout)
    tm, ts, tout = _bert("torch", dropout)
    _assert_same_desc(jm, tm)
    _assert_same_desc(js, ts)
    types = [o.type for o in tm.global_block().ops]
    assert "scale" in types and types.count("softmax") == BERT["n_layer"]
    if dropout:
        assert types.count("dropout") == 1 + 4 * BERT["n_layer"]  # the embeddings', then 4 a layer
        return
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        jfluid.io.save_persistables(jexe, str(tmp_path), jm)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(texe, str(tmp_path), tm, scope=tscope)
    rng = np.random.RandomState(6)
    lens = np.array([16, 9, 12, 5])
    feed = {"src_ids": rng.randint(0, 64, (4, 16)).astype("int64"),
            "input_mask": (np.arange(16)[None, :] < lens[:, None]).astype("float32")}
    with jfluid.scope_guard(jscope):
        ref, = jexe.run(jm, feed=feed, fetch_list=[jout])
    got, = texe.run(tm, feed=feed, fetch_list=[tout], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
