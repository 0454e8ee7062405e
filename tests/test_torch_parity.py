"""Desc and run parity of paddle_tpu_torch against paddle_tpu on a small
fused BERT encoder (2 layers, d_model 64, 4 heads, d_inner 128, seq 16,
vocab 100), with inputs made from a seed with numpy.

Run parity compares at atol 1e-4, rtol 1e-4 on every row, pad rows
included: the two frameworks sum in different orders through two
layers of matmuls, layer norms and attention.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import transformer as ttransformer

SMALL_BERT = dict(vocab_size=100, d_model=64, n_layer=2, n_head=4, d_inner=128,
                  max_pos=32, seq_len=16, dropout_rate=0.0, is_test=True,
                  fused_attention=True)
FEEDS = ["src_ids", "input_mask"]
RUN_TOL = dict(atol=1e-4, rtol=1e-4)
SLICE_OPS = {"elementwise_add", "mul", "reshape2", "transpose2", "layer_norm",
             "lookup_table", "fused_attention", "gelu", "range"}


def build_bert(fluid, transformer, cfg=SMALL_BERT, seed=0):
    """(main, startup, output var) of the fused, inference-mode encoder."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [cfg["seq_len"]], dtype="int64")
        mask = fluid.layers.data("input_mask", [cfg["seq_len"]], dtype="float32")
        out = transformer.bert_encoder(ids, mask, **cfg)
    return main, startup, out


def bert_feed(rng, rows, cfg=SMALL_BERT):
    """Random ids and a padding mask with random tails; row 0 all real."""
    s = cfg["seq_len"]
    ids = rng.randint(0, cfg["vocab_size"], (rows, s)).astype("int64")
    lens = rng.randint(1, s + 1, rows)
    lens[0] = s
    mask = (np.arange(s)[None, :] < lens[:, None]).astype("float32")
    return {"src_ids": ids, "input_mask": mask}


def save_jax_model(dirname, seed=0):
    """The JAX package builds the small encoder, runs its startup and saves
    it; returns (main, output var, scope)."""
    main, startup, out = build_bert(jfluid, jtransformer, seed=seed)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(str(dirname), FEEDS, [out], exe, main_program=main)
    return main, out, scope


def cpu_predictor(pkg, dirname):
    cfg = pkg.inference.AnalysisConfig(str(dirname))
    cfg.disable_gpu()
    return pkg.inference.create_paddle_predictor(cfg)


def _canon_dtype(d):
    return "int64" if d in ("int32", "int64") else d


# ---------------------------------------------------------------------------
# desc parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("program", ["main", "startup"])
def test_desc_parity(program):
    jm, js, _ = build_bert(jfluid, jtransformer)
    tm, ts, _ = build_bert(tfluid, ttransformer)
    jp, tp = (jm, tm) if program == "main" else (js, ts)
    jops, tops = jp.global_block().ops, tp.global_block().ops
    assert [o.type for o in tops] == [o.type for o in jops]
    for jo, to in zip(jops, tops):
        assert to.inputs == jo.inputs, jo.type
        assert to.outputs == jo.outputs, jo.type
        assert to.attrs == jo.attrs, jo.type
    jvars, tvars = jp.global_block().vars, tp.global_block().vars
    assert list(tvars) == list(jvars)
    for name, jv in jvars.items():
        tv = tvars[name]
        assert tv.shape == jv.shape, name
        assert _canon_dtype(tv.dtype) == _canon_dtype(jv.dtype), name
        assert tv.persistable == jv.persistable and tv.is_data == jv.is_data, name
        assert type(tv).__name__ == type(jv).__name__, name


def test_desc_op_types_are_the_slice():
    tm, ts, _ = build_bert(tfluid, ttransformer)
    assert {o.type for o in tm.global_block().ops} == SLICE_OPS
    assert {o.type for o in ts.global_block().ops} == {"fill_constant", "uniform_random"}


def test_program_json_roundtrip_between_packages():
    """Program JSON from either package parses in the other and keeps
    every op and var."""
    jm, _, _ = build_bert(jfluid, jtransformer)
    tm, _, _ = build_bert(tfluid, ttransformer)
    from_j = tfluid.Program.from_json(jm.to_json())
    from_t = jfluid.Program.from_json(tm.to_json())
    assert [o.type for o in from_j.global_block().ops] == [o.type for o in jm.global_block().ops]
    assert json.loads(from_j.to_json())["blocks"][0]["ops"] == json.loads(jm.to_json())["blocks"][0]["ops"]
    assert list(from_t.global_block().vars) == list(tm.global_block().vars)


def test_infer_shape_static_mismatch_raises():
    """A real shape incompatibility among static shapes raises at
    append_op, as the JAX package's eval_shape-based check does."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [3, 4], append_batch_size=False)
        y = tfluid.layers.data("y", [5, 6], append_batch_size=False)
        with pytest.raises(ValueError, match="shape inference failed"):
            main.global_block().append_op(
                "mul", inputs={"X": [x], "Y": [y]},
                outputs={"Out": [main.global_block().create_var(name="o")]})


def test_infer_shape_dynamic_batch_stays_dynamic():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [5, 8])
        h = tfluid.layers.fc(x, 3, num_flatten_dims=2, act="gelu")
    assert h.shape == (-1, 5, 3)
    assert treg._DUMMY_BATCH not in h.shape


# ---------------------------------------------------------------------------
# run parity
# ---------------------------------------------------------------------------
def test_run_parity_saved_model(tmp_path):
    """A directory written by paddle_tpu.io.save_inference_model runs in
    both packages' predictors; every row agrees."""
    save_jax_model(tmp_path)
    feed = bert_feed(np.random.RandomState(11), 4)
    jout, = cpu_predictor(jfluid, tmp_path).run(feed)
    tout, = cpu_predictor(tfluid, tmp_path).run(feed)
    assert tout.shape == jout.shape == (4, 16, 64)
    np.testing.assert_allclose(tout, jout, **RUN_TOL)


def test_run_parity_run_padded(tmp_path):
    save_jax_model(tmp_path, seed=3)
    rng = np.random.RandomState(12)
    feed = bert_feed(rng, 3)
    padded = {k: np.concatenate([v, np.repeat(v[-1:], 5, 0)]) for k, v in feed.items()}
    jout, = cpu_predictor(jfluid, tmp_path).run_padded(padded, n_valid=3)
    tout, = cpu_predictor(tfluid, tmp_path).run_padded(padded, n_valid=3)
    assert tout.shape == (3, 16, 64)
    np.testing.assert_allclose(tout, jout, **RUN_TOL)


def test_weights_carried_across():
    """set_params_from_numpy, given the JAX scope's arrays, makes a port
    Executor run of the same main program match the JAX run."""
    jm, js, jout_var = build_bert(jfluid, jtransformer, seed=5)
    tm, _, tout_var = build_bert(tfluid, ttransformer, seed=5)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    feed = bert_feed(np.random.RandomState(13), 5)
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        jout, = jexe.run(jm, feed=feed, fetch_list=[jout_var])
    arrays = {p.name: np.asarray(jscope.get(p.name)) for p in jm.all_parameters()}
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    tfluid.io.set_params_from_numpy(tscope, arrays, texe.device, program=tm)
    tout, = texe.run(tm, feed=feed, fetch_list=[tout_var], scope=tscope)
    np.testing.assert_allclose(tout, np.asarray(jout), **RUN_TOL)


def test_set_params_from_numpy_checks_shapes():
    tm, _, _ = build_bert(tfluid, ttransformer)
    scope = tfluid.Scope()
    with pytest.raises(ValueError, match="shape mismatch"):
        tfluid.io.set_params_from_numpy(
            scope, {"bert_word_emb": np.zeros((3, 3), "float32")}, "cpu", program=tm)


def test_port_save_roundtrip_and_jax_load(tmp_path):
    """The port's own startup + save writes the shared format: it loads
    back in the port bit-exactly and runs in the JAX predictor too."""
    tm, ts, tout_var = build_bert(tfluid, ttransformer, seed=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    feed = bert_feed(np.random.RandomState(14), 2)
    ref, = exe.run(tm, feed=feed, fetch_list=[tout_var], scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), FEEDS, [tout_var], exe, main_program=tm,
                                   scope=scope)
    tout, = cpu_predictor(tfluid, tmp_path).run(feed)
    np.testing.assert_array_equal(tout, ref)
    jout, = cpu_predictor(jfluid, tmp_path).run(feed)
    np.testing.assert_allclose(jout, tout, **RUN_TOL)


def test_startup_initialises_every_param_in_range():
    tm, ts, _ = build_bert(tfluid, ttransformer, seed=4)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    for p in tm.all_parameters():
        v = scope.get(p.name)
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        assert tuple(v.shape) == p.shape and torch.isfinite(v).all()
        if p.name.endswith(("_scale",)):
            assert torch.all(v == 1.0)
        elif p.name.endswith(("_b", "_bias")):
            assert torch.all(v == 0.0)
        else:  # Xavier-uniform
            limit = float(np.sqrt(6.0 / sum(p.shape)))
            assert v.abs().max() <= limit and v.std() > 0.2 * limit


def test_executor_requires_startup():
    tm, _, tout_var = build_bert(tfluid, ttransformer)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with pytest.raises(RuntimeError, match="not initialized"):
        exe.run(tm, feed=bert_feed(np.random.RandomState(0), 1), fetch_list=[tout_var],
                scope=tfluid.Scope())


def test_model_dir_with_int32_desc_loads(tmp_path):
    """The JAX package (x64 off) records int32 for var dtypes the port
    calls int64; the port loads and runs such a directory."""
    save_jax_model(tmp_path)
    model = json.loads((tmp_path / "__model__").read_text())
    dtypes = {v["dtype"] for v in model["program"]["blocks"][0]["vars"]}
    assert "int32" in dtypes
    pred = cpu_predictor(tfluid, tmp_path)
    out, = pred.run(bert_feed(np.random.RandomState(1), 2))
    assert out.shape == (2, 16, 64) and np.isfinite(out).all()
