"""The port's mixed-precision serving path on the CPU, held against the
JAX package: ``contrib.mixed_precision.inference`` (the bf16 variant's
passes), ``io.save_inference_model(precision_policy=)`` with its parity
gate, ``AnalysisPredictor``'s precision surface and the server's
per-request dtype.

* desc parity: ``build_bf16_variant`` gives the same Program JSON in both
  packages (LeNet, DeepFM, the causal LM, a small fused BERT encoder);
* run parity: a bf16 endpoint exported by the JAX package is served by
  the port's predictor, and one exported by the port by the JAX
  package's, each dtype within a stated tolerance of the other package's
  answer;
* the parity gate refuses an impossible rtol in both packages; int8
  raises naming ROADMAP A11 in the port, and a sharding manifest (with
  the bf16 composition) loads, one rank serving the whole mesh.

Tolerances: fp32 answers 1e-5 relative to the output's scale (the same
fp32 programs, sums in other orders).  bf16 answers 3e-2 of the output's
scale between the packages: each side is within its export's measured
``max_rel_err`` (about 1e-2 here) of fp32, and the two bf16 runs round
their products and activations in other places (XLA fuses, torch runs op
by op), so they may differ by the sum of the two errors; 3e-2 is that
sum with a margin, under the policy's own 5e-2.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu.contrib.mixed_precision import inference as jmp
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import serving
from paddle_tpu_torch.contrib.mixed_precision import inference as mp_inf
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from torch_parity_util import assert_same_program

FP32_TOL = 1e-5
BF16_CROSS_TOL = 3e-2
_LM_V, _LM_D, _LM_S = 128, 16, 8
_BERT = dict(vocab_size=100, d_model=32, n_layer=2, n_head=4, d_inner=64, max_pos=32,
             seq_len=16, dropout_rate=0.0, is_test=True, fused_attention=True)


# ---------------------------------------------------------------------------
# endpoint builders: one layer-call sequence for both packages
# ---------------------------------------------------------------------------
def _build_lenet(fl, models):
    img = fl.layers.data("img", [1, 28, 28])
    lbl = fl.layers.data("lbl", [1], dtype="int64")
    _, _, pred = models.lenet5(img, lbl)
    return ["img"], [pred]


def _lenet_feed(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"img": rng.uniform(-1, 1, (n, 1, 28, 28)).astype(np.float32)}


def _build_deepfm(fl, models, num_features=512, num_fields=8):
    ids = fl.layers.data("feat_ids", [num_fields, 1], dtype="int64")
    vals = fl.layers.data("feat_vals", [num_fields])
    lbl = fl.layers.data("lbl", [1], dtype="int64")
    _, prob = models.deepfm_ctr(ids, vals, lbl, num_features=num_features, num_fields=num_fields,
                                embed_dim=4, deep_layers=(16, 16))
    return ["feat_ids", "feat_vals"], [prob]


def _deepfm_feed(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"feat_ids": rng.randint(0, 512, (n, 8, 1)).astype(np.int64),
            "feat_vals": rng.uniform(0, 1, (n, 8)).astype(np.float32)}


def _build_lm(fl, models):
    ids = fl.layers.data("src_ids", [_LM_S], dtype="int64")
    _, logits = models.transformer_lm(ids, None, vocab_size=_LM_V, d_model=_LM_D, n_layer=1,
                                      n_head=2, d_inner=32, seq_len=_LM_S, max_pos=2 * _LM_S)
    return ["src_ids"], [logits]


def _lm_feed(n=4, seed=0):
    return {"src_ids": np.random.RandomState(seed).randint(1, _LM_V, (n, _LM_S)).astype(np.int64)}


def _build_bert(fl, models):
    transformer = models.transformer
    ids = fl.layers.data("src_ids", [_BERT["seq_len"]], dtype="int64")
    mask = fl.layers.data("input_mask", [_BERT["seq_len"]])
    return ["src_ids", "input_mask"], [transformer.bert_encoder(ids, mask, **_BERT)]


def _bert_feed(n=4, seed=0):
    rng = np.random.RandomState(seed)
    mask = np.ones((n, _BERT["seq_len"]), np.float32)
    mask[:, _BERT["seq_len"] - 1 - rng.randint(0, 4, n)] = 0.0  # some pad positions
    return {"src_ids": rng.randint(0, _BERT["vocab_size"], (n, _BERT["seq_len"])).astype(np.int64),
            "input_mask": mask}


FAMILIES = {"lenet": (_build_lenet, _lenet_feed), "deepfm": (_build_deepfm, _deepfm_feed),
            "transformer-lm": (_build_lm, _lm_feed), "bert": (_build_bert, _bert_feed)}


def _program(fl, models, build):
    prog, startup = fl.Program(), fl.Program()
    prog.random_seed = startup.random_seed = 29
    with fl.program_guard(prog, startup), fl.unique_name.guard():
        feed_names, targets = build(fl, models)
    return prog, startup, feed_names, targets


def _policy(feed_fn, **kw):
    # real feeds for the gate: synthetic ones put uniform [-1, 1) into an
    # attention mask, which neither package's bf16 endpoint passes
    return dict({"dtype": "bf16", "parity_feeds": [feed_fn(n=4, seed=100)]}, **kw)


def _export_jax(dirname, family, precision=None):
    build, _ = FAMILIES[family]
    prog, startup, feed_names, targets = _program(jfluid, jmodels, build)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.io.save_inference_model(str(dirname), feed_names, targets, exe, prog,
                                       precision_policy=precision)
    return str(dirname)


def _export_port(dirname, family, precision=None, state_from=None):
    """The port's export of ``family``; ``state_from``: a JAX-exported
    directory whose parameters the port's scope takes first."""
    build, _ = FAMILIES[family]
    prog, startup, feed_names, targets = _program(tfluid, tmodels, build)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    if state_from is not None:
        tfluid.io.load_persistables(exe, state_from, prog, scope=scope)
    tfluid.io.save_inference_model(str(dirname), feed_names, targets, exe, prog, scope=scope,
                                   precision_policy=precision)
    return str(dirname)


def _port_predictor(d):
    cfg = AnalysisConfig(d)
    cfg.disable_gpu()
    return create_paddle_predictor(cfg)


def _jax_predictor(d):
    return jfluid.inference.create_paddle_predictor(jfluid.inference.AnalysisConfig(d))


def _scale_err(ref, out):
    return mp_inf.max_rel_err([np.asarray(r, np.float64) for r in ref], out)


# ---------------------------------------------------------------------------
# desc parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bf16_variant_desc_matches_the_jax_package(family):
    build, _ = FAMILIES[family]
    programs = []
    for fl, models, io_ in ((jfluid, jmodels, jfluid.io), (tfluid, tmodels, tfluid.io)):
        prog, _, feed_names, targets = _program(fl, models, build)
        fetch = [t.name for t in targets]
        pruned = io_._prune_program(prog, feed_names, fetch)
        inf = jmp if fl is jfluid else mp_inf
        # the variant's cast names come from the package's global name
        # generator: a fresh one on each side, whatever ran before in the
        # process (an AMP test's decorate advances it)
        with fl.unique_name.guard():
            variant, info = inf.build_bf16_variant(pruned, fetch)
        programs.append((variant, info))
    (jv, jinfo), (tv, tinfo) = programs
    assert_same_program(jv, tv)
    assert tinfo == jinfo
    assert tinfo["cast_params"]  # the weights are hoisted, not cast per run


def test_lenet_gray_chain_stays_bf16_with_every_weight_hoisted():
    """One cast down (the image into the first conv) and one up (into the
    black-listed softmax); the 8 float parameters are bf16 in the variant."""
    prog, _, feed_names, targets = _program(tfluid, tmodels, _build_lenet)
    pruned = tfluid.io._prune_program(prog, feed_names, [t.name for t in targets])
    variant, info = mp_inf.build_bf16_variant(pruned, [t.name for t in targets])
    assert info["cast_ops"] == {"to_low": 1, "to_fp32": 1}
    assert len(info["cast_params"]) == 8
    block = variant.global_block()
    assert all(block.var(n).dtype == "bfloat16" for n in info["cast_params"])
    assert block.var(targets[0].name).dtype == "float32"  # the fetch stays fp32


# ---------------------------------------------------------------------------
# run parity across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("family", ["lenet", "bert", "transformer-lm"])
def test_jax_exported_bf16_endpoint_served_by_the_port(family, tmp_path):
    _, feed_fn = FAMILIES[family]
    d = _export_jax(tmp_path / "jax", family, precision=_policy(feed_fn))
    port, jax_pred = _port_predictor(d), _jax_predictor(d)
    policy = port.precision_policy
    assert policy == jax_pred.precision_policy and policy["dtype"] == "bf16"
    assert port.precision_dtypes() == ["bf16", "fp32"]
    feed = feed_fn(n=3, seed=5)
    bf16, fp32 = port.run(feed), port.run(feed, precision="fp32")
    assert all(o.dtype == np.float32 for o in bf16)  # bf16 never leaves the predictor
    assert _scale_err(jax_pred.run(feed, precision="fp32"), fp32) <= FP32_TOL
    assert _scale_err(jax_pred.run(feed), bf16) <= BF16_CROSS_TOL
    assert _scale_err(fp32, bf16) <= policy["rtol"]
    assert not all(np.array_equal(a, b) for a, b in zip(fp32, bf16))  # really bf16


@pytest.mark.parametrize("family", ["lenet", "bert"])
def test_port_exported_bf16_endpoint_served_by_the_jax_package(family, tmp_path):
    _, feed_fn = FAMILIES[family]
    # the same weights on both sides: the port exports the JAX package's
    # initial state
    src = _export_jax(tmp_path / "state", family)
    d = _export_port(tmp_path / "port", family, precision=_policy(feed_fn), state_from=src)
    model = json.load(open(os.path.join(d, "__model__")))
    assert model["precision"]["dtype"] == "bf16"
    assert model["precision"]["max_rel_err"] <= model["precision"]["rtol"]
    port, jax_pred = _port_predictor(d), _jax_predictor(d)
    assert jax_pred.precision_dtypes() == ["bf16", "fp32"]
    feed = feed_fn(n=3, seed=6)
    assert _scale_err(port.run(feed, precision="fp32"), jax_pred.run(feed, precision="fp32")) \
        <= FP32_TOL
    assert _scale_err(port.run(feed), jax_pred.run(feed)) <= BF16_CROSS_TOL


def test_parity_gate_refuses_an_impossible_rtol_in_both_packages(tmp_path):
    with pytest.raises(jmp.PrecisionParityError):
        _export_jax(tmp_path / "jax", "lenet", precision=_policy(_lenet_feed, rtol=1e-7))
    with pytest.raises(mp_inf.PrecisionParityError, match="max_rel_err"):
        _export_port(tmp_path / "port", "lenet", precision=_policy(_lenet_feed, rtol=1e-7))
    assert not os.path.exists(os.path.join(str(tmp_path / "port"), "__model__"))


# ---------------------------------------------------------------------------
# the policy's errors
# ---------------------------------------------------------------------------
def test_unknown_policy_dtype_and_keys_are_typed(tmp_path):
    with pytest.raises(mp_inf.PrecisionPolicyError):
        _export_port(tmp_path / "a", "lenet", precision={"dtype": "fp8"})
    with pytest.raises(mp_inf.PrecisionPolicyError):
        _export_port(tmp_path / "b", "lenet", precision={"dtype": "bf16", "typo_knob": 1})
    with pytest.raises(mp_inf.PrecisionPolicyError, match="int8-only"):
        _export_port(tmp_path / "c", "lenet",
                     precision={"dtype": "bf16", "calibration": [_lenet_feed(n=2)]})
    with pytest.raises(mp_inf.PrecisionPolicyError, match="base model"):
        _export_port(tmp_path / "d", "lenet", precision={"dtype": "fp32"})


def test_int8_raises_naming_a11_and_sharding_a10(tmp_path):
    cal = [_lenet_feed(n=2, seed=100 + i) for i in range(2)]
    with pytest.raises(mp_inf.PrecisionPolicyError, match="A11"):
        _export_port(tmp_path / "p", "lenet", precision={"dtype": "int8", "calibration": cal})
    # an int8 endpoint the JAX package exported: the port refuses its manifest
    d = _export_jax(tmp_path / "j", "lenet", precision={"dtype": "int8", "calibration": cal})
    with pytest.raises(mp_inf.PrecisionPolicyError, match="A11"):
        _port_predictor(d)
    from paddle_tpu_torch.sharding import PartitionSpec, ShardingRuleError

    prog, startup, feed_names, targets = _program(tfluid, tmodels, _build_lenet)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    # sharding rules ride the export's manifest and the predictor loads them
    # (a world of one rank: a mesh whose axes have size 1)
    tfluid.io.save_inference_model(str(tmp_path / "s"), feed_names, targets, exe, prog,
                                   scope=scope, sharding_rules=[(".*", None)],
                                   sharding_mesh={"tp": 1})
    assert json.load(open(tmp_path / "s" / "__model__"))["sharding"]["mesh_axes"] == {"tp": 1}
    feed = _lenet_feed(n=2)
    sharded = _port_predictor(str(tmp_path / "s"))
    plain = _export_port(tmp_path / "plain", "lenet")
    np.testing.assert_allclose(sharded.run(feed)[0], _port_predictor(plain).run(feed)[0],
                               rtol=FP32_TOL, atol=FP32_TOL)
    assert sharded.sharded and sharded.sharding_stats()["n_sharded"] == 0
    # a manifest with no rules is a typed load error
    model = json.load(open(os.path.join(plain, "__model__")))
    model["sharding"] = {"mesh_axes": {"tp": 2}, "rules": []}
    json.dump(model, open(os.path.join(plain, "__model__"), "w"))
    with pytest.raises(ShardingRuleError, match="missing 'rules'"):
        _port_predictor(plain)
    # the bf16 composition: the variant's hoisted params cast as they are placed
    pred = _port_predictor(_export_port(tmp_path / "bf", "lenet", precision=_policy(_lenet_feed)))
    assert pred.sharded is False
    bf16_out = pred.run(feed)[0]
    pred.with_sharding_rules([(".*", PartitionSpec())], mesh_axes={"tp": 1})
    assert pred.sharded
    np.testing.assert_array_equal(pred.run(feed)[0], bf16_out)
    shared = mp_inf.variant_scope(pred._program, pred._scope, set(), host_cast=True)
    assert all(shared.vars[n] is pred._scope.vars[n] for n in shared.vars)


def test_variant_stores_hoisted_weights_in_bf16(tmp_path):
    pred = _port_predictor(_export_port(tmp_path / "bf", "bert", precision=_policy(_bert_feed)))
    low, full = pred.param_placements(), pred.param_placements(precision="fp32")
    hoisted = [n for n, p in low.items() if p["dtype"] == "bfloat16"]
    assert hoisted and all(full[n]["dtype"] == "float32" for n in hoisted)
    assert all(low[n]["bytes_per_device"] * 2 == full[n]["bytes_per_device"] for n in hoisted)
    assert pred.sharding_stats()["hbm_bytes_per_device"] < \
        pred.sharding_stats(precision="fp32")["hbm_bytes_per_device"]
    with pytest.raises(ValueError, match="unknown precision"):
        pred.run(_bert_feed(n=1), precision="fp8")


# ---------------------------------------------------------------------------
# serving: per-request dtype, zero entries built after warmup
# ---------------------------------------------------------------------------
def test_serving_mixed_precision_builds_nothing_after_warmup(tmp_path):
    d = _export_port(tmp_path / "ep", "lenet", precision=_policy(_lenet_feed))
    pred = _port_predictor(d)
    srv = serving.InferenceServer(pred, max_batch_size=8, batch_timeout_ms=2, queue_capacity=64,
                                  name="prec-srv")
    try:
        # every (rung, dtype) pair: one entry each
        assert srv.warmup() == 2 * len(srv.bucket_ladder)
        assert srv.metrics()["warmup_compiles"] == 2 * len(srv.bucket_ladder)
        misses0 = pred.jit_cache_stats()["misses"]
        cli = serving.Client(srv)
        rng = np.random.RandomState(0)
        served = []
        for i in range(20):
            feed = {"img": rng.uniform(-1, 1, (1 + i % 3, 1, 28, 28)).astype(np.float32)}
            prec = "fp32" if i % 5 == 0 else None
            served.append((feed, prec, cli.infer(feed, precision=prec)[0]))
        m = srv.metrics()
        assert m["recompiles"] == 0 and pred.jit_cache_stats()["misses"] == misses0
        for feed, prec, out in served:  # each answer is its request's, run alone
            np.testing.assert_allclose(out, pred.run(feed, precision=prec)[0], rtol=0, atol=1e-6)
        n_fp32 = sum(prec == "fp32" for _, prec, _ in served)
        assert m["completed"] == 20
        assert m["precision_requests"] == {"fp32": n_fp32, "bf16": 20 - n_fp32}
        assert sum(m["precision_batches"].values()) == m["batches"]
        assert m["precision_dtypes"] == ["bf16", "fp32"]
        with pytest.raises(ValueError, match="unknown precision"):
            srv.submit(_lenet_feed(n=1), precision="fp8")
        # aliases of the dtype names are accepted
        assert cli.infer(_lenet_feed(n=1), precision="float32")[0].shape == (1, 10)
        assert cli.infer(_lenet_feed(n=1), precision="bfloat16")[0].shape == (1, 10)
    finally:
        srv.stop(drain=True)


def test_a_plain_endpoint_serves_fp32_only(tmp_path):
    pred = _port_predictor(_export_port(tmp_path / "ep", "lenet"))
    assert pred.precision_policy is None and pred.precision_dtypes() == ["fp32"]
    with pytest.raises(ValueError, match="no 'bf16' variant"):
        pred.run(_lenet_feed(n=1), precision="bf16")
    srv = serving.InferenceServer(pred, max_batch_size=2, name="plain-srv")
    try:
        with pytest.raises(ValueError, match="unknown precision"):
            srv.submit(_lenet_feed(n=1), precision="bf16")
    finally:
        srv.stop()
