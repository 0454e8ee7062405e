"""Sharded serving in paddle_tpu_torch: a model the JAX package exported
with a tp layout, served by the port's predictors in a group of 2 gloo CPU
ranks, against the JAX package's predictor.

The model is tests/test_sharded_serving.py's LM (vocab 256, d_model 32, 2
layers, 4 heads, seq 16, logits only), exported by the JAX package with
``canonical_rules("transformer_lm", "tp")`` and ``sharding_mesh={"tp": 2}``.

* Each rank's predictor loads it sharded (the manifest's world of 2):
  ``param_placements`` shows the shard shapes of tests/test_sharded_serving.py:
  74-118 (q/k/v column-parallel ``(D, D/2)``, attention out row-parallel
  ``(D/2, D)``, embedding ``(V/2, D)`` and head ``(D, V/2)``, norms whole),
  every sharded param's bytes half its whole size, at least 20 params
  sharded, ``sharding_params_sharded_total`` moved by them and the group's
  gauge set; both ranks' logits on 3 rows within rtol 2e-4, atol 2e-4 of
  the JAX predictor's.
* The bf16 composition (the JAX package's export with a bf16 policy and the
  tp layout): each rank stores the hoisted params in bf16, cast once a shard
  at placement (half the fp32 shard's bytes), serves bf16 by default within
  3e-2 of the output's scale of the JAX package's bf16 predictor, and fp32
  on request within 2e-4 of the JAX fp32 predictor.
* In this process (a world of one rank) the tp-2 export raises the JAX
  package's mesh ``ValueError``, the port's own export with the same rules
  writes the JAX package's ``sharding`` block key for key, and the export
  checks (an uncovered param, a mesh missing the rules' axis, a multi-axis
  rule set with no mesh, a dim the mesh does not divide) are the JAX
  package's typed ``ShardingRuleError``, message for message.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu import sharding as jsh
from paddle_tpu.inference import AnalysisConfig as JConfig
from paddle_tpu.inference import create_paddle_predictor as jpredictor
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import sharding as tsh
from paddle_tpu_torch.inference import AnalysisConfig, create_paddle_predictor
from torch_mesh_child import launch_ranks

SEQ, D_MODEL, VOCAB, TP = 16, 32, 256, 2
TOL = 2e-4
BF16_TOL = 3e-2  # of the output's scale: two packages' bf16 roundings (test_torch_precision_serving)


def _build(fluid, models, n_layer=2):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 21
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [SEQ], dtype="int64")
        _, logits = models.transformer_lm(ids, None, vocab_size=VOCAB, d_model=D_MODEL,
                                          n_layer=n_layer, n_head=4, d_inner=64, seq_len=SEQ,
                                          max_pos=64)
    return prog, startup, logits


def _ids(n, seed=0):
    return np.random.RandomState(seed).randint(1, VOCAB, (n, SEQ)).astype(np.int64)


def _jax_export(dirname, sharded=True, precision=False):
    prog, startup, logits = _build(jfluid, jmodels)
    exe = jfluid.Executor(jfluid.CPUPlace())
    kw = {}
    if sharded:
        kw = dict(sharding_rules=jsh.transformer_lm_rules("tp"), sharding_mesh={"tp": TP})
    if precision:
        kw["precision_policy"] = {"dtype": "bf16", "parity_feeds": [{"src_ids": _ids(2, 9)}]}
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.save_inference_model(dirname, ["src_ids"], [logits], exe, prog, **kw)
    return dirname


def _jax_out(dirname, x, precision=None):
    pred = jpredictor(JConfig(dirname))
    return np.asarray(pred.run({"src_ids": x}, precision=precision)[0])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serving")
    tp_dir = _jax_export(str(d / "tp2"))
    bf_dir = _jax_export(str(d / "tp2_bf16"), precision=True)
    x = _ids(3, seed=5)
    want = {"fp32": _jax_out(str(d / "tp2"), x),
            "bf16": _jax_out(bf_dir, x), "bf16_fp32": _jax_out(bf_dir, x, "fp32")}
    ranks = launch_ranks(str(d / "ranks"), 2, [
        ["serve:tp", {"model_dir": tp_dir, "ids": x.tolist()}],
        ["serve:bf16", {"model_dir": bf_dir, "ids": x.tolist(), "precisions": [None, "fp32"]}]])
    return {"dir": d, "tp_dir": tp_dir, "want": want, "ranks": ranks}


def test_jax_tp_export_served_by_two_port_ranks(served):
    for res in served["ranks"]["serve:tp"]:
        assert res["sharded"]
        np.testing.assert_allclose(np.asarray(res["out"]), served["want"]["fp32"],
                                   rtol=TOL, atol=TOL)
        p = res["placements"]
        qw = p["lm_dec_0_att_q_w"]
        assert qw["spec"] == [None, "tp"] and qw["placed"] and qw["sharded"]
        assert qw["shard_shape"] == [D_MODEL, D_MODEL // TP]
        assert p["lm_dec_1_att_out_w"]["shard_shape"] == [D_MODEL // TP, D_MODEL]
        assert p["lm_word_emb"]["shard_shape"] == [VOCAB // TP, D_MODEL]
        assert p["lm_head_w"]["shard_shape"] == [D_MODEL, VOCAB // TP]
        ln = p["lm_dec_0_ln1_scale"]
        assert not ln["sharded"] and ln["shard_shape"] == [D_MODEL]
        for name, q in p.items():
            if q["sharded"]:
                assert q["bytes_per_device"] * TP <= int(np.prod(q["shape"])) * 4 + 4, name
        st = res["stats"]
        assert st["n_sharded"] >= 20 and st["mesh_axes"] == {"tp": TP}
        assert st["hbm_bytes_per_device"] < st["replicated_bytes"]
        assert res["params_sharded"] >= st["n_sharded"]
        assert res["group_gauge"] == st["hbm_bytes_per_device"]


def test_bf16_composition_casts_each_shard_at_placement(served):
    want = served["want"]
    scale = float(np.abs(want["bf16"]).max())
    for res in served["ranks"]["serve:bf16"]:
        bf16, fp32 = (np.asarray(o) for o in res["outs"])
        assert np.abs(bf16 - want["bf16"]).max() <= BF16_TOL * scale
        np.testing.assert_allclose(fp32, want["bf16_fp32"], rtol=TOL, atol=TOL)
        hoisted = {n: q for n, q in res["placements"].items() if q["dtype"] == "bfloat16"}
        assert hoisted and any(q["sharded"] for q in hoisted.values())
        for n, q in hoisted.items():  # a bf16 shard: half the fp32 shard's bytes
            assert q["bytes_per_device"] == int(np.prod(q["shard_shape"])) * 2, n


# ---------------------------------------------------------------------------
# in process (a world of one rank)
# ---------------------------------------------------------------------------
def test_tp2_export_in_a_world_of_one_raises_the_mesh_error(served):
    cfg = AnalysisConfig(served["tp_dir"])
    cfg.disable_gpu()
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        create_paddle_predictor(cfg)


def test_port_export_writes_the_jax_packages_sharding_block(served, tmp_path):
    prog, startup, logits = _build(tfluid, tmodels)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.save_inference_model(str(tmp_path / "m"), ["src_ids"], [logits], exe, prog,
                                scope=scope, sharding_rules=tsh.transformer_lm_rules("tp"),
                                sharding_mesh={"tp": TP})
    got = json.load(open(tmp_path / "m" / "__model__"))["sharding"]
    want = json.load(open(os.path.join(served["tp_dir"], "__model__")))["sharding"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("rules,mesh", [
    ([(r"_att_", (None, "tp"))], {"tp": TP}),       # a param no rule covers
    ("tp", {"dp": 2}),                               # a mesh missing the rules' axis
    ("fsdp_tp", None),                               # a multi-axis rule set with no mesh
    ("tp", {"tp": 3}),                               # d_model 32 does not divide by 3
])
def test_export_checks_are_the_jax_packages(tmp_path, rules, mesh):
    outcomes = []
    for fluid, models, sh, kw in ((jfluid, jmodels, jsh, {}), (tfluid, tmodels, tsh, None)):
        prog, startup, logits = _build(fluid, models, n_layer=1)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        r = sh.transformer_lm_rules(rules) if isinstance(rules, str) else rules
        with fluid.scope_guard(scope):
            exe.run(startup)
            extra = {} if kw is not None else {"scope": scope}
            with pytest.raises(sh.ShardingRuleError) as ei:
                fluid.save_inference_model(str(tmp_path / fluid.__name__), ["src_ids"],
                                           [logits], exe, prog, sharding_rules=r,
                                           sharding_mesh=mesh, **extra)
        outcomes.append(str(ei.value))
    assert outcomes[1] == outcomes[0]
