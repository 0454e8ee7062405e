"""The port's partition rules, layouts and mesh surface against the JAX
package's, in process.

* Every case of tests/test_sharding_rules.py and tests/test_partition_rules.py
  runs on both packages' ``sharding`` (the same rule sets over each one's
  own ``PartitionSpec``): the resolved specs are equal entry for entry, and
  a case that raises raises the same typed error (class name and message)
  in both.
* ``to_manifest`` is the JAX package's JSON, key for key, for every
  canonical layout (``transformer_lm``, ``transformer_nmt``, ``deepfm`` in
  ``tp``, ``fsdp``, ``fsdp_tp``, and the transformers' ``sp``), and each
  package reads the other's manifest back.
* ``python -m paddle_tpu_torch.tools.check_partition_rules`` passes on the
  port's own models, and catches a doctored layout.
* Meshes: a mesh larger than the world raises the JAX package's
  ``ValueError``; a world of one rank is a mesh of size-1 axes; a
  ``NamedSharding``'s boxes are jax's ``devices_indices_map`` for the same
  spec on a mesh of the same shape; the strategies warn on inert knobs.
* ``TrainPartitionRules``: accumulators inherit their param's spec from the
  port optimizer's ``accumulator_map`` (the JAX package's map, name for
  name), with no default escape hatch.
"""
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import sharding as jsh
from paddle_tpu_torch import sharding as tsh
from paddle_tpu_torch.parallel import mesh as tmesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jP(*e):
    from jax.sharding import PartitionSpec

    return PartitionSpec(*e)


PACKAGES = {"jax": (jsh, _jP), "port": (tsh, tsh.PartitionSpec)}


def _norm(v):
    """Specs and containers as plain tuples / dicts, comparable across packages."""
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)) or type(v).__name__ == "PartitionSpec":
        return tuple(_norm(x) for x in v)
    return v


def _outcome(case, pkg):
    sh, P = PACKAGES[pkg]
    try:
        return ("ok", _norm(case(sh, P)))
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        return ("err", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py's cases, on both packages
# ---------------------------------------------------------------------------
def _first_match(sh, P):
    rules = sh.PartitionRules([(r"_att_q_w$", P("tp", None)), (r"_w$", P(None, "tp"))])
    shadow = sh.PartitionRules([(r"_w$", P(None, "tp")), (r"_att_q_w$", P("tp", None))])
    return [rules.spec_for("enc_att_q_w", (8, 8)), rules.spec_for("enc_other_w", (8, 8)),
            shadow.spec_for("enc_att_q_w", (8, 8))]


def _substring_vs_anchored(sh, P):
    sub = sh.PartitionRules([(r"emb", P("tp", None))])
    exact = sh.PartitionRules([(r"^word_emb$", P("tp", None))], default=P())
    return [sub.spec_for("word_emb_table", (8, 4)), sub.spec_for("prefix_emb", (8, 4)),
            exact.spec_for("word_emb", (8, 4)), exact.spec_for("word_emb_table", (8, 4)),
            exact.spec_for("my_word_emb", (8, 4))]


CASES = {
    "first_match_wins": _first_match,
    "substring_vs_anchored": _substring_vs_anchored,
    "unmatched_param_is_typed_and_named": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P("tp"))], name="mylayout").match({"mystery_bias": (16,)}),
    "default_fallback": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P(None, "tp"))], default=P()).match({"a_w": (8, 8), "a_b": (8,)}),
    "rank_mismatch": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P(None, "tp"))], name="r").spec_for("vec_w", (16,)),
    "rank_mismatch_default": lambda sh, P: sh.PartitionRules(
        [(r"never$", P())], default=P("a", "b", "c")).spec_for("x", (4, 4)),
    "rank_mismatch_match_array": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P(None, "tp"))], name="r").match({"vec_w": np.zeros(16, np.float32)}),
    "scalars_never_partition": lambda sh, P: [
        sh.PartitionRules([(r".", P("tp"))]).spec_for(n, s)
        for n, s in (("lr", ()), ("step", (1,)), ("bias11", (1, 1)), ("real", (8,)),
                     ("lr", None))],
    "divisible": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P(None, "tp"))]).validate_shapes({"a_w": (8, 32)}, {"tp": 2}),
    "not_divisible": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P(None, "tp"))]).validate_shapes({"a_w": (8, 32)}, {"tp": 3}),
    "multi_axis_divisible": lambda sh, P: sh.PartitionRules(
        [(r"_emb$", P(("fsdp", "tp"), None))]).validate_shapes({"x_emb": (64, 4)},
                                                               {"fsdp": 4, "tp": 2}),
    "multi_axis_not_divisible": lambda sh, P: sh.PartitionRules(
        [(r"_emb$", P(("fsdp", "tp"), None))]).validate_shapes({"x_emb": (36, 4)},
                                                               {"fsdp": 4, "tp": 2}),
    "absent_axis_counts_one": lambda sh, P: sh.PartitionRules(
        [(r"_w$", P(None, "tp"))]).validate_shapes({"a_w": (8, 7)}, {"other": 4}),
    "dead_rules_and_axes": lambda sh, P: (lambda r: [r.dead_rules(["a_w", "b_w"]),
                                                     sorted(r.axes())])(
        sh.PartitionRules([(r"_w$", P("fsdp", "tp")), (r"_ghost$", P(("fsdp", "tp"), None))])),
    "empty_rules_need_default": lambda sh, P: sh.PartitionRules([]),
    "empty_rules_with_default": lambda sh, P: sh.PartitionRules(
        [], default=P()).spec_for("anything", (4, 4)),
    "bare_string_spec_rejected": lambda sh, P: sh.PartitionRules([(r"_w$", "tp")]),
    "bad_spec_entry": lambda sh, P: sh.PartitionRules([(r"_w$", [3])]),
    "manifest_round_trip": lambda sh, P: (lambda back: [
        back.name, back.rules, back.default, back.spec_for("x_emb", (8, 4))])(
        sh.PartitionRules.from_manifest(json.loads(json.dumps(sh.PartitionRules(
            [(r"_qkv_w$", P("fsdp", "tp")), (r"_emb$", P(("fsdp", "tp"), None)),
             (r"_ln_", P())], default=P("fsdp"), name="rt").to_manifest())))),
    "malformed_manifest_typed": lambda sh, P: sh.PartitionRules.from_manifest({"nope": 1}),
    "canonical_tp_layout_shapes": lambda sh, P: [
        sh.canonical_rules("transformer_lm", "tp").spec_for(n, s) for n, s in (
            ("lm_dec_0_att_q_w", (64, 64)), ("lm_dec_0_att_out_w", (64, 64)),
            ("lm_dec_0_ffn_fc0_w", (64, 128)), ("lm_dec_0_ffn_fc1_w", (128, 64)),
            ("lm_dec_0_ln1_scale", (64,)), ("lm_word_emb", (512, 64)),
            ("lm_head_w", (64, 512)))],
    "unknown_family_typed": lambda sh, P: sh.canonical_rules("no_such_family"),
    "unknown_mode_typed": lambda sh, P: sh.canonical_rules("transformer_lm", "no_such_mode"),
    "activation_rules_sp": lambda sh, P: (lambda r: [
        r.activation_spec_for("lm_dec_0_att_fused_3.tmp_0", (2, 4, 16, 8)),
        r.activation_spec_for("fc_3.tmp_1", (2, 16, 32)),
        r.activation_spec_for("fc_3.tmp_1", (16,)),
        r.activation_spec_for("reshape2_0.tmp_0"),
        r.dead_activation_rules(["fc_1.tmp_0"]), sorted(r.axes())])(
        sh.canonical_rules("transformer_lm", "sp")),
    "with_default_keeps_name": lambda sh, P: (lambda r: [r.name, r.default, len(r)])(
        sh.canonical_rules("deepfm", "tp").with_default(P())),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rule_semantics_match_the_jax_package(case):
    """Each case's specs, or its typed error's class and message, equal in
    both packages (JAX: tests/test_sharding_rules.py)."""
    want, got = _outcome(CASES[case], "jax"), _outcome(CASES[case], "port")
    assert got == want


def test_typed_errors_are_the_jax_package_names():
    for name in ("ShardingRuleError", "MeshCommittedStateError"):
        assert getattr(tsh, name).__name__ == getattr(jsh, name).__name__
    assert issubclass(tsh.ShardingRuleError, ValueError)
    assert issubclass(tsh.MeshCommittedStateError, RuntimeError)
    from paddle_tpu.faults import checkpoint as jck
    from paddle_tpu_torch.faults import checkpoint as tck

    for name in ("CheckpointMeshMismatchError", "CheckpointCorruptionError"):
        assert getattr(tck, name).__name__ == getattr(jck, name).__name__


# ---------------------------------------------------------------------------
# manifests of the canonical layouts
# ---------------------------------------------------------------------------
LAYOUTS = [(f, m) for f in ("transformer_lm", "transformer_nmt", "deepfm")
           for m in ("tp", "fsdp", "fsdp_tp")] + [("transformer_lm", "sp"), ("transformer_nmt", "sp")]


@pytest.mark.parametrize("family,mode", LAYOUTS)
def test_canonical_manifest_is_the_jax_packages(family, mode):
    jdoc = jsh.canonical_rules(family, mode).to_manifest()
    tdoc = tsh.canonical_rules(family, mode).to_manifest()
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    # each package reads the other's manifest back to the same rule set
    back = tsh.PartitionRules.from_manifest(json.loads(json.dumps(jdoc)))
    assert back.to_manifest() == tdoc
    jback = jsh.PartitionRules.from_manifest(json.loads(json.dumps(tdoc)))
    assert jback.to_manifest() == jdoc


def test_train_rules_inherit_from_the_port_accumulator_map():
    """The port optimizer's accumulator map is the JAX package's, name for
    name, and TrainPartitionRules resolves each accumulator to its param's
    spec (rank-checked on its own shape), with no default escape hatch."""
    from paddle_tpu import models as jmodels
    from paddle_tpu_torch import models as tmodels
    from torch_mesh_child import build_lm

    jlm, tlm = build_lm(jfluid, jmodels), build_lm(tfluid, tmodels)
    jmap, tmap = jlm["opt"].accumulator_map(), tlm["opt"].accumulator_map()
    assert tmap == {k: tuple(v) for k, v in jmap.items()}
    shapes = {v.name: tuple(v.shape or ()) for v in tlm["prog"].list_vars()
              if v.persistable and not v.is_data}
    for mode in ("tp", "fsdp", "fsdp_tp"):
        jr = jsh.train_rules(jsh.canonical_rules("transformer_lm", mode), accumulators=jmap)
        tr = tsh.train_rules(tsh.canonical_rules("transformer_lm", mode), optimizer=tlm["opt"])
        assert _norm(tr.match(shapes)) == _norm(jr.match(shapes))
        assert {n: tr.state_kind(n) for n in shapes} == {n: jr.state_kind(n) for n in shapes}
    doctored = [(p, s) for p, s in tsh.canonical_rules("transformer_lm", "tp").rules
                if "head" not in p]
    tr = tsh.train_rules(tsh.PartitionRules(doctored, name="doctored"), optimizer=tlm["opt"])
    acc = next(a for a, (p, k) in tmap.items() if p == "lm_head_w" and k == "moment1")
    with pytest.raises(tsh.ShardingRuleError, match="inherits") as ei:
        tr.spec_for(acc, (32, 128))
    assert acc in str(ei.value) and "lm_head_w" in str(ei.value)
    with pytest.raises(tsh.ShardingRuleError, match="empty accumulator map"):
        tsh.TrainPartitionRules(tsh.canonical_rules("transformer_lm", "tp"), {})
    with pytest.raises(tsh.ShardingRuleError, match="needs the optimizer"):
        tsh.train_rules(tsh.canonical_rules("transformer_lm", "tp"))


# ---------------------------------------------------------------------------
# tools.check_partition_rules (tests/test_partition_rules.py's cases)
# ---------------------------------------------------------------------------
def test_partition_rules_tool_passes_on_the_port_models():
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.check_partition_rules"],
                          cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "9 layouts cover 3 families" in proc.stdout


def test_partition_rules_tool_sees_real_params_and_catches_drift():
    from paddle_tpu_torch.tools import check_partition_rules as tool

    lm = tool._build("transformer_lm")
    assert "lm_dec_0_att_q_w" in lm and "lm_head_w" in lm
    assert "nmt_dec_0_cross_out_w" in tool._build("transformer_nmt")
    dfm = tool._build("deepfm")
    assert "deepfm_fm_emb" in dfm and any(n.startswith("fc_") and ".b_" in n for n in dfm)
    shapes, acc_map = tool._build_train("transformer_lm")
    assert {a for a, (_, k) in acc_map.items() if k == "moment1"} <= set(shapes)
    good = tsh.canonical_rules("transformer_lm", "tp")
    pruned = tsh.PartitionRules([(p, s) for p, s in good.rules if "head" not in p],
                                name="doctored")
    with pytest.raises(tsh.ShardingRuleError, match="lm_head_w"):
        pruned.match(lm)
    padded = tsh.PartitionRules(list(good.rules) + [(r"_no_such_param_ever$", None)],
                                name="doctored2")
    assert padded.dead_rules(lm) == ["_no_such_param_ever$"]


# ---------------------------------------------------------------------------
# meshes and strategies
# ---------------------------------------------------------------------------
def test_mesh_larger_than_the_world_raises_the_jax_error():
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        tmesh.make_mesh({"dp": 2})
    with pytest.raises(ValueError, match=r"needs 4 devices, have 1"):
        tsh.sharded_train_program(tfluid.Program(), tsh.canonical_rules("transformer_lm", "fsdp"),
                                  accumulators={"m": "p"}, mesh_axes={"fsdp": 2, "tp": 2})


def test_one_rank_world_is_a_mesh_of_size_one_axes():
    mesh = tmesh.make_mesh({"fsdp": 1, "tp": 1})
    assert mesh.axis_names == ("fsdp", "tp") and mesh.devices.shape == (1, 1)
    assert mesh.group(("fsdp", "tp")) == (None, [0])
    assert tmesh.data_parallel_mesh().shape == {"dp": 1}
    with tmesh.MeshGuard(mesh):
        assert tmesh.default_mesh() is mesh
    sh = tmesh.NamedSharding(mesh, tsh.PartitionSpec(("fsdp", "tp"), None))
    assert sh.is_fully_replicated and sh.shard_shape((8, 4)) == (8, 4)
    # axis rules validate against the mesh's names, typed
    with pytest.raises(tsh.ShardingRuleError, match="tp"):
        tsh.PartitionRules([(r".", tsh.PartitionSpec("tp"))]).validate_mesh(
            tmesh.make_mesh({"dp": 1}))


@pytest.mark.parametrize("axes,spec", [
    ({"fsdp": 2, "tp": 2}, (("fsdp", "tp"), None)),
    ({"fsdp": 2, "tp": 2}, ("tp", "fsdp")),
    ({"fsdp": 2, "tp": 2}, (None, "tp")),
    ({"dp": 4}, ("dp",)),
    ({"fsdp": 2, "tp": 2}, ()),
])
def test_named_sharding_boxes_are_jaxs(axes, spec):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    shape = (8, 12)
    n = int(np.prod(list(axes.values())))
    jm = Mesh(np.array(jax.devices("cpu")[:n]).reshape(list(axes.values())), tuple(axes))
    jmap = NamedSharding(jm, PartitionSpec(*spec)).devices_indices_map(shape)
    for rank, dev in enumerate(jm.devices.reshape(-1)):
        mesh = tmesh.Mesh(axes, rank, groups={})
        box = tmesh.NamedSharding(mesh, tsh.PartitionSpec(*spec)).local_box(shape)
        want = tuple((0 if s.start is None else s.start, d if s.stop is None else s.stop)
                     for s, d in zip(jmap[dev], shape))
        assert box == want, (rank, box, want)


def test_strategies_warn_on_inert_knobs():
    for cls in (tfluid.BuildStrategy, tfluid.ExecutionStrategy, tfluid.DistributedStrategy):
        s = cls()
        knob = sorted(cls._INERT)[0]
        with pytest.warns(UserWarning, match="no effect"):
            setattr(s, knob, getattr(s, knob))
    s = tfluid.DistributedStrategy()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s.mesh_axes = {"tp": 2}
        s.sharding_specs = {"w": (None, "tp")}
    j = jfluid.DistributedStrategy()
    assert sorted(vars(s)) == sorted(vars(j))
