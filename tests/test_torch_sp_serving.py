"""Sequence-parallel serving in paddle_tpu_torch against the JAX package.

The JAX package exports tests/test_long_context.py's fused-attention LM
(``_save_lm``: vocab 64, d_model 32, 2 layers, 4 heads, seq 32) with
``transformer_lm_rules("sp")`` on ``sharding_mesh={"sp": 4}``, and four
port ranks on gloo (``tests/torch_mesh_child.py``) serve it:

* every rank's logits at 4, 1 and 2 rows within 2e-4 (rtol and atol, the
  JAX test's tolerance) of the JAX package's plain predictor; its
  ``sharding_stats()`` activation bytes and count equal to the JAX sp
  predictor's, the per-rank bytes exactly a quarter of the unsharded; every
  fused attention op ran as ring attention (2 a run), and a mixed-length
  storm after one run of each size builds no executor entry;
* the gathered path: a BERT-style encoder whose fused attention takes a
  padding ``Mask``, exported with the sp activation rules (parameters
  replicated), and the LM at 30 positions, which 4 ranks do not divide,
  give the JAX plain predictor's answers with no ring dispatch.

``len_multiple``: the port's ``KVSlotPool`` and ``DecodeServer`` round
every KV length rung and the cap up to the multiple, as the JAX package's
pool does on the same arguments (tests/test_long_context.py:312).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from jax.sharding import PartitionSpec
from paddle_tpu import framework, models, sharding
from paddle_tpu.inference import AnalysisConfig, create_paddle_predictor
from paddle_tpu.sharding.rules import PartitionRules
from torch_mesh_child import launch_ranks

SP, VOCAB, D_MODEL, N_LAYER = 4, 64, 32, 2
TOL = 2e-4
STORM = [1, 4, 2, 2, 4, 1, 4, 1, 2]


def _export(dirname, seq, rules=None, mask=False):
    """The JAX package's export: _save_lm's LM at ``seq`` positions, or with
    ``mask`` a fused BERT-style encoder with a padding mask; with ``rules``
    on an {"sp": SP} mesh."""
    prog, startup = framework.Program(), framework.Program()
    prog.random_seed = startup.random_seed = 19
    with framework.program_guard(prog, startup):
        ids = jfluid.layers.data("src_ids", [seq], dtype="int64")
        if mask:
            m = jfluid.layers.data("input_mask", [seq])
            out = models.transformer.bert_encoder(
                ids, m, vocab_size=VOCAB, d_model=D_MODEL, n_layer=N_LAYER, n_head=4,
                d_inner=64, max_pos=2 * seq, seq_len=seq, dropout_rate=0.0, is_test=True,
                fused_attention=True)
            feeds = ["src_ids", "input_mask"]
        else:
            _, out = models.transformer_lm(ids, None, vocab_size=VOCAB, d_model=D_MODEL,
                                           n_layer=N_LAYER, n_head=4, d_inner=64, seq_len=seq,
                                           max_pos=2 * seq, fused_attention=True)
            feeds = ["src_ids"]
    exe = jfluid.Executor(jfluid.CPUPlace())
    kw = dict(sharding_rules=rules, sharding_mesh={"sp": SP}) if rules is not None else {}
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        jfluid.save_inference_model(dirname, feeds, [out], exe, prog, **kw)
    return dirname


def _feeds(seq, rows, mask=False, seed=3):
    rng = np.random.RandomState(seed)
    f = {"src_ids": rng.randint(1, VOCAB, (rows, seq)).astype(np.int64)}
    if mask:  # each row keeps at least half its positions
        lens = rng.randint(seq // 2, seq + 1, rows)
        f["input_mask"] = (np.arange(seq)[None, :] < lens[:, None]).astype(np.float32)
    return f


def _jax_run(dirname, feed):
    return np.asarray(create_paddle_predictor(AnalysisConfig(dirname)).run(feed)[0])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("sp_serving")
    sp_rules = sharding.transformer_lm_rules("sp")
    mask_rules = PartitionRules([(r".", PartitionSpec())], name="replicated/sp",
                                activations=sp_rules.activations)
    cases = {
        "lm": (32, False, sp_rules),
        "mask": (32, True, mask_rules),
        "seq30": (30, False, sp_rules),
    }
    want, scen = {}, []
    for name, (seq, mask, rules) in cases.items():
        plain = _export(str(d / (name + "_plain")), seq, mask=mask)
        spd = _export(str(d / (name + "_sp")), seq, rules=rules, mask=mask)
        x = _feeds(seq, 4, mask)
        feeds = [{k: v[:n] for k, v in x.items()} for n in (4, 1, 2)]
        jsp = create_paddle_predictor(AnalysisConfig(spd))
        for f in feeds:  # its report is the last traced size's (2 rows); the storm ends at 2
            jsp.run(f)
        want[name] = {"outs": [_jax_run(plain, f) for f in feeds], "stats": jsp.sharding_stats()}
        storm = [{4: 0, 1: 1, 2: 2}[n] for n in STORM] if name == "lm" else []
        scen.append(["sp_serve:" + name, {
            "model_dir": spd, "feeds": [{k: v.tolist() for k, v in f.items()} for f in feeds],
            "storm": storm}])
    ranks = launch_ranks(str(d / "ranks"), SP, scen)
    return {"want": want, "ranks": ranks}


_ACT_KEYS = ("activation_bytes_unsharded", "activation_bytes_per_device",
             "n_activations_constrained")


@pytest.mark.parametrize("case", ["lm", "mask", "seq30"])
def test_port_ranks_serve_the_jax_sp_export(served, case):
    want = served["want"][case]
    for r in served["ranks"]["sp_serve:" + case]:
        assert r["sharded"]
        for got, ref in zip(r["outs"], want["outs"]):
            np.testing.assert_allclose(np.asarray(got), ref, rtol=TOL, atol=TOL)
        st = r["stats"]
        assert st["mesh_axes"] == {"sp": SP}
        assert {k: st[k] for k in _ACT_KEYS} == {k: want["stats"][k] for k in _ACT_KEYS}
        runs = len(r["outs"]) + (len(STORM) if case == "lm" else 0)
        if case == "lm":
            # the capacity claim, exactly: each rank holds 1/sp of the bytes
            assert st["n_activations_constrained"] > 0
            assert st["activation_bytes_per_device"] * SP == st["activation_bytes_unsharded"]
            assert r["ring"]["calls"] == N_LAYER * runs
            assert r["ring"]["hops"] == (SP - 1) * N_LAYER * runs
            assert r["storm_misses"] == 0, "the storm built an executor entry"
        else:  # a Mask, or a length the ranks do not divide: the gathered path
            assert r["ring"]["calls"] == 0
    if case == "seq30":
        assert want["stats"]["n_activations_constrained"] == 0


# ---------------------------------------------------------------------------
# len_multiple
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_seq_len,mult,ladder", [
    (50, 4, None), (2048, 2, None), (100, 3, [10, 40, 64]), (64, 1, None)])
def test_kv_pool_len_multiple_rounds_rungs(max_seq_len, mult, ladder):
    from paddle_tpu.serving.kv_pool import KVSlotPool as JPool
    from paddle_tpu_torch.serving.decode import DecodeServer
    from paddle_tpu_torch.serving.kv_pool import KVSlotPool

    def step(*a):
        return None
    step.device = "cpu"
    kw = dict(eos_id=0, max_slots=2, max_seq_len=max_seq_len, len_ladder=ladder,
              len_multiple=mult)
    want = JPool(lambda *a: None, lambda *a: None, **kw)
    pool = KVSlotPool(step, lambda *a, **k: None, **kw)
    assert list(pool.len_policy.ladder) == list(want.len_policy.ladder)
    assert pool.max_seq_len == want.len_policy.max_batch_size >= max_seq_len
    assert all(r % mult == 0 for r in pool.len_policy.ladder)
    srv = DecodeServer(step, lambda *a, **k: None, eos_id=0, max_seq_len=max_seq_len,
                       max_slots=2, len_ladder=ladder, len_multiple=mult)
    try:
        assert list(srv._pool.len_policy.ladder) == list(want.len_policy.ladder)
    finally:
        srv.stop()
