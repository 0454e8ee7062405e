"""Sharded FSDP / TP training of paddle_tpu_torch over gloo CPU ranks, and
its shard-wise checkpoints, against the JAX package.

The model is tests/test_sharded_training.py's LM (vocab 128, d_model 32,
1 layer, 4 heads, seq 16, batch 4, Adam 1e-3), built by both packages name
for name and started from the JAX package's startup state.  The yardstick
is the JAX package's replicated run of the same 6 steps (its golden).

* ``sharded_train_program(canonical_rules("transformer_lm", mode))`` in the
  modes ``fsdp`` ``{"fsdp": 2}`` and ``tp`` ``{"tp": 2}`` (2 ranks) and
  ``fsdp_tp`` ``{"fsdp": 2, "tp": 2}`` (4 ranks), 4 steps: every rank's
  losses within rtol 2e-4 of the golden (the JAX test's bar), a rank's
  param + moment bytes at most 0.6 of the replicated footprint (0.35 at
  fsdp_tp), a moment's shard shaped as its param's, the state-bytes gauges
  published (moments above params), no plan built after the first step, an
  uncompiled run over the shards a typed ``MeshCommittedStateError``, and
  ``Executor(reshard_on_gather=True)`` gathering them back whole.
* Shard-wise checkpoints: the fsdp-2 run saves after steps 2 and 4 (per-rank
  shard files, the JAX package's manifest).  Resumed at 4 ranks
  (``{"fsdp": 4}``) and in this one process, steps 5 and 6 match the golden;
  the JAX package restores the port's checkpoint on its own mesh and its
  steps 5 and 6 match the golden; a checkpoint the JAX package wrote after
  step 2 restores in the port's 2 ranks and in this process, and steps 3 to
  6 match the golden.  A flipped byte in a step-4 shard falls back to step 2
  (counted), and steps 3 to 6 still match.  A shard set that no longer tiles
  a region, and overlapping shards, are typed ``CheckpointMeshMismatchError``;
  shard-wise state with no ``compiled=`` is a typed ``ValueError``; and
  ``tools.check_checkpoint`` passes the port's checkpoint.

Every rank has a time limit and the ports are free ones.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu import sharding as jsh
from paddle_tpu.faults import checkpoint as jckpt
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch import sharding as tsh
from paddle_tpu_torch.faults import checkpoint as tckpt
from torch_mesh_child import LM, build_lm, launch_ranks, lm_batches
from torch_parity_util import jax_startup_state

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 6
RTOL = 2e-4


def _jax_run(lm, state, compiled=None, start=0, steps=STEPS, scope=None, save=None):
    """The JAX package's losses of steps start..steps (``save``: (run dir,
    step) of a shard-wise checkpoint)."""
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = scope if scope is not None else jfluid.Scope()
    out = []
    with jfluid.scope_guard(scope):
        if state is not None:
            for n, v in state.items():
                scope.set(n, v)
        for i, feed in enumerate(lm_batches(steps, start)):
            out.append(float(np.asarray(exe.run(compiled or lm["prog"], feed=feed,
                                                fetch_list=[lm["loss"]])[0])))
            if save is not None and start + i + 1 == save[1]:
                jckpt.TrainCheckpoint(save[0]).save(lm["prog"], scope, save[1],
                                                    compiled=compiled)
    return out


def _port_restore(run_dir, steps=STEPS, state=None):
    """This process (one rank): restore run_dir's newest verifiable
    checkpoint through a {"fsdp": 1} compiled program and train on."""
    lm = build_lm(tfluid, tmodels)
    compiled = tsh.sharded_train_program(lm["prog"], tsh.transformer_lm_rules("fsdp"),
                                         optimizer=lm["opt"], mesh_axes={"fsdp": 1})
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(lm["startup"], scope=scope)
    ck = tckpt.TrainCheckpoint(run_dir, keep=3)
    cursor = ck.restore(lm["prog"], scope, compiled=compiled)
    losses = [float(exe.run(compiled, feed=f, fetch_list=[lm["loss"]], scope=scope)[0])
              for f in lm_batches(steps, cursor["step"])]
    return cursor["step"], losses, ck


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    jlm = build_lm(jfluid, jmodels)
    state = jax_startup_state(jlm["startup"], jlm["prog"])
    np.savez(d / "state.npz", **state)
    golden = _jax_run(jlm, state)
    # a checkpoint the JAX package writes after step 2 of its fsdp-2 run
    jc = jsh.sharded_train_program(jlm["prog"], jsh.transformer_lm_rules("fsdp"),
                                   optimizer=jlm["opt"], mesh_axes={"fsdp": 2})
    jax_fsdp = _jax_run(jlm, state, jc, steps=2, save=(str(d / "jax_run"), 2))
    st = str(d / "state.npz")
    two = launch_ranks(str(d / "two"), 2, [
        ["lm:fsdp", {"state": st, "mode": "fsdp", "mesh_axes": {"fsdp": 2}, "steps": 4,
                     "ckpt_dir": str(d / "run"), "save_at": [2, 4]}],
        ["lm:tp", {"state": st, "mode": "tp", "mesh_axes": {"tp": 2}, "steps": 4}],
        ["lm_restore:jax", {"state": st, "mode": "fsdp", "mesh_axes": {"fsdp": 2},
                            "run_dir": str(d / "jax_run"), "steps": STEPS}]])
    four = launch_ranks(str(d / "four"), 4, [
        ["lm:fsdp_tp", {"state": st, "mode": "fsdp_tp", "mesh_axes": {"fsdp": 2, "tp": 2},
                        "steps": 4}],
        ["lm_restore:from2", {"state": st, "mode": "fsdp", "mesh_axes": {"fsdp": 4},
                              "run_dir": str(d / "run"), "steps": STEPS}]])
    return {"dir": d, "state": state, "golden": golden, "jax_fsdp": jax_fsdp, "two": two,
            "four": four, "jlm": jlm, "jc": jc}


def _replicated_bytes(jlm):
    acc = jlm["opt"].accumulator_map()
    names = {p.name for p in jlm["prog"].global_block().all_parameters()} | set(acc)
    block = jlm["prog"].global_block()
    return sum(int(np.prod(block._find_var_recursive(n).shape or (1,))) * 4 for n in names)


@pytest.mark.parametrize("mode,ranks,share", [("fsdp", "two", 0.6), ("tp", "two", 0.6),
                                              ("fsdp_tp", "four", 0.35)])
def test_sharded_training_parity(runs, mode, ranks, share):
    golden = runs["golden"]
    assert len(set(golden)) == STEPS  # each step's batch and state are its own
    replicated = _replicated_bytes(runs["jlm"])
    for res in runs[ranks]["lm:" + mode]:
        np.testing.assert_allclose(res["losses"], golden[:4], rtol=RTOL)
        assert res["misses_after_first"] == 0
        assert res["bytes"] <= share * replicated, (mode, res["bytes"], replicated)
        assert res["m1_shard"] == res["emb_shard"]
        g = res["gauges"]
        assert min(g.values()) > 0 and g["moment"] > g["param"] and g["grad"] == g["param"]
        assert "MeshCommittedStateError" not in res["committed"] and "lm_" in res["committed"]
        assert "placed by a previous compiled run" in res["committed"]
        assert np.isfinite(res["uncompiled_after_gather"])
        assert res["emb_after_gather"] == [LM["vocab"], LM["d_model"]]
    shard = {"fsdp": [64, 32], "tp": [64, 32], "fsdp_tp": [32, 32]}[mode]
    assert runs[ranks]["lm:" + mode][0]["emb_shard"] == shard


def test_checkpoint_written_at_two_ranks_resumes_at_four_and_at_one(runs):
    golden = runs["golden"]
    run_dir = str(runs["dir"] / "run")
    sdir = os.path.join(run_dir, "ckpt-000004", "shards")
    man = json.load(open(os.path.join(sdir, "manifest.json")))
    assert man["mesh_axes"] == {"fsdp": 2}
    ent = man["vars"]["lm_word_emb"]
    assert ent["shape"] == [LM["vocab"], LM["d_model"]] and ent["spec"] == ["fsdp"]
    for doc in ent["shards"]:  # shard-shaped files: no rank gathered the tensor
        assert np.load(os.path.join(sdir, doc["file"])).shape == (LM["vocab"] // 2, LM["d_model"])
    host = {e["name"] for e in json.load(open(os.path.join(
        run_dir, "ckpt-000004", "params", "__manifest__.json")))["vars"]}
    assert not host & set(man["vars"])
    for res in runs["four"]["lm_restore:from2"]:
        assert res["step"] == 4 and res["stats"]["exchanged"] > 0
        np.testing.assert_allclose(res["losses"], golden[4:], rtol=RTOL)
    step, losses, ck = _port_restore(run_dir)
    assert step == 4 and ck.last_restore_fallbacks == 0
    np.testing.assert_allclose(losses, golden[4:], rtol=RTOL)
    proc = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tools.check_checkpoint",
                           run_dir], cwd=REPO_ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_checkpoints_cross_between_the_packages(runs):
    golden = runs["golden"]
    np.testing.assert_allclose(runs["jax_fsdp"], golden[:2], rtol=RTOL)
    # the JAX package's checkpoint, in the port's two ranks and in one
    for res in runs["two"]["lm_restore:jax"]:
        assert res["step"] == 2
        np.testing.assert_allclose(res["losses"], golden[2:], rtol=RTOL)
    step, losses, _ = _port_restore(str(runs["dir"] / "jax_run"))
    assert step == 2
    np.testing.assert_allclose(losses, golden[2:], rtol=RTOL)
    # the port's checkpoint, in the JAX package on its fsdp-2 mesh
    jlm = runs["jlm"]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(jlm["startup"])
    ck = jckpt.TrainCheckpoint(str(runs["dir"] / "run"), keep=3)
    assert ck.restore(jlm["prog"], scope, compiled=runs["jc"])["step"] == 4
    np.testing.assert_allclose(_jax_run(jlm, None, runs["jc"], start=4, scope=scope),
                               golden[4:], rtol=RTOL)


def test_corrupt_shard_falls_back_and_bad_manifests_are_typed(runs, tmp_path):
    golden = runs["golden"]
    run_dir = str(tmp_path / "run")
    shutil.copytree(str(runs["dir"] / "run"), run_dir)
    shard = os.path.join(run_dir, "ckpt-000004", "shards", "v000_s01.npy")
    with open(shard, "r+b") as f:
        f.seek(-1, 2)
        b = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    step, losses, ck = _port_restore(run_dir)
    assert step == 2 and ck.last_restore_fallbacks == 1
    np.testing.assert_allclose(losses, golden[2:], rtol=RTOL)

    lm = build_lm(tfluid, tmodels)
    compiled = tsh.sharded_train_program(lm["prog"], tsh.transformer_lm_rules("fsdp"),
                                         optimizer=lm["opt"], mesh_axes={"fsdp": 1})
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(lm["startup"], scope=scope)
    with pytest.raises(ValueError, match="compiled"):
        tckpt.TrainCheckpoint(run_dir).restore(lm["prog"], scope)
    ck2 = os.path.join(run_dir, "ckpt-000002")
    mpath = os.path.join(ck2, "shards", "manifest.json")
    os.remove(os.path.join(ck2, "integrity.json"))  # the incompatibility, not the tamper
    shutil.rmtree(os.path.join(run_dir, "ckpt-000004"))
    man = json.load(open(mpath))
    docs = man["vars"]["lm_word_emb"]["shards"]
    for doctored, what in (([docs[0]], "cover"), ([docs[0], dict(docs[0])], "overlap")):
        man["vars"]["lm_word_emb"]["shards"] = doctored
        json.dump(man, open(mpath, "w"))
        with pytest.raises(tckpt.CheckpointMeshMismatchError, match=what) as ei:
            tckpt.TrainCheckpoint(run_dir).restore(lm["prog"], scope, compiled=compiled)
        assert "lm_word_emb" in str(ei.value)
