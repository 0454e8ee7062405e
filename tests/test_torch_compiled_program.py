"""``CompiledProgram`` of paddle_tpu_torch over gloo CPU ranks, against the
JAX package's compiled run on its 8-device CPU mesh.

The JAX package runs one process over a mesh and GSPMD partitions the
program; the port runs one rank a mesh device (``parallel/mesh.py``) and
every rank feeds the global batch.  Both start from the JAX package's
startup state (an .npz the ranks load).

* Data parallel (tests/test_parallel_executor.py:47-81's MLP, SGD, 5
  steps of 32 rows) over 2 and over 4 ranks: every rank's losses within
  rtol 1e-4, atol 1e-5 of the JAX package's ``with_data_parallel`` run (the
  JAX test's bar against its single-device run).  A per-row fetch comes
  back with the global batch's rows, a batch that does not divide ``dp``
  is a typed ``ValueError``, the plan's ``eager_ops`` name the collectives
  the step calls, and the steps after the first build nothing.
* Tensor parallel through ``DistributedStrategy.sharding_specs`` (a
  column-parallel fc weight on a ``{"dp": 2, "tp": 2}`` mesh, 4 ranks):
  the same bar; each rank holds its [16, 16] half of the [16, 32] weight.
* Batch statistics (tests/test_parallel_executor.py:138's model, 16 rows
  over 2 ranks): under the port's ``shard_map`` with ring 0 on ``dp``,
  ``sync_bn`` gives the full batch's loss within rtol 1e-5 of the JAX
  package's single-device run and the per-shard statistics differ from it;
  under a data-parallel ``CompiledProgram`` batch_norm normalises over the
  global batch, as GSPMD does in the JAX package: its losses over 3 SGD
  steps are the JAX package's compiled run's (rtol 1e-5), so the backward
  through the statistics' all_reduce is held too.
* In process: a compiled program at one rank is the plain executor's run
  (its plan and entry caches); dropout's mask on a rank's slice of the batch is that slice of the whole
  batch's mask at any element offset, and a tensor that is not
  batch-leading draws the whole run's mask; activation (``sp``) rules at
  one rank run the plain step (its answer, an activation report of
  nothing constrained) and a sequence-sharded feed is cut to the rank's
  window (a length its ranks do not divide is a typed ``ValueError``);
  over more than one rank a pipelined or mesh-table program raises naming
  its part.

Every rank has a time limit and the ports are free ones.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from torch_mesh_child import BN_STEPS, bn_batch, build_bn, build_mlp, launch_ranks, mlp_batches
from torch_parity_util import jax_startup_state


def _jax_mlp(seed, strategy=None):
    """The JAX package's compiled run of the MLP (and its startup state)."""
    prog, startup, loss = build_mlp(jfluid, seed)
    state = jax_startup_state(startup, prog)
    if strategy is None:
        compiled = jfluid.CompiledProgram(prog).with_data_parallel(loss_name=loss.name)
    else:
        compiled = jfluid.CompiledProgram(prog).with_strategy(strategy)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        for n, v in state.items():
            scope.set(n, v)
        losses = [float(np.asarray(exe.run(compiled, feed=f, fetch_list=[loss])[0]))
                  for f in mlp_batches()]
    return state, losses


def _jax_bn(steps=BN_STEPS):
    """The JAX package's BN model on the whole batch for ``steps`` SGD steps:
    the single-device run and the data-parallel compiled run (GSPMD's
    global program) from one startup state."""
    prog, startup, loss = build_bn(jfluid, False)
    state = jax_startup_state(startup, prog)
    out = {}
    for key, target in (("full", prog),
                        ("compiled_dp", jfluid.CompiledProgram(prog).with_data_parallel(
                            loss_name=loss.name))):
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        with jfluid.scope_guard(scope):
            for n, v in state.items():
                scope.set(n, v)
            out[key] = [float(np.asarray(exe.run(target, feed=bn_batch(),
                                                 fetch_list=[loss])[0]))
                        for _ in range(steps)]
    return state, out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two launches: 2 ranks (data parallel, batch statistics) and 4 ranks
    (data parallel, tensor parallel through sharding_specs)."""
    d = tmp_path_factory.mktemp("compiled")
    dp_state, dp_losses = _jax_mlp(5)
    np.savez(d / "dp_state.npz", **dp_state)
    strat = jfluid.DistributedStrategy()
    strat.mesh_axes = {"dp": 2, "tp": 2}
    prog, _, _ = build_mlp(jfluid, 9)
    wname = [p.name for p in prog.all_parameters() if tuple(p.shape) == (16, 32)][0]
    strat.sharding_specs = {wname: (None, "tp")}
    tp_state, tp_losses = _jax_mlp(9, strat)
    np.savez(d / "tp_state.npz", **tp_state)
    bn_state, bn_jax = _jax_bn()
    np.savez(d / "bn_state.npz", **bn_state)
    two = launch_ranks(str(d / "two"), 2, [
        ["dp_mlp", {"state": str(d / "dp_state.npz")}],
        ["bn", {"state_sync": str(d / "bn_state.npz"), "state_local": str(d / "bn_state.npz"),
                "state_dp": str(d / "bn_state.npz")}]])
    four = launch_ranks(str(d / "four"), 4, [
        ["dp_mlp", {"state": str(d / "dp_state.npz")}],
        ["tp_specs", {"state": str(d / "tp_state.npz")}]])
    return {"two": two, "four": four, "dp_losses": dp_losses, "tp_losses": tp_losses,
            "bn_jax": bn_jax}


@pytest.mark.parametrize("ranks", ["two", "four"])
def test_data_parallel_loss_parity(runs, ranks):
    want = runs["dp_losses"]
    assert want[0] > want[-1]  # actually learning
    n = {"two": 2, "four": 4}[ranks]
    for r, res in enumerate(runs[ranks]["dp_mlp"]):
        np.testing.assert_allclose(res["losses"], want, rtol=1e-4, atol=1e-5)
        # every rank gets the global result
        assert res["losses"] == runs[ranks]["dp_mlp"][0]["losses"]
        assert res["rows_shape"] == [32, 1]
        assert "does not divide" in res["uneven"] and "%d ranks" % n in res["uneven"]
        assert {"c_allreduce_sum", "c_allgather", "c_broadcast"} <= set(res["eager_ops"])
        assert res["misses_after_first"] == 0  # the plan is built once


def test_tensor_parallel_sharding_specs(runs):
    for res in runs["four"]["tp_specs"]:
        np.testing.assert_allclose(res["losses"], runs["tp_losses"], rtol=1e-4, atol=1e-5)
        assert res["w_shard"] == [16, 16]


def test_batch_norm_under_data_parallel_and_sync(runs):
    jax_runs = runs["bn_jax"]
    full = jax_runs["full"][0]
    # the JAX package's compiled data-parallel run is the whole batch's
    np.testing.assert_allclose(jax_runs["compiled_dp"], jax_runs["full"], rtol=1e-5)
    for res in runs["two"]["bn"]:
        # sync BN == full-batch statistics
        np.testing.assert_allclose(res["sync"], full, rtol=1e-5)
        # per-shard statistics differ
        assert abs(res["local"] - full) > 1e-6
        # the compiled data-parallel step normalises over the global batch,
        # and its backward (through the statistics' all_reduce) and the dp
        # average of the gradients give the JAX package's later steps
        np.testing.assert_allclose(res["compiled_dp"], jax_runs["compiled_dp"], rtol=1e-5)
        assert res["compiled_dp"][-1] < res["compiled_dp"][0]


# ---------------------------------------------------------------------------
# in process (one rank)
# ---------------------------------------------------------------------------
def test_one_rank_compiled_program_is_the_plain_run():
    prog, startup, loss = build_mlp(tfluid, seed=5)
    exe = tfluid.Executor(tfluid.CPUPlace())
    plain, compiled = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=plain)
    exe.run(startup, scope=compiled)
    for n in plain.vars:
        compiled.vars[n] = plain.vars[n].clone()
    cp = tfluid.CompiledProgram(prog).with_data_parallel(loss_name=loss.name)
    for f in mlp_batches(3):
        want = exe.run(prog, feed=f, fetch_list=[loss], scope=plain)[0]
        got = exe.run(cp, feed=f, fetch_list=[loss], scope=compiled)[0]
        np.testing.assert_array_equal(got, want)
    # the one-rank compiled run is the plain executor's: its plan and entry
    # are the plain run's, found in the executor's caches
    stats = dict(exe._cache_stats)
    exe.run(cp, feed=mlp_batches(1)[0], fetch_list=[loss], scope=compiled)
    assert exe._cache_stats["plan_hits"] == stats["plan_hits"] + 1
    assert exe._cache_stats["hits"] == stats["hits"] + 1
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=loss.name, main_program=prog,
                                 scope=compiled)
    assert np.isfinite(pe.run([loss], feed=mlp_batches(1)[0])[0]).all()


@pytest.mark.parametrize("width", [10, 25, 26, 27])
def test_dropout_mask_of_a_batch_slice_is_the_global_masks_slice(width):
    """Each of 4 ranks' 2 rows of an [8, 6, width] batch: the slice of the
    whole batch's mask, at element offsets 12 w i (1, 2 and 3 past a
    multiple of 4 at the odd widths' slices).  A tensor whose leading dim is
    not the rank's rows (a replicated one) draws the whole run's mask."""
    from paddle_tpu_torch.kernels import dropout as kd

    x = torch.randn(8, 6, width)
    full_out, full_mask = kd.dropout_train(x, 0.3, 11, True)
    w = torch.randn(5, width)
    w_out, w_mask = kd.dropout_train(w, 0.3, 12, True)
    for index in range(4):
        with kd.batch_slice(index, 4, rows=(2,)):
            out, mask = kd.dropout_train(x[2 * index:2 * index + 2], 0.3, 11, True)
            rep_out, rep_mask = kd.dropout_train(w, 0.3, 12, True)
        torch.testing.assert_close(out, full_out[2 * index:2 * index + 2], rtol=0, atol=0)
        torch.testing.assert_close(mask, full_mask[2 * index:2 * index + 2], rtol=0, atol=0)
        torch.testing.assert_close(rep_out, w_out, rtol=0, atol=0)
        torch.testing.assert_close(rep_mask, w_mask, rtol=0, atol=0)
    # the reviewer's batch of 6 over 2 ranks at width 25: offset 75
    odd = torch.randn(6, 25)
    o_out, o_mask = kd.dropout_train(odd, 0.3, 13, False)
    with kd.batch_slice(1, 2, rows=(3,)):
        s_out, s_mask = kd.dropout_train(odd[3:], 0.3, 13, False)
    torch.testing.assert_close(s_out, o_out[3:], rtol=0, atol=0)
    torch.testing.assert_close(s_mask, o_mask[3:], rtol=0, atol=0)


@pytest.mark.parametrize("attr,part", [("_pipeline_plan", "A10 part 3"),
                                       ("_mesh_tables", "A10 part 4")])
def test_sharded_step_refuses_pipelines_and_mesh_tables(attr, part):
    from paddle_tpu_torch.parallel import mesh as tmesh

    prog, startup, loss = build_mlp(tfluid, seed=5)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    setattr(prog, attr, {"marker": True})
    cp = tfluid.CompiledProgram(prog).with_data_parallel(loss_name=loss.name)
    # one rank: the plain run's refusal; two ranks (seen from rank 0): the
    # sharded step's, before any collective
    with pytest.raises(NotImplementedError, match=part):
        exe.run(cp, feed=mlp_batches(1)[0], fetch_list=[loss], scope=scope)
    cp._mesh = tmesh.Mesh({"dp": 2}, 0, groups={})
    with pytest.raises(NotImplementedError, match=part):
        exe.run(cp, feed=mlp_batches(1)[0], fetch_list=[loss], scope=scope)


def test_activation_rules_and_sequence_sharded_feeds_name_part_2():
    from paddle_tpu_torch import models
    from paddle_tpu_torch.sharding import canonical_rules

    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("src_ids", [16], dtype="int64")
        _, logits = models.transformer_lm(ids, None, vocab_size=64, d_model=16, n_layer=1,
                                          n_head=2, d_inner=32, seq_len=16, max_pos=32,
                                          fused_attention=True)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    sp = tfluid.CompiledProgram(prog).with_sharding_rules(
        canonical_rules("transformer_lm", "sp"), mesh_axes={"sp": 1})
    feed = {"src_ids": np.arange(32, dtype=np.int64).reshape(2, 16) % 64}
    got, = exe.run(sp, feed=feed, fetch_list=[logits], scope=scope)
    want, = exe.run(prog, feed=feed, fetch_list=[logits], scope=scope)
    np.testing.assert_array_equal(got, want)
    assert sp.activation_stats() == {"activation_bytes_unsharded": 0,
                                     "activation_bytes_per_device": 0, "n_constrained": 0}
    strat = tfluid.DistributedStrategy()
    strat.sharding_specs = {"src_ids": ("dp", "sp")}
    cp = tfluid.CompiledProgram(prog).with_strategy(strat)
    from paddle_tpu_torch.parallel import mesh as tmesh

    # a mesh with an sp axis of two ranks, seen from rank 1 (box math only)
    cp._mesh = tmesh.Mesh({"dp": 1, "sp": 2}, 1, groups={})
    ids = torch.arange(32, dtype=torch.int64).reshape(2, 16)
    assert torch.equal(cp._local_feed("src_ids", ids), ids[:, 8:])
    with pytest.raises(ValueError, match="does not divide"):
        cp._local_feed("src_ids", torch.ones(2, 15, dtype=torch.int64))
