"""Two faults of paddle_tpu_torch against paddle_tpu, repaired and held.

* A ``persistable`` flag set after a run: the flag decides what the
  executor's cached run plan reads from and writes back to the scope,
  and the plan key holds the program's version.  The setter bumps the
  version (as ``paddle_tpu/framework.py``'s does), so the next run
  analyses a new plan, the newly persistable var lands in the scope and
  ``save_persistables`` writes it.  The card half (a fresh captured
  entry) is in ``test_torch_cuda.py``.
* Names that scripts written for the JAX package call: Adam's
  ``lazy_mode``, the top-level re-exports, the scope's variable views,
  the predictor config's switches and ``PaddlePredictor``,
  ``Variable.astype``, ``Block.has_var_local`` and ``op_role_guard``.
  Each is called as such a script calls it, in both packages where the
  result can be compared.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from torch_parity_util import assert_same_program


def _scale_program(fluid):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data("x", [4])
        y = fluid.layers.scale(x, scale=2.0)
    return prog, startup, y


def test_plan_reanalysis_on_persistable_toggle(tmp_path):
    """The reference test of the same name, on the port: build
    ``y = scale(x)``, run, mark ``y`` persistable, run again."""
    prog, startup, y = _scale_program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(startup, scope=scope)
    exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    assert scope.get(y.name) is None
    v0 = prog.version
    prog.global_block().var(y.name).persistable = True  # mark-before-save
    assert prog.version > v0
    m0 = exe.jit_cache_stats()["plan_misses"]
    exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    assert exe.jit_cache_stats()["plan_misses"] == m0 + 1  # re-analysed
    np.testing.assert_array_equal(scope.get(y.name).numpy(), 2.0 * feed["x"])
    tfluid.io.save_persistables(exe, str(tmp_path), prog, scope=scope)
    assert y.name + ".npy" in os.listdir(str(tmp_path))
    np.testing.assert_array_equal(np.load(str(tmp_path / (y.name + ".npy"))), 2.0 * feed["x"])


def test_persistable_same_value_keeps_the_plan():
    """Setting the value the flag already has is a no-op: no version bump,
    the cached plan is hit."""
    prog, startup, y = _scale_program(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    feed = {"x": np.ones((2, 4), np.float32)}
    exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    v0 = prog.version
    y.persistable = False
    assert prog.version == v0
    exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    stats = exe.jit_cache_stats()
    assert stats["plan_misses"] == 1 and stats["plan_hits"] == 1


def test_persistable_version_count_matches_the_jax_package():
    """The version counts in both packages agree through a build and a
    toggle (each var's first flag counts as the reference's does)."""
    versions = []
    for fluid in (jfluid, tfluid):
        prog, _, y = _scale_program(fluid)
        before = prog.version
        y.persistable = True
        y.persistable = True
        versions.append((before, prog.version))
    assert versions[0] == versions[1]


def test_adam_lazy_mode_is_accepted_and_ignored():
    """``AdamOptimizer(lazy_mode=True)`` builds the same program as
    without it, in both packages."""
    progs = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        for lazy in (False, True):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), fluid.unique_name.guard():
                x = fluid.layers.data("x", [4])
                loss = fluid.layers.mean(fluid.layers.fc(x, 3))
                fluid.optimizer.AdamOptimizer(1e-3, lazy_mode=lazy).minimize(loss)
            progs[name, lazy] = main
    assert_same_program(progs["port", True], progs["port", False])
    assert_same_program(progs["jax", True], progs["port", True])


@pytest.mark.parametrize("name", [
    "save_inference_model", "load_inference_model", "save_params", "load_params",
    "save_persistables", "load_persistables", "save_vars", "load_vars", "save_program"])
def test_io_reexports(name):
    assert getattr(tfluid, name) is getattr(tfluid.io, name)
    assert hasattr(jfluid, name)


def test_other_top_level_reexports():
    assert tfluid.ExponentialMovingAverage is tfluid.optimizer.ExponentialMovingAverage
    assert tfluid.learning_rate_decay is tfluid.layers.learning_rate_scheduler
    assert tfluid.learning_rate_decay.noam_decay is tfluid.layers.noam_decay
    attr = tfluid.WeightNormParamAttr(dim=1, name="wn_w")
    assert isinstance(attr, tfluid.ParamAttr) and attr.dim == 1 and attr.name == "wn_w"
    assert tfluid.LoDTensor is tfluid.Tensor and tfluid.LoDTensorArray is list
    assert isinstance(tfluid.CUDAPinnedPlace(), tfluid.CPUPlace)
    places = tfluid.cuda_pinned_places(3)
    assert len(places) == 3 and all(isinstance(p, tfluid.CPUPlace) for p in places)
    assert len(jfluid.cuda_pinned_places(3)) == 3


def test_weight_norm_param_attr_builds_the_same_fc():
    progs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [4])
            fluid.layers.fc(x, 3, param_attr=fluid.WeightNormParamAttr(dim=0, name="wn_w"))
        progs.append((main, startup))
    assert_same_program(progs[0][0], progs[1][0])
    assert_same_program(progs[0][1], progs[1][1])


def test_scope_variable_views_as_in_the_jax_package():
    """``find_var(n).get_tensor()`` with ``set`` and ``shape``, ``var``,
    ``new_scope``, ``drop_kids`` and ``local_var_names``, driven the same
    way in both packages."""
    value = np.arange(6, dtype=np.float32).reshape(2, 3)
    seen = []
    for fluid, kw in ((jfluid, {}), (tfluid, {"place": tfluid.CPUPlace()})):
        root = fluid.Scope()
        root.var("w").get_tensor().set(value, **kw)
        kid = root.new_scope()
        kid.var("k").get_tensor().set(value * 2, **kw)
        t = kid.find_var("w").get_tensor()  # found through the parent
        seen.append((np.array(t), t.shape(), kid.local_var_names(), root.local_var_names(),
                     np.array(kid.find_var("k").get_tensor()), kid.find_var("nope"),
                     len(root.kids)))
        root.drop_kids()
        assert root.kids == []
    for a, b in zip(*seen):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_scope_parent_and_device():
    """The first positional parameter is the parent; the device is
    keyword-only, and a kid inherits its parent's."""
    root = tfluid.Scope(device="cpu")
    kid = tfluid.Scope(root)
    assert kid.parent is root and str(kid.device) == "cpu"
    assert str(root.new_scope().device) == "cpu"
    root.set("a", np.ones(2, np.float32))
    assert kid.get("a") is root.get("a")  # read through the parent
    with pytest.raises(TypeError):
        tfluid.Scope(None, "cpu")
    assert tfluid.Scope().device is None
    view = tfluid.Scope().var("v").get_tensor()
    with pytest.raises(RuntimeError):
        view.set(np.ones(2, np.float32))  # no device and no place: the scope cannot guess


def test_scope_var_set_through_the_view_feeds_a_run():
    """A parameter set through the tensor view is what the executor reads."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [2])
        y = tfluid.layers.fc(x, 1, bias_attr=False, param_attr=tfluid.ParamAttr(name="w"))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    scope.find_var("w").get_tensor().set(np.array([[1.0], [2.0]], np.float32))
    out, = exe.run(main, feed={"x": np.ones((1, 2), np.float32)}, fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(out, [[3.0]])


def test_analysis_config_switches_and_paddle_predictor(tmp_path):
    """The two switches are no-ops in both packages; the predictor is a
    ``PaddlePredictor``."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [3])
        y = tfluid.layers.fc(x, 2)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), ["x"], [y], exe, main_program=main, scope=scope)
    outs = []
    for switch in (False, True):
        cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
        cfg.disable_gpu()
        cfg.switch_ir_optim(switch)
        cfg.switch_use_feed_fetch_ops(switch)
        pred = tfluid.inference.create_paddle_predictor(cfg)
        assert isinstance(pred, tfluid.inference.PaddlePredictor)
        outs.append(pred.run({"x": np.ones((2, 3), np.float32)})[0])
    np.testing.assert_array_equal(outs[0], outs[1])
    jcfg = jfluid.inference.AnalysisConfig(str(tmp_path))
    assert jcfg.switch_ir_optim(False) is None and jcfg.switch_use_feed_fetch_ops(False) is None
    assert issubclass(jfluid.inference.AnalysisPredictor, jfluid.inference.PaddlePredictor)


def test_variable_astype_emits_cast():
    progs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [4], dtype="int64")
            y = x.astype("float32")
        assert y.dtype == "float32"
        progs.append(main)
    assert [op.type for op in progs[1].global_block().ops] == ["cast"]
    assert_same_program(progs[0], progs[1])
    out, = tfluid.Executor(tfluid.CPUPlace()).run(
        progs[1], feed={"x": np.arange(4).reshape(1, 4)}, fetch_list=[y], scope=tfluid.Scope())
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, [[0.0, 1.0, 2.0, 3.0]])


def test_block_has_var_local():
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        gb = prog.global_block()
        gb.create_var(name="outer", shape=[1], dtype="float32")
        sub = prog._create_block()
        sub.create_var(name="inner", shape=[1], dtype="float32")
        assert sub.has_var("outer") and not sub.has_var_local("outer")
        assert sub.has_var_local("inner") and gb.has_var_local("outer")
        prog._rollback()


def test_op_role_guard():
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        assert prog._op_role == "forward"
        with fluid.framework.op_role_guard(prog, "backward"):
            assert prog._op_role == "backward"
            with fluid.framework.op_role_guard(prog, "optimize"):
                assert prog._op_role == "optimize"
            assert prog._op_role == "backward"
        assert prog._op_role == "forward"
