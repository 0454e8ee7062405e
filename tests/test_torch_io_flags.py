"""io.save_program and the flags of paddle_tpu_torch against paddle_tpu.

* A directory that ``paddle_tpu.io.save_program`` wrote after one Lamb
  step (the whole train program and every persistable) loads with the
  port's ``load_inference_model`` and trains two more steps whose losses
  are the JAX package's at rtol 1e-5; the port's own directory loads in
  the JAX package, which takes the same two steps at rtol 1e-5.  Both
  packages write the same program JSON.
* ``get_flags``/``set_flags`` resolve as the JAX package's do (override,
  then environment, then default) and mirror into ``os.environ``.
* With ``FLAGS_check_nan_inf`` on, a run whose feed holds an inf raises
  naming the fetches and written state it reached, on the cached
  executor's path and on the eager one; a clean run passes; with the
  flag off the inf goes through unchecked.
"""
import os

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags as tflags


def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 6
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [12])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 24, act="tanh")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(fluid.layers.fc(h, 4), y))
        fluid.optimizer.LambOptimizer(0.01).minimize(loss)
    return main, startup, loss


def _feeds(n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(6, 12).astype("float32"),
             "y": rng.randint(0, 4, (6, 1)).astype("int64")} for _ in range(n)]


def test_jax_save_program_trains_in_the_port(tmp_path):
    feeds = _feeds(3)
    jm, js, jloss = _mlp(jfluid)
    tm, _, _ = _mlp(tfluid)
    assert tm.to_json() == jm.to_json()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        jexe.run(jm, feed=feeds[0], fetch_list=[jloss])
        jfluid.io.save_program(str(tmp_path), ["x", "y"], [jloss], jexe, jm)
        want = [float(np.asarray(jexe.run(jm, feed=f, fetch_list=[jloss])[0])) for f in feeds[1:]]
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    prog, feed_names, fetch_vars = tfluid.io.load_inference_model(str(tmp_path), texe,
                                                                  scope=tscope)
    assert feed_names == ["x", "y"] and [v.name for v in fetch_vars] == [jloss.name]
    assert "lamb" in {op.type for op in prog.global_block().ops}
    got = [float(texe.run(prog, feed=f, fetch_list=fetch_vars, scope=tscope)[0])
           for f in feeds[1:]]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_port_save_program_loads_in_jax(tmp_path):
    feeds = _feeds(3, seed=2)
    tm, ts, tloss = _mlp(tfluid)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    texe.run(tm, feed=feeds[0], fetch_list=[tloss], scope=tscope)
    fetched = tfluid.io.save_program(str(tmp_path), ["x", "y"], [tloss], texe, tm, scope=tscope)
    assert fetched == [tloss.name]
    saved = {n for n in os.listdir(tmp_path) if n.endswith(".npy")}
    assert len(saved) == len([v for v in tm.list_vars() if v.persistable and not v.is_data])
    want = [float(texe.run(tm, feed=f, fetch_list=[tloss], scope=tscope)[0]) for f in feeds[1:]]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        prog, feed_names, fetch_vars = jfluid.io.load_inference_model(str(tmp_path), jexe)
        got = [float(np.asarray(jexe.run(prog, feed=f, fetch_list=fetch_vars)[0]))
               for f in feeds[1:]]
    assert feed_names == ["x", "y"]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.fixture
def clean_flags(monkeypatch):
    """Flags and their environment as a fresh process has them; restored after."""
    for key in ("FLAGS_check_nan_inf", "FLAGS_rpc_deadline"):
        monkeypatch.setenv(key, "")
        monkeypatch.delenv(key)
    monkeypatch.setattr(tflags, "_OVERRIDES", {})


def test_get_and_set_flags(clean_flags, monkeypatch):
    assert tfluid.get_flags("check_nan_inf") == {"FLAGS_check_nan_inf": False}
    monkeypatch.setenv("FLAGS_rpc_deadline", "5000")
    got = tfluid.get_flags(["FLAGS_rpc_deadline", "FLAGS_check_nan_inf"])
    assert got == jfluid.get_flags(["FLAGS_rpc_deadline", "FLAGS_check_nan_inf"])
    assert got == {"FLAGS_rpc_deadline": 5000, "FLAGS_check_nan_inf": False}
    tfluid.set_flags({"check_nan_inf": True, "FLAGS_rpc_deadline": 7})
    assert os.environ["FLAGS_check_nan_inf"] == "1" and os.environ["FLAGS_rpc_deadline"] == "7"
    assert tfluid.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"] is True
    assert set(tflags._REGISTRY) == set(jfluid.flags._REGISTRY)
    with pytest.raises(KeyError, match="unknown flag"):
        tfluid.get_flags("FLAGS_no_such_flag")
    with pytest.raises(KeyError, match="unknown flag"):
        tfluid.set_flags({"no_such_flag": 1})


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "eager"])
def test_check_nan_inf(clean_flags, cached):
    main, startup, loss = _mlp(tfluid)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    clean = _feeds(1)[0]
    bad = dict(clean, x=clean["x"].copy())
    bad["x"][2, 3] = np.inf

    def run(feed):
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope, use_program_cache=cached)

    run(bad)  # the flag is off: nothing is checked, though the step wrote nan
    assert not np.isfinite(tfluid.scope.to_numpy(scope.get("fc_0.w_0"))).all()
    exe.run(startup, scope=scope)
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    run(clean)
    with pytest.raises(RuntimeError, match="nan/inf detected") as err:
        run(bad)
    # tanh saturates at inf, so the loss stays finite; its gradient
    # (inf * 0) is nan, and so is every weight the update wrote
    assert loss.name not in str(err.value)
    assert "fc_0.w_0" in str(err.value) and "fc_0.w_0_moment1_0" in str(err.value)
