"""ModelAverage, ExponentialMovingAverage and PipelineOptimizer of
paddle_tpu_torch against paddle_tpu (the non-pipeline cases of
tests/test_model_average_ema.py, run in both packages).

Both packages build the same program (a one-layer regression under SGD
with the average's ops appended), the port starts from the JAX
package's startup state, and both take the same steps.  Inside
``apply`` the weight is held to the JAX package's at rtol 1e-5 and to
the numpy formula the JAX test states (rtol 1e-5; 1e-4 for the
scheduled EMA, as there); after ``restore`` it is the trained weight
bit for bit.  The descs match op for op.

``apply`` keeps a copy of each trained weight: a captured step under
``apply`` copies the averaged weight into the tensor the scope held
before (``executor.py`` ``_replay``), and a backup that referred to that
tensor would come back as the average.  ``test_restore_survives_*``
writes that copy by hand, as the replay does.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.scope import to_numpy

STEPS = {"model_average": 4, "ema": 3, "ema_thres": 5, "model_average_window": 5}
MAKERS = {
    "model_average": lambda O: O.ModelAverage(0.15),
    "ema": lambda O: O.ExponentialMovingAverage(0.5),
    "ema_thres": lambda O: O.ExponentialMovingAverage(0.9, thres_steps=True),
    "model_average_window": lambda O: O.ModelAverage(average_window_rate=1.0,
                                                     min_average_window=2, max_average_window=2),
}
SEEDS = {"model_average": 0, "ema": 1, "ema_thres": 2, "model_average_window": 3}


def _build(fluid, case):
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 5
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(fluid.layers.fc(x, 1, bias_attr=False), y))
        fluid.optimizer.SGDOptimizer(0.1).minimize(loss)
        avg = MAKERS[case](fluid.optimizer)
        if case.startswith("ema"):
            avg.update()
    return prog, startup, loss, avg


def _expected(case, snaps):
    """The numpy formula of tests/test_model_average_ema.py for ``case``."""
    if case == "model_average":
        return np.mean(snaps, axis=0)
    if case == "model_average_window":  # windows of 2: sum_3 holds {3, 4}, sum_1 {5}
        return (snaps[2] + snaps[3] + snaps[4]) / 3.0
    ema, dpow = np.zeros_like(snaps[0]), 1.0
    for t, w in enumerate(snaps):
        decay = 0.5 if case == "ema" else min(0.9, (2.0 + t) / (11.0 + t))
        ema = decay * ema + (1 - decay) * w
        dpow *= decay
    return ema / (1 - dpow)


def _run_both(case):
    jp, js, jloss, javg = _build(jfluid, case)
    tp, ts, tloss, tavg = _build(tfluid, case)
    rng = np.random.RandomState(SEEDS[case])
    feed = {"x": rng.rand(8, 4).astype("float32"), "y": rng.rand(8, 1).astype("float32")}
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    wname = jp.all_parameters()[0].name
    with jfluid.scope_guard(jscope), tfluid.scope_guard(tscope):
        jexe.run(js)
        names = sorted(v.name for v in jp.list_vars() if v.persistable and not v.is_data)
        tfluid.io.set_params_from_numpy(tscope, {n: np.asarray(jscope.get(n)) for n in names},
                                        texe.device, program=tp)
        snaps = []
        for _ in range(STEPS[case]):
            jexe.run(jp, feed=feed, fetch_list=[jloss])
            texe.run(tp, feed=feed, fetch_list=[tloss])
            snaps.append(np.asarray(jscope.get(wname)))
            np.testing.assert_allclose(to_numpy(tscope.get(wname)), snaps[-1], rtol=1e-5)
        trained = tscope.get(wname).clone()
        with javg.apply(jexe):
            japplied = np.asarray(jscope.get(wname))
        with tavg.apply(texe):
            tapplied = to_numpy(tscope.get(wname))
        restored = tscope.get(wname)
    return (jp, js), (tp, ts), snaps, japplied, tapplied, trained, restored


@pytest.mark.parametrize("case", sorted(MAKERS))
def test_apply_restore_matches_jax(case):
    (jp, js), (tp, ts), snaps, japplied, tapplied, trained, restored = _run_both(case)
    for a, b in ((jp, tp), (js, ts)):
        assert [o.type for o in b.global_block().ops] == [o.type for o in a.global_block().ops]
        for ja, ta in zip(a.global_block().ops, b.global_block().ops):
            assert (ta.inputs, ta.outputs, ta.attrs) == (ja.inputs, ja.outputs, ja.attrs), ja.type
    np.testing.assert_allclose(tapplied, japplied, rtol=1e-5)
    np.testing.assert_allclose(tapplied, _expected(case, snaps),
                               rtol=1e-4 if case == "ema_thres" else 1e-5)
    assert not np.allclose(tapplied, to_numpy(trained))
    assert np.array_equal(to_numpy(restored), to_numpy(trained))


@pytest.mark.parametrize("case", ["model_average", "ema"])
def test_restore_survives_a_write_into_the_old_tensor(case):
    """Under ``apply``, write the averaged weight into the tensor the
    scope held before (what a captured step's replay does to its
    buffer); ``restore`` still gives back the trained weight."""
    prog, startup, loss, avg = _build(tfluid, case)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    rng = np.random.RandomState(9)
    feed = {"x": rng.rand(8, 4).astype("float32"), "y": rng.rand(8, 1).astype("float32")}
    wname = prog.all_parameters()[0].name
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):
            exe.run(prog, feed=feed, fetch_list=[loss])
        old = scope.get(wname)
        trained = old.clone()
        with avg.apply(exe):
            old.copy_(scope.get(wname))  # the replay's copy into its buffer
            assert not np.array_equal(to_numpy(old), to_numpy(trained))
        assert np.array_equal(to_numpy(scope.get(wname)), to_numpy(trained))


def test_apply_without_restore_keeps_the_average():
    prog, startup, loss, avg = _build(tfluid, "ema")
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    feed = {"x": np.ones((2, 4), "float32"), "y": np.zeros((2, 1), "float32")}
    wname = prog.all_parameters()[0].name
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(prog, feed=feed, fetch_list=[loss])
        trained = to_numpy(scope.get(wname))
        with avg.apply(exe, need_restore=False):
            applied = to_numpy(scope.get(wname))
        np.testing.assert_array_equal(to_numpy(scope.get(wname)), applied)
        avg.restore(exe)
        np.testing.assert_array_equal(to_numpy(scope.get(wname)), trained)


def _pipeline(fluid, cut=False):
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 3)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(fluid.layers.fc(h, 1), y))
        opt = fluid.optimizer.PipelineOptimizer(fluid.optimizer.SGDOptimizer(0.1),
                                                cut_list=[h] if cut else None, num_microbatches=4)
        opt.minimize(loss)
    return prog, startup, loss


def test_pipeline_optimizer_surface():
    jp, js, jloss = _pipeline(jfluid)
    tp, ts, tloss = _pipeline(tfluid)
    assert tp._pipeline_config == jp._pipeline_config == {"num_microbatches": 4, "cut_vars": []}
    assert tp.to_json() == jp.to_json() and ts.to_json() == js.to_json()
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe.run(ts)
        l, = exe.run(tp, feed={"x": np.ones((4, 4), "float32"), "y": np.ones((4, 1), "float32")},
                     fetch_list=[tloss])
    assert np.isfinite(l).all()


def test_pipeline_optimizer_with_stages_is_refused():
    with pytest.raises(NotImplementedError, match="A10"):
        _pipeline(tfluid, cut=True)
