"""fluid.gradients() of paddle_tpu_torch against paddle_tpu: the four
cases of tests/test_backward_gradients.py (several targets summing into
an input, a caller's target gradient, chained targets, one target
through an fc), each built in both packages (the same grad-op descs)
and run on the same inputs from the JAX package's startup state.  The
gradients agree at rtol 1e-5, atol 1e-7 and match the closed forms that
file states at rtol 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid


def _two_targets(fluid, L):
    x = L.data("x", [3])
    t1 = L.mean(L.square(x))
    t2 = L.mean(L.scale(x, scale=3.0))
    return fluid.gradients([t1, t2], [x])


def _seeded(fluid, L):
    x = L.data("x", [5])
    seed = L.data("seed", [5])
    return fluid.gradients([L.square(x), L.mean(x)], [x], target_gradients=[seed, None])


def _chained(fluid, L):
    x = L.data("x", [2])
    t1 = L.mean(L.square(x))
    return fluid.gradients([t1, L.scale(t1, scale=2.0)], [x])


def _single(fluid, L):
    x = L.data("x", [4])
    return fluid.gradients(L.mean(L.fc(x, 3, name="gfc")), x)


def _feeds(case):
    rng = np.random.RandomState(0)
    if case == "two_targets":
        return {"x": np.arange(12, dtype=np.float32).reshape(4, 3) * 0.1}
    if case == "seeded":
        return {"x": rng.randn(2, 5).astype("float32"), "seed": rng.randn(2, 5).astype("float32")}
    if case == "chained":
        return {"x": np.linspace(-1, 1, 6, dtype=np.float32).reshape(3, 2)}
    return {"x": rng.randn(2, 4).astype("float32")}


def _closed_form(case, f):
    x = f["x"].astype(np.float64)
    n = x.size
    if case == "two_targets":
        return (2.0 * x + 3.0) / n
    if case == "seeded":
        return 2.0 * x * f["seed"] + 1.0 / n
    if case == "chained":
        return 3.0 * 2.0 * x / n
    return None


CASES = {"two_targets": _two_targets, "seeded": _seeded, "chained": _chained, "single": _single}


def _build(fluid, case):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        grads = CASES[case](fluid, fluid.layers)
    return main, startup, grads


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    jm, js, jg = _build(jfluid, case)
    tm, ts, tg = _build(tfluid, case)
    assert tm.to_json() == jm.to_json()
    assert [g.name for g in tg] == [g.name for g in jg]
    feed = _feeds(case)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
        want, = jexe.run(jm, feed=feed, fetch_list=jg)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    names = [v.name for v in jm.list_vars() if v.persistable]
    tfluid.io.set_params_from_numpy(tscope, {n: np.asarray(jscope.get(n)) for n in names},
                                    texe.device, program=tm)
    got, = texe.run(tm, feed=feed, fetch_list=tg, scope=tscope)
    assert got.shape == np.asarray(want).shape == feed["x"].shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    exact = _closed_form(case, feed)
    if exact is not None:
        np.testing.assert_allclose(got, exact, rtol=1e-5)


def test_gradients_checks_its_arguments():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [3])
        t = tfluid.layers.mean(tfluid.layers.square(x))
        with pytest.raises(ValueError, match="target_gradients length"):
            tfluid.gradients([t], [x], target_gradients=[None, None])
