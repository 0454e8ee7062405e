"""Learning-rate schedules, gradient clips and weight decay of
paddle_tpu_torch against paddle_tpu.

* Each of the eight schedules of ``layers/learning_rate_scheduler.py``
  builds the JAX package's ops and, run for 12 steps from the same
  startup, gives the same learning rate at each step (rtol 1e-6: both
  compute it in fp32 from the same ops); noam's also matches its formula
  in float64.
* Each clip and regularizer, on a small two-layer classifier, builds the
  JAX package's program and takes one SGD, Momentum and Adam step from
  the JAX package's initial state: the loss within rtol 1e-5 and every
  parameter after the step within atol 1e-6, rtol 1e-5 (the two
  frameworks sum in different orders).
* ``GradientClipByGlobalNorm`` appends the same ops in both packages,
  but the JAX package cannot build them: its elementwise kernel aligns
  only Y to X, and the global norm (0-d, from ``reduce_sum`` over all
  dims) meets the [1] clip constant as X, so its shape inference raises.
  The port aligns the smaller operand either way, as the reference's
  elementwise_op_function.h does.  Its step is held to the JAX
  package's unclipped gradients, clipped by the formula in float64
  numpy and applied by the optimizer's formula, within the same limits.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import scope as tscope

STEPS = 12
SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 5),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 4, 0.3),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(0.1, 4, 0.3, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 2, 0.5),
    "polynomial": lambda L: L.polynomial_decay(0.1, 8, end_learning_rate=0.01, power=2.0),
    "piecewise": lambda L: L.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 6),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 5, 0.0, 0.1),
    "linear_warmup_of_decay": lambda L: L.linear_lr_warmup(L.exponential_decay(0.1, 3, 0.5), 4,
                                                          0.01, 0.1),
}


def _schedule_program(fluid, make):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        lr = make(fluid.layers)
    return main, startup, lr


def _run_schedule(fluid, make, scope_guard=None):
    main, startup, lr = _schedule_program(fluid, make)
    if fluid is jfluid:
        exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
        with jfluid.scope_guard(scope):
            exe.run(startup)
            return main, startup, [float(np.asarray(exe.run(main, fetch_list=[lr])[0]).reshape(()))
                                   for _ in range(STEPS)]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, startup, [float(np.asarray(exe.run(main, fetch_list=[lr], scope=scope)[0]).reshape(()))
                           for _ in range(STEPS)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax(name):
    jm, js, jlr = _run_schedule(jfluid, SCHEDULES[name])
    tm, ts, tlr = _run_schedule(tfluid, SCHEDULES[name])
    assert tm.to_json() == jm.to_json() and ts.to_json() == js.to_json()
    np.testing.assert_allclose(tlr, jlr, rtol=1e-6, atol=0)
    assert len(set(tlr)) > 1 or name == "piecewise"
    if name == "noam":  # d_model^-0.5 * min(t^-0.5, t * warmup^-1.5), t = 1, 2, ...
        t = np.arange(1, STEPS + 1, dtype=np.float64)
        want = 64 ** -0.5 * np.minimum(t ** -0.5, t * 5 ** -1.5)
        np.testing.assert_allclose(tlr, want, rtol=1e-6)


def test_schedule_counter_is_state():
    """The step counter is a persistable the step writes in place: a
    second scope starts its own count, and the counter survives in the
    scope between runs."""
    main, startup, lr = _schedule_program(tfluid, lambda L: L.noam_decay(64, 5))
    counter = [v for v in main.list_vars() if v.name.startswith("@LR_DECAY_COUNTER@")]
    assert len(counter) == 1 and counter[0].persistable
    exe = tfluid.Executor(tfluid.CPUPlace())
    a, b = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=a)
    exe.run(startup, scope=b)
    for _ in range(3):
        exe.run(main, fetch_list=[lr], scope=a)
    exe.run(main, fetch_list=[lr], scope=b)
    assert float(tscope.to_numpy(a.vars[counter[0].name])[0]) == 3.0
    assert float(tscope.to_numpy(b.vars[counter[0].name])[0]) == 1.0


# ---------------------------------------------------------------------------
# clips and regularizers over one optimizer step
# ---------------------------------------------------------------------------
def _clip_and_decay(fluid, case):
    """(per-parameter gradient clip, per-parameter regularizer,
    optimizer-level regularization) of a case."""
    clip, reg = fluid.clip, fluid.regularizer
    return {
        "none": (None, None, None),
        "value": (clip.GradientClipByValue(0.01), None, None),
        "value_min": (clip.GradientClipByValue(0.02, min=-0.005), None, None),
        "norm": (clip.GradientClipByNorm(0.05), None, None),
        "global_norm": (clip.GradientClipByGlobalNorm(0.05), None, None),
        "error_clip": (clip.ErrorClipByValue(1.0), None, None),
        "l2": (None, None, reg.L2Decay(0.1)),
        "l1": (None, None, reg.L1Decay(0.1)),
        "l2_param": (None, reg.L2Decay(0.3), None),
        "l1_and_global_norm": (clip.GradientClipByGlobalNorm(0.05), reg.L1Decay(0.2), None),
    }[case]


def _classifier(fluid, case, opt):
    c, r, reg = _clip_and_decay(fluid, case)
    if isinstance(c, fluid.clip.ErrorClipByValue):
        c = None  # an error clip appends no op to the optimizer's pass
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [6])
        y = fluid.layers.data("y", [1], dtype="int64")
        attrs = [fluid.ParamAttr(name=n, gradient_clip=c, regularizer=r)
                 for n in ("w0", "b0", "w1", "b1")]
        h = fluid.layers.fc(x, 8, act="tanh", param_attr=attrs[0], bias_attr=attrs[1])
        logits = fluid.layers.fc(h, 3, param_attr=attrs[2], bias_attr=attrs[3])
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        optimizer = {"sgd": lambda: fluid.optimizer.SGDOptimizer(0.5, regularization=reg),
                     "momentum": lambda: fluid.optimizer.MomentumOptimizer(0.5, 0.9, regularization=reg),
                     "adam": lambda: fluid.optimizer.AdamOptimizer(0.05, regularization=reg)}[opt]()
        optimizer.minimize(loss)
    return main, startup, loss


CASES = ["value", "value_min", "norm", "error_clip", "l2", "l1", "l2_param"]
OP_TYPES = {"value": {"clip"}, "value_min": {"clip"}, "norm": {"clip_by_norm"},
            "l2": {"scale"}, "l1": {"sign", "scale"}, "l2_param": {"scale"},
            "global_norm": {"square", "reduce_sum", "sum", "sqrt", "fill_constant",
                            "elementwise_max", "elementwise_div", "elementwise_mul"},
            "l1_and_global_norm": {"sign", "sqrt", "elementwise_max"}}
FEED_RNG = 1


def _feed():
    rng = np.random.RandomState(FEED_RNG)
    return {"x": rng.randn(16, 6).astype("float32"), "y": rng.randint(0, 3, (16, 1)).astype("int64")}


def _jax_start(case, opt):
    jm, js, jl = _classifier(jfluid, case, opt)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = sorted(v.name for v in jm.list_vars() if v.persistable and not v.is_data)
    return jm, jl, jexe, jscope, names


def _port_step(case, opt, jscope, names):
    tm, ts, tl = _classifier(tfluid, case, opt)
    texe, tsc = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.set_params_from_numpy(tsc, {n: np.asarray(jscope.get(n)) for n in names},
                                    texe.device, program=tm)
    tloss, = texe.run(tm, feed=_feed(), fetch_list=[tl], scope=tsc)
    return tm, ts, float(tloss), tsc


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("case", CASES)
def test_clip_and_regularizer_step_matches_jax(case, opt):
    jm, jl, jexe, jscope, names = _jax_start(case, opt)
    _, js, _ = _classifier(jfluid, case, opt)
    tm, ts, tloss, tsc = _port_step(case, opt, jscope, names)
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    assert OP_TYPES.get(case, set()) <= {op.type for op in tm.global_block().ops}
    w_before = np.asarray(jscope.get("w0")).copy()
    with jfluid.scope_guard(jscope):
        jloss, = jexe.run(jm, feed=_feed(), fetch_list=[jl])
    np.testing.assert_allclose(tloss, float(np.asarray(jloss)), rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.to_numpy(tsc.get(n)).reshape(np.shape(jscope.get(n))),
                                   np.asarray(jscope.get(n)), atol=1e-6, rtol=1e-5, err_msg=n)
    assert not np.array_equal(tscope.to_numpy(tsc.get("w0")), w_before)  # the step moved it


def _numpy_step(opt, params, grads, state):
    """One optimizer step in float64 (the update ops' formulas:
    sgd p -= lr g; momentum v = mu v + g, p -= lr v; adam with the beta
    powers at their first step)."""
    out = {}
    for n, p in params.items():
        g = grads[n]
        if opt == "sgd":
            out[n] = p - 0.5 * g
        elif opt == "momentum":
            out[n] = p - 0.5 * (0.9 * state.get(n, 0.0) + g)
        else:
            m, v = 0.1 * g, 0.001 * g * g
            lr_t = 0.05 * np.sqrt(1 - 0.999) / (1 - 0.9)
            out[n] = p - lr_t * m / (np.sqrt(v) + 1e-8)
    return out


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("case", ["global_norm", "l1_and_global_norm"])
def test_global_norm_clip_step(case, opt):
    with pytest.raises(ValueError, match="elementwise_max"):
        _classifier(jfluid, case, opt)  # the JAX package's shape inference refuses it
    jm, jl, jexe, jscope, names = _jax_start("none", opt)
    tm, _, tloss, tsc = _port_step(case, opt, jscope, names)
    assert OP_TYPES[case] <= {op.type for op in tm.global_block().ops}
    # the step's ops: one reduction a gradient, one sum, one scale factor
    ops = [op.type for op in tm.global_block().ops]
    assert ops.count("reduce_sum") == ops.count("elementwise_mul") == 4
    assert ops.count("elementwise_max") == ops.count("elementwise_div") == 1
    params = {n: np.asarray(jscope.get(n)).astype(np.float64) for n in ("w0", "b0", "w1", "b1")}
    with jfluid.scope_guard(jscope):
        res = jexe.run(jm, feed=_feed(), fetch_list=[jl] + [n + "@GRAD" for n in params])
    np.testing.assert_allclose(tloss, float(np.asarray(res[0])), rtol=1e-5)
    grads = {n: np.asarray(g).astype(np.float64) for n, g in zip(params, res[1:])}
    norm = np.sqrt(sum((g * g).sum() for g in grads.values()))
    assert norm > 0.05  # the clip binds
    grads = {n: g * 0.05 / max(norm, 0.05) for n, g in grads.items()}
    if case == "l1_and_global_norm":  # decay after the clip, as append_regularization_ops runs
        grads = {n: g + 0.2 * np.sign(params[n]) for n, g in grads.items()}
    want = _numpy_step(opt, params, grads, {})
    for n, w in want.items():
        np.testing.assert_allclose(tscope.to_numpy(tsc.get(n)).reshape(w.shape), w,
                                   atol=1e-6, rtol=1e-5, err_msg=n)


def test_per_parameter_learning_rate_emits_scale():
    """A ParamAttr learning rate multiplies the global rate with a scale
    op, as the JAX optimizer does, and the step follows it."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [4])
            h = fluid.layers.fc(x, 2, param_attr=fluid.ParamAttr(name="w", learning_rate=0.25),
                                bias_attr=fluid.ParamAttr(name="b"))
            loss = fluid.layers.mean(h)
            fluid.optimizer.SGDOptimizer(0.5).minimize(loss)
        return main, startup

    jm, js = build(jfluid)
    tm, ts = build(tfluid)
    assert tm.to_json() == jm.to_json()
    scales = [op for op in tm.global_block().ops if op.type == "scale"]
    assert len(scales) == 1 and scales[0].attr("scale") == 0.25
    exe, sc = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=sc)
    w0 = tscope.to_numpy(sc.get("w")).copy()
    b0 = tscope.to_numpy(sc.get("b")).copy()
    exe.run(tm, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[], scope=sc)
    # d mean / dw = mean over rows of x / 2 outputs = 0.5 everywhere; db = 0.5
    np.testing.assert_allclose(tscope.to_numpy(sc.get("w")), w0 - 0.5 * 0.25 * 0.5, rtol=1e-6)
    np.testing.assert_allclose(tscope.to_numpy(sc.get("b")), b0 - 0.5 * 0.5, rtol=1e-6)


def test_fc_over_several_inputs_emits_sum():
    """fc over a list of inputs: one mul each, a sum, then the bias, as
    the JAX fc builds it; and it runs as the JAX package's does."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            a = fluid.layers.data("a", [3])
            b = fluid.layers.data("b", [5])
            out = fluid.layers.fc([a, b], 4, act="relu")
        return main, startup, out

    jm, js, jo = build(jfluid)
    tm, ts, to = build(tfluid)
    assert tm.to_json() == jm.to_json() and ts.to_json() == js.to_json()
    assert [op.type for op in tm.global_block().ops] == ["mul", "mul", "sum", "elementwise_add", "relu"]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = sorted(v.name for v in jm.list_vars() if v.persistable and not v.is_data)
    texe, tsc = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.set_params_from_numpy(tsc, {n: np.asarray(jscope.get(n)) for n in names}, texe.device,
                                    program=tm)
    rng = np.random.RandomState(2)
    feed = {"a": rng.randn(5, 3).astype("float32"), "b": rng.randn(5, 5).astype("float32")}
    with jfluid.scope_guard(jscope):
        ref, = jexe.run(jm, feed=feed, fetch_list=[jo])
    got, = texe.run(tm, feed=feed, fetch_list=[to], scope=tsc)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=1e-5)
