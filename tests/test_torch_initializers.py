"""The initializers of paddle_tpu_torch against paddle_tpu.

* Every initializer appends the JAX package's startup ops, op for op.
* NumpyArrayInitializer and BilinearInitializer (``assign_value``) give
  the JAX package's values bit for bit.
* TruncatedNormal and MSRA draw other bits than jax.random for the same
  seed, so they are held by distribution over 60,000 draws, each
  statistic within 5 standard errors of its exact value: a normal
  truncated at two standard deviations (every draw within loc +- 2
  scale; mean loc; standard deviation 0.87962 scale; 71.53% of the
  draws within one scale), and He's uniform (limit sqrt(6 / fan_in))
  and normal (std sqrt(2 / fan_in)).
"""
import math

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.scope import to_numpy

SHAPE = [200, 300]  # fan_in 200
INITS = {
    "truncated_normal": lambda I: I.TruncatedNormal(loc=0.5, scale=2.0, seed=7),
    "msra_uniform": lambda I: I.MSRA(uniform=True),
    "msra_normal": lambda I: I.MSRA(uniform=False, fan_in=50),
    "numpy_array": lambda I: I.NumpyArrayInitializer(
        np.arange(np.prod(SHAPE), dtype="float32").reshape(SHAPE) / 7.0),
    "bilinear": lambda I: I.Bilinear(),
}
SHAPES = {"bilinear": [3, 2, 5, 4]}


def _startup(fluid, name):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        w = fluid.layers.create_parameter(
            SHAPES.get(name, SHAPE), "float32",
            attr=fluid.ParamAttr(name="w", initializer=INITS[name](fluid.initializer)))
    return startup, w


def _port_value(name):
    startup, _ = _startup(tfluid, name)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    return to_numpy(scope.get("w")).astype(np.float64)


@pytest.mark.parametrize("name", sorted(INITS))
def test_startup_desc_parity(name):
    (js, _), (ts, _) = _startup(jfluid, name), _startup(tfluid, name)
    assert ts.to_json() == js.to_json()


@pytest.mark.parametrize("name", ["numpy_array", "bilinear"])
def test_assigned_values_match_jax(name):
    js, _ = _startup(jfluid, name)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    want = np.asarray(scope.get("w"))
    got = _port_value(name)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.float64))


def _within(stat, exact, stderr):
    assert abs(stat - exact) <= 5 * stderr, (stat, exact, stderr)


def test_truncated_normal_distribution():
    v = _port_value("truncated_normal").ravel()
    loc, scale, n = 0.5, 2.0, v.size
    assert v.min() >= loc - 2 * scale and v.max() <= loc + 2 * scale
    std = 0.87962 * scale
    _within(v.mean(), loc, std / math.sqrt(n))
    _within(v.std(), std, std / math.sqrt(2 * n))  # the normal's stderr; truncation lowers it
    inside = 0.7153
    _within(np.mean(np.abs(v - loc) <= scale), inside, math.sqrt(inside * (1 - inside) / n))
    # the JAX package's draw of the same op: the same law
    js, _ = _startup(jfluid, "truncated_normal")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(js)
    j = np.asarray(scope.get("w")).ravel().astype(np.float64)
    _within(v.mean() - j.mean(), 0.0, std * math.sqrt(2.0 / n))


def test_msra_distributions():
    u = _port_value("msra_uniform").ravel()
    limit = math.sqrt(6.0 / SHAPE[0])
    assert u.min() >= -limit and u.max() <= limit
    _within(u.std(), limit / math.sqrt(3), limit / math.sqrt(3) / math.sqrt(2 * u.size))
    g = _port_value("msra_normal").ravel()
    std = math.sqrt(2.0 / 50)
    _within(g.mean(), 0.0, std / math.sqrt(g.size))
    _within(g.std(), std, std / math.sqrt(2 * g.size))


def test_placement_helpers():
    assert tfluid.initializer.force_init_on_cpu() is False
    with tfluid.initializer.init_on_cpu():
        startup, _ = _startup(tfluid, "msra_uniform")
    assert [o.type for o in startup.global_block().ops] == ["uniform_random"]
    with pytest.raises(ValueError, match="4-D"):
        main, st = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, st):
            tfluid.layers.create_parameter([3, 3], "float32",
                                           attr=tfluid.ParamAttr(initializer=tfluid.initializer.Bilinear()))
