"""The elementwise, unary, activation, ``reduce_sum``, comparison,
logical, clip and ``where`` ops of paddle_tpu_torch against paddle_tpu's,
and the Program JSON of Variable arithmetic.

Each op's kernel, and for a differentiable op its ``<type>_grad``
kernel (the generic vjp), runs in both packages on the same numpy
inputs made from a seed.  fp32 compares at rtol 1e-5, atol 1e-6 (the two
frameworks round transcendental functions and sums differently by an
ulp or so); integer and bool outputs compare exactly.  Inputs keep away
from the points where a function or its derivative jumps (0 for abs,
sign and the relu family, the clip bounds, ties of min and max), where
the two frameworks may pick different one-sided derivatives.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
RNG = np.random.RandomState(7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _run(op_type, inputs, attrs):
    """{slot: [(jax value, port value), ...]} of the op type's kernel in
    both packages on the same numpy inputs."""
    jin = {s: [jnp.asarray(a) for a in arrs] for s, arrs in inputs.items()}
    tin = {s: [torch.from_numpy(np.require(a, requirements="C")) for a in arrs]
           for s, arrs in inputs.items()}
    jout = jreg.get_kernel(op_type)(jin, dict(attrs))
    tout = treg.get_kernel(op_type)(tin, dict(attrs), CPU)
    res = {}
    for slot, jv in jout.items():
        jv = jv if isinstance(jv, (list, tuple)) else [jv]
        tv = tout[slot]
        tv = tv if isinstance(tv, (list, tuple)) else [tv]
        assert len(jv) == len(tv), slot
        res[slot] = [(_np(a), _np(b)) for a, b in zip(jv, tv)]
    return res


def _check(res):
    for slot, pairs in res.items():
        for j, t in pairs:
            assert j.shape == t.shape, (slot, j.shape, t.shape)
            if j.dtype.kind in "iub":
                assert t.dtype.kind == j.dtype.kind, (slot, t.dtype, j.dtype)
                np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=slot)
            else:
                assert t.dtype == j.dtype, (slot, t.dtype, j.dtype)
                np.testing.assert_allclose(t, j, err_msg=slot, **TOL)


def _check_grad(op_type, inputs, attrs):
    """``<op_type>_grad`` in both packages, with an upstream gradient of
    Out made from the seed."""
    opdef = treg.get_op(op_type)
    outs = _run(op_type, inputs, attrs)
    want = tuple(s for s in inputs if s not in opdef.no_grad_set)
    g_attrs = dict(attrs, __fwd_output_slots__=tuple(outs), __grad_input_slots__=want)
    g_inputs = dict(inputs)
    g_inputs["Out@GRAD"] = [np.asarray(RNG.randn(*outs["Out"][0][0].shape), dtype="float32")]
    res = _run(op_type + "_grad", g_inputs, g_attrs)
    assert set(res) == {s + "@GRAD" for s in want}, res.keys()
    _check(res)


def _f32(*shape, lo=-2.0, hi=2.0):
    return RNG.uniform(lo, hi, shape).astype("float32")


def _away(*shape, gap=0.1):
    """Uniform in [-2, 2] with no value within ``gap`` of 0."""
    x = _f32(*shape)
    return np.where(np.abs(x) < gap, np.sign(x + 1e-9) * gap + x, x).astype("float32")


# ---------------------------------------------------------------------------
# elementwise binary ops, with the reference's axis broadcast rule
# ---------------------------------------------------------------------------
EW_OPS = ["elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
          "elementwise_min", "elementwise_max", "elementwise_pow"]
BROADCASTS = {
    "same": ((3, 4, 5), (3, 4, 5), -1),
    "trailing": ((3, 4, 5), (5,), -1),
    "axis1": ((3, 4, 5), (4,), 1),
    "axis0_2d": ((3, 4, 5), (3, 4), 0),
    "scalar1": ((3, 4, 5), (1,), -1),
}


def _ew_inputs(op, xs, ys):
    if op == "elementwise_pow":
        return _f32(*xs, lo=0.5, hi=2.0), _f32(*ys, lo=-1.5, hi=1.5)
    if op == "elementwise_div":
        return _f32(*xs), _away(*ys, gap=0.5)
    return _f32(*xs), _f32(*ys)


@pytest.mark.parametrize("bcast", sorted(BROADCASTS))
@pytest.mark.parametrize("op", EW_OPS)
def test_elementwise_forward_and_grad(op, bcast):
    xs, ys, axis = BROADCASTS[bcast]
    x, y = _ew_inputs(op, xs, ys)
    inputs, attrs = {"X": [x], "Y": [y]}, {"axis": axis}
    _check(_run(op, inputs, attrs))
    _check_grad(op, inputs, attrs)


# ---------------------------------------------------------------------------
# unary math and activations
# ---------------------------------------------------------------------------
UNARY = {
    "sqrt": ({}, "pos"), "rsqrt": ({}, "pos"), "square": ({}, "any"), "exp": ({}, "any"),
    "log": ({}, "pos"), "abs": ({}, "away"), "ceil": ({}, "any"), "floor": ({}, "any"),
    "round": ({}, "any"), "reciprocal": ({}, "away"), "sign": ({}, "away"), "cos": ({}, "any"),
    "sin": ({}, "any"), "logsigmoid": ({}, "any"),
    "relu": ({}, "away"), "relu6": ({"threshold": 1.5}, "away"), "sigmoid": ({}, "any"),
    "tanh": ({}, "any"), "gelu": ({}, "any"), "gelu_tanh": ({"approximate": True}, "any"),
    "leaky_relu": ({"alpha": 0.1}, "away"), "elu": ({"alpha": 0.7}, "away"),
    "softplus": ({}, "any"), "softsign": ({}, "away"), "swish": ({"beta": 1.3}, "any"),
    "hard_sigmoid": ({"slope": 0.3, "offset": 0.4}, "any"),
    "hard_swish": ({"offset": 1.0, "threshold": 2.5, "scale": 5.0}, "any"),
    "thresholded_relu": ({"threshold": 0.5}, "any"), "stanh": ({"scale_a": 0.5, "scale_b": 1.5}, "any"),
    "soft_relu": ({"threshold": 1.0}, "any"), "brelu": ({"t_min": -1.0, "t_max": 1.0}, "any"),
}


def _unary_input(kind):
    if kind == "pos":
        return _f32(4, 7, lo=0.2, hi=3.0)
    if kind == "away":
        return _away(4, 7)
    return _f32(4, 7)


def _keep_off_kinks(op, x, attrs):
    """Move inputs off the kinks of the clipped activations (and round's
    half-way points), where the two frameworks may disagree on the
    one-sided derivative."""
    edges = {"relu6": [0.0, 1.5], "hard_sigmoid": [(0 - 0.4) / 0.3, (1 - 0.4) / 0.3],
             "hard_swish": [-1.0, 1.5], "thresholded_relu": [0.5], "soft_relu": [-1.0, 1.0],
             "brelu": [-1.0, 1.0], "round": [-1.5, -0.5, 0.5, 1.5]}.get(op, [])
    for e in edges:
        near = np.abs(x - e) < 0.05
        x = np.where(near, x + 0.1, x)
    return x.astype("float32")


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_forward_and_grad(name):
    attrs, kind = UNARY[name]
    op = "gelu" if name == "gelu_tanh" else name
    x = _keep_off_kinks(op, _unary_input(kind), attrs)
    inputs = {"X": [x]}
    _check(_run(op, inputs, attrs))
    _check_grad(op, inputs, attrs)


# ---------------------------------------------------------------------------
# clip, clip_by_norm, reduce_sum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["clip", "norm_below", "norm_above"])
def test_clip_ops(case):
    x = _keep_off_kinks("brelu", _f32(5, 6), {})
    if case == "clip":
        op, attrs = "clip", {"min": -1.0, "max": 1.0}
    else:
        op = "clip_by_norm"
        norm = float(np.sqrt((x.astype(np.float64) ** 2).sum()))
        attrs = {"max_norm": norm * (2.0 if case == "norm_below" else 0.5)}
    _check(_run(op, {"X": [x]}, attrs))
    _check_grad(op, {"X": [x]}, attrs)


REDUCE_ATTRS = {
    "all": {"dim": [0], "keep_dim": False, "reduce_all": True},
    "all_keep": {"dim": [0], "keep_dim": True, "reduce_all": True},
    "dim1": {"dim": [1], "keep_dim": False, "reduce_all": False},
    "dims_neg_keep": {"dim": [0, -1], "keep_dim": True, "reduce_all": False},
}


@pytest.mark.parametrize("dims", sorted(REDUCE_ATTRS))
def test_reduce_sum(dims):
    x = _f32(3, 4, 5)
    attrs = REDUCE_ATTRS[dims]
    _check(_run("reduce_sum", {"X": [x]}, attrs))
    _check_grad("reduce_sum", {"X": [x]}, attrs)


# ---------------------------------------------------------------------------
# comparisons, logical ops, where (no gradient but where's)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", ["equal", "not_equal", "less_than", "less_equal", "greater_than",
                                "greater_equal"])
def test_comparisons(op, dtype):
    x = RNG.randint(-3, 4, (4, 6)).astype(dtype)
    y = RNG.randint(-3, 4, (4, 6)).astype(dtype)
    _check(_run(op, {"X": [x], "Y": [y]}, {}))
    # broadcast rows against a column, as _causal_bias compares them
    _check(_run(op, {"X": [np.arange(5, dtype=dtype).reshape(1, 5)],
                     "Y": [np.arange(5, dtype=dtype).reshape(5, 1)]}, {}))
    assert not treg.get_op(op).differentiable


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor", "logical_not"])
def test_logical(op):
    x, y = RNG.rand(4, 6) < 0.5, RNG.rand(4, 6) < 0.5
    inputs = {"X": [x]} if op == "logical_not" else {"X": [x], "Y": [y]}
    _check(_run(op, inputs, {}))


def test_where():
    cond = RNG.rand(4, 6) < 0.5
    inputs = {"Condition": [cond], "X": [_f32(4, 6)], "Y": [_f32(4, 6)]}
    _check(_run("where", inputs, {}))
    _check_grad("where", inputs, {})


# ---------------------------------------------------------------------------
# Variable arithmetic: the same Program JSON in both packages
# ---------------------------------------------------------------------------
ARITH = {
    "add_scalar": lambda x, y: x + 1.5,
    "radd_scalar": lambda x, y: 2.0 + x,
    "sub_scalar": lambda x, y: x - 1.0,
    "rsub_scalar": lambda x, y: 1.0 - x,
    "mul_scalar": lambda x, y: x * 3.0,
    "rmul_scalar": lambda x, y: 3 * x,
    "div_scalar": lambda x, y: x / 4.0,
    "rdiv_scalar": lambda x, y: 5.0 / x,
    "neg": lambda x, y: -x,
    "add": lambda x, y: x + y,
    "sub": lambda x, y: x - y,
    "mul": lambda x, y: x * y,
    "div": lambda x, y: x / y,
    "causal_bias": lambda x, y: (x - 1.0) * 1e9,
}


def _arith_program(fluid, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [4, 5])
        y = fluid.layers.data("y", [4, 5])
        out = fn(x, y)
    return main, out


@pytest.mark.parametrize("case", sorted(ARITH))
def test_variable_arithmetic_program_json(case):
    jm, jout = _arith_program(jfluid, ARITH[case])
    tm, tout = _arith_program(tfluid, ARITH[case])
    tj, jj = json.loads(tm.to_json()), json.loads(jm.to_json())
    if case == "rdiv_scalar":
        # the JAX package's shape inference cannot align X [1] to Y (see
        # below) and leaves the output's shape unset; the port infers it
        assert (jout.shape, tout.shape) == (None, (-1, 4, 5))
        for v in jj["blocks"][0]["vars"] + tj["blocks"][0]["vars"]:
            if v["name"] == jout.name:
                v["shape"] = None
    assert tj == jj
    assert tout.name == jout.name
    # and it runs the same
    feed = {"x": _away(2, 4, 5), "y": _away(2, 4, 5)}
    exe = tfluid.Executor(tfluid.CPUPlace())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    got, = exe.run(tm, feed=feed, fetch_list=[tout], scope=tfluid.Scope())
    if case == "rdiv_scalar":
        # a [1] constant as X over a larger Y: the JAX package's kernel
        # aligns only Y to X and cannot run it; the port aligns X to Y,
        # as the reference's elementwise_op_function.h does
        with jfluid.scope_guard(jfluid.Scope()), pytest.raises(IndexError):
            jexe.run(jm, feed=feed, fetch_list=[jout])
        np.testing.assert_allclose(got, np.float32(5.0) / feed["x"], **TOL)
        return
    with jfluid.scope_guard(jfluid.Scope()):
        ref, = jexe.run(jm, feed=feed, fetch_list=[jout])
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_layers_desc_parity():
    """The tensor and unary layers the LR schedules and clips call build
    the JAX package's ops, attrs and vars."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [3, 4])
            lt = fluid.layers
            c = lt.fill_constant([1], "float32", 0.5)
            outs = [lt.sums([x, x]), lt.reduce_sum(x), lt.reduce_sum(x, dim=1, keep_dim=True),
                    lt.elementwise_max(x, c), lt.elementwise_min(x, c), lt.elementwise_pow(x, c),
                    lt.where(lt.less_than(x, c), x, lt.fill_constant([1], "float32", 0.0)),
                    lt.logical_not(lt.greater_equal(x, c)), lt.clip(x, -1.0, 1.0),
                    lt.clip_by_norm(x, 2.0)]
            outs += [getattr(lt, name)(x) for name in lt.ops.__all__]
        return main, outs

    jm, jouts = build(jfluid)
    tm, touts = build(tfluid)
    assert json.loads(tm.to_json()) == json.loads(jm.to_json())
    assert [o.name for o in touts] == [o.name for o in jouts]
