"""Op and grad parity of the LeNet / ResNet slice: each new op kernel of
paddle_tpu_torch (conv2d, pool2d, batch_norm, relu, softmax,
cross_entropy, momentum, gaussian_random), and each ``<type>_grad``,
against paddle_tpu's on the same numpy inputs.

Tolerances: fp32 at atol 1e-5, rtol 1e-5 (the two frameworks sum in
different orders), except convolutions and their gradients at atol 1e-4,
rtol 1e-5 (a sum over up to 36 taps a cell and, for the filter's
gradient, over every output cell).  bf16 against bf16 at atol 2e-2, rtol
2**-7: one to two bf16 ulps at any output scale (both round the same
fp32 math to bf16, summed in different orders).  ``momentum`` at atol
1e-6, rtol 1e-6 (elementwise fp32).  ``gaussian_random`` is held by
distribution: over 200,000 draws the sample mean within 5 standard
errors of the asked mean and the sample std within 1% of the asked one;
the same seed gives the same bits, another seed other bits (torch's
generator cannot give jax.random's bits).

Max-pool ties: jax's select-and-scatter and torch's argmax may send a
tied window's gradient to different cells.  The pool inputs are normal
draws (checked to hold no repeated value), so no window ties, and the
one pool gradient taken after a ``relu`` (whose zeros tie) carries it
through the relu's zero gradient, which drops whatever reached a tied
zero.

Every new op type also runs under the executor's cached entry on the
CPU, the interpreter that a CUDA graph captures on a card, twice with
its entry cache hit, against the kernel called directly; its capture on
the card is in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

CPU = torch.device("cpu")
FP32 = dict(atol=1e-5, rtol=1e-5)
CONV = dict(atol=1e-4, rtol=1e-5)
BF16 = dict(atol=2e-2, rtol=2.0 ** -7)
RNG = np.random.RandomState(61)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's CPU kernels on two threads for this file: the tests run
    beside others in parallel, and all cores each would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(*shape, scale=1.0):
    return np.asarray(RNG.randn(*shape) * scale, dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).detach().numpy()
    x = np.asarray(x)
    return x.astype("float32") if x.dtype.name == "bfloat16" else x


def _as_bf16(inputs, slots):
    """The inputs with ``slots`` rounded to bf16: (jax inputs, port inputs)."""
    jin = {s: [jnp.asarray(a, dtype=jnp.bfloat16 if s in slots else None) for a in arrs]
           for s, arrs in inputs.items()}
    tin = {s: [torch.from_numpy(np.require(a, requirements="C")).to(
        torch.bfloat16 if s in slots else None) for a in arrs] for s, arrs in inputs.items()}
    return jin, tin


def _kernels_both(op_type, inputs, attrs, bf16_slots=()):
    """The op type's kernel in both packages on the same inputs; returns
    {slot: [(jax value, port value), ...]} as numpy, and the port's raw
    outputs."""
    jin, tin = _as_bf16(inputs, set(bf16_slots))
    jout = jreg.get_kernel(op_type)(jin, dict(attrs))
    tout = treg.get_kernel(op_type)(tin, dict(attrs), CPU)
    res = {}
    for slot, jv in jout.items():
        jv = jv if isinstance(jv, (list, tuple)) else [jv]
        tv = tout[slot]
        tv = tv if isinstance(tv, (list, tuple)) else [tv]
        assert len(jv) == len(tv), slot
        res[slot] = [(_np(a), _np(b)) for a, b in zip(jv, tv)]
    return res, tout


def _assert_close(res, **tol):
    for slot, pairs in res.items():
        for j, t in pairs:
            assert j.shape == t.shape, (slot, j.shape, t.shape)
            np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                                       err_msg=slot, **tol)


def _grad_both(op_type, inputs, out_grads, attrs, tol=FP32):
    """``<op_type>_grad`` in both packages: forward inputs plus
    ``<slot>@GRAD`` for the outputs in ``out_grads``, with the attrs
    backward.py gives a grad op."""
    opdef = treg.get_op(op_type)
    fwd_out = tuple(_kernels_both(op_type, inputs, attrs)[0])
    want = tuple(s for s in inputs if s not in opdef.no_grad_set)
    g_attrs = dict(attrs, __fwd_output_slots__=fwd_out, __grad_input_slots__=want)
    g_inputs = dict(inputs)
    for slot, arrs in out_grads.items():
        g_inputs[slot + "@GRAD"] = arrs
    res, _ = _kernels_both(op_type + "_grad", g_inputs, g_attrs)
    assert set(res) == {s + "@GRAD" for s in want}, res.keys()
    _assert_close(res, **tol)
    return res


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------
def _conv_case(fmt, n, c, h, w, o, k, groups, strides, paddings, dilations, bias):
    x = _f32(n, c, h, w)
    inputs = {"Input": [_nhwc(x) if fmt == "NHWC" else x],
              "Filter": [_f32(o, c // groups, k, k, scale=0.3)]}
    if bias:
        inputs["Bias"] = [_f32(o)]
    attrs = {"strides": strides, "paddings": paddings, "dilations": dilations,
             "groups": groups, "data_format": fmt}
    return inputs, attrs


CONV_CASES = {
    "stride2_pad1": (2, 3, 9, 9, 4, 3, 1, [2, 2], [1, 1], [1, 1], False),
    "dilated_grouped_bias": (2, 4, 10, 11, 6, 3, 2, [1, 2], [2, 1], [2, 1], True),
    "lenet_5x5": (3, 1, 12, 12, 5, 5, 1, [1, 1], [0, 0], [1, 1], False),
    "resnet_1x1_s2": (2, 8, 7, 7, 16, 1, 1, [2, 2], [0, 0], [1, 1], False),
}


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_forward_and_grad(case, fmt):
    inputs, attrs = _conv_case(fmt, *CONV_CASES[case])
    res, _ = _kernels_both("conv2d", inputs, attrs)
    _assert_close(res, **CONV)
    out = res["Output"][0][1]
    _grad_both("conv2d", inputs, {"Output": [_f32(*out.shape)]}, attrs, tol=CONV)


def test_conv2d_nhwc_runs_channels_last_without_a_copy():
    """The NHWC path hands the convolution the permuted view of the NHWC
    tensor, a channels-last NCHW tensor over the same storage, and its
    output permutes back to a contiguous NHWC tensor."""
    from paddle_tpu_torch.ops import nn_ops

    x = torch.from_numpy(_nhwc(_f32(2, 8, 6, 6)))
    view = nn_ops._as_nchw(x, "NHWC")
    assert view.is_contiguous(memory_format=torch.channels_last)
    assert view.data_ptr() == x.data_ptr()
    out = treg.get_kernel("conv2d")({"Input": [x], "Filter": [torch.randn(4, 8, 3, 3)]},
                                    {"paddings": [1, 1], "data_format": "NHWC"}, CPU)["Output"]
    assert out.shape == (2, 6, 6, 4) and out.is_contiguous()


def test_conv2d_bf16():
    inputs, attrs = _conv_case("NHWC", *CONV_CASES["stride2_pad1"])
    res, tout = _kernels_both("conv2d", inputs, attrs, bf16_slots={"Input", "Filter"})
    assert tout["Output"].dtype == torch.bfloat16
    _assert_close(res, **BF16)


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------
POOL_CASES = {
    # name: ((N, C, H, W), attrs)
    "max_resnet_3x3_s2_p1": ((2, 3, 9, 9), {"pooling_type": "max", "ksize": [3, 3],
                                             "strides": [2, 2], "paddings": [1, 1]}),
    "max_lenet_2x2": ((2, 3, 8, 8), {"pooling_type": "max", "ksize": [2, 2],
                                      "strides": [2, 2], "paddings": [0, 0]}),
    "avg_exclusive_pad": ((2, 3, 7, 7), {"pooling_type": "avg", "ksize": [3, 3],
                                          "strides": [2, 2], "paddings": [1, 1],
                                          "exclusive": True}),
    "avg_inclusive_pad": ((2, 3, 7, 7), {"pooling_type": "avg", "ksize": [3, 3],
                                          "strides": [2, 2], "paddings": [1, 1],
                                          "exclusive": False}),
    "avg_global": ((2, 5, 4, 3), {"pooling_type": "avg", "ksize": [1, 1],
                                   "global_pooling": True}),
    "max_global": ((2, 5, 4, 3), {"pooling_type": "max", "ksize": [1, 1],
                                   "global_pooling": True}),
    # ceil_mode, the last windows partial: the JAX op pads the high side
    "max_ceil_pad": ((2, 3, 6, 6), {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                                     "paddings": [1, 1], "ceil_mode": True}),
    "avg_exclusive_ceil_pad": ((2, 3, 6, 6), {"pooling_type": "avg", "ksize": [3, 3],
                                               "strides": [2, 2], "paddings": [1, 1],
                                               "ceil_mode": True, "exclusive": True}),
    "avg_inclusive_ceil_pad": ((2, 3, 6, 6), {"pooling_type": "avg", "ksize": [3, 3],
                                               "strides": [2, 2], "paddings": [1, 1],
                                               "ceil_mode": True, "exclusive": False}),
    # a pad wider than half the window, which torch's own padding refuses
    "max_wide_pad": ((1, 2, 5, 5), {"pooling_type": "max", "ksize": [3, 3], "strides": [1, 1],
                                     "paddings": [2, 2]}),
}


def _pool_input(shape, fmt):
    x = _f32(*shape)
    assert np.unique(x).size == x.size  # no repeated value: no tied window
    return _nhwc(x) if fmt == "NHWC" else x


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_forward_and_grad(case, fmt):
    shape, attrs = POOL_CASES[case]
    attrs = dict(attrs, data_format=fmt)
    inputs = {"X": [_pool_input(shape, fmt)]}
    res, _ = _kernels_both("pool2d", inputs, attrs)
    _assert_close(res, **FP32)
    out = res["Out"][0][1]
    assert np.isfinite(out).all()
    _grad_both("pool2d", inputs, {"Out": [_f32(*out.shape)]}, attrs)


@pytest.mark.parametrize("ptype,exclusive", [("max", True), ("avg", True), ("avg", False)])
def test_pool2d_ceil_mode_follows_the_jax_op_where_torch_differs(ptype, exclusive):
    """H = W = 7, a 2x2 window, stride 2, pad 1, ceil_mode: the JAX op
    emits 5 windows a side, the last one wholly in the padding (-inf for
    max, 0/0 for an exclusive average, 0 for an inclusive one); torch's
    own ceil_mode drops that window and emits 4.  The port follows the
    JAX op."""
    attrs = {"pooling_type": ptype, "ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1],
             "ceil_mode": True, "exclusive": exclusive}
    x = _f32(1, 2, 7, 7)
    res, _ = _kernels_both("pool2d", {"X": [x]}, attrs)
    j, t = res["Out"][0]
    assert j.shape == t.shape == (1, 2, 5, 5)
    ref = torch.nn.functional.max_pool2d if ptype == "max" else torch.nn.functional.avg_pool2d
    assert ref(torch.from_numpy(x), 2, 2, 1, ceil_mode=True).shape == (1, 2, 4, 4)
    np.testing.assert_allclose(t, j, **FP32)  # -inf and nan in the same cells


def test_max_pool_grad_after_relu_ties():
    """A max pool over a relu's output, whose zeros tie in a window: the
    gradient to the relu's input is the same in both packages, since the
    relu's zero gradient drops whatever reached a tied zero."""
    x = _f32(2, 3, 8, 8)
    x[:, :, :4, :4] = -np.abs(x[:, :, :4, :4])  # whole windows of zeros after the relu
    attrs = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
             "data_format": "NCHW"}
    g = _f32(2, 3, 4, 4)
    grad_attrs = {"__fwd_output_slots__": ("Out",), "__grad_input_slots__": ("X",)}

    def grads(kernel, to):
        r = kernel("relu")({"X": [to(x)]}, {})["Out"]
        gp = kernel("pool2d_grad")({"X": [r], "Out@GRAD": [to(g)]}, dict(attrs, **grad_attrs))
        return kernel("relu_grad")({"X": [to(x)], "Out@GRAD": [gp["X@GRAD"][0]]}, grad_attrs)

    jg = grads(jreg.get_kernel, jnp.asarray)
    tg = grads(lambda t: lambda i, a: treg.get_kernel(t)(i, a, CPU), torch.from_numpy)
    np.testing.assert_allclose(_np(tg["X@GRAD"][0]), _np(jg["X@GRAD"][0]), **FP32)


@pytest.mark.parametrize("case", ["max_resnet_3x3_s2_p1", "avg_global"])
def test_pool2d_bf16(case):
    shape, attrs = POOL_CASES[case]
    res, tout = _kernels_both("pool2d", {"X": [_pool_input(shape, "NHWC")]},
                              dict(attrs, data_format="NHWC"), bf16_slots={"X"})
    assert tout["Out"].dtype == torch.bfloat16
    _assert_close(res, **BF16)


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------
def _bn_inputs(fmt, shape=(4, 3, 5, 6)):
    x = _f32(*shape, scale=2.0) + 0.5
    c = shape[1]
    return {"X": [_nhwc(x) if fmt == "NHWC" else x], "Scale": [_f32(c) + 1.0],
            "Bias": [_f32(c)], "Mean": [_f32(c, scale=0.1)],
            "Variance": [np.abs(_f32(c)) + 0.5]}


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_forward_and_grad(fmt, is_test):
    inputs = _bn_inputs(fmt)
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test, "data_layout": fmt,
             "sync_bn": False}
    res, _ = _kernels_both("batch_norm", inputs, attrs)
    assert set(res) == {"Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"}
    _assert_close(res, **FP32)
    _grad_both("batch_norm", inputs, {"Y": [_f32(*inputs["X"][0].shape)]}, attrs)


def test_batch_norm_running_stat_update():
    """The batch's biased variance and momentum * old + (1 - momentum) *
    batch, written out in numpy: torch's own running-stat rule (unbiased,
    the other momentum convention) would miss both."""
    inputs = _bn_inputs("NCHW")
    attrs = {"momentum": 0.8, "epsilon": 1e-5, "is_test": False, "data_layout": "NCHW"}
    _, tout = _kernels_both("batch_norm", inputs, attrs)
    x = inputs["X"][0].astype(np.float64)
    bm, bv = x.mean(axis=(0, 2, 3)), x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(tout["SavedMean"].numpy(), bm, **FP32)
    np.testing.assert_allclose(tout["SavedVariance"].numpy(), bv, **FP32)
    np.testing.assert_allclose(tout["MeanOut"].numpy(), 0.8 * inputs["Mean"][0] + 0.2 * bm, **FP32)
    np.testing.assert_allclose(tout["VarianceOut"].numpy(),
                               0.8 * inputs["Variance"][0] + 0.2 * bv, **FP32)


@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
def test_batch_norm_bf16_x_keeps_fp32_statistics(is_test):
    """AMP feeds a bf16 X with fp32 Scale, Bias and running stats: the
    statistics come out fp32, Y in bf16."""
    inputs = _bn_inputs("NHWC")
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test, "data_layout": "NHWC"}
    res, tout = _kernels_both("batch_norm", inputs, attrs, bf16_slots={"X"})
    assert tout["Y"].dtype == torch.bfloat16
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        assert tout[slot].dtype == torch.float32, slot
    _assert_close({"Y": res.pop("Y")}, **BF16)
    _assert_close(res, **FP32)


def test_batch_norm_sync_bn_raises():
    """sync_bn reduces its statistics over the op's axis only while that
    axis is active (the JAX op psums inside a mapped axis alone); outside
    one it is the local batch's, as the plain op (tests/test_torch_sharded_
    training.py holds it over gloo ranks against the full batch)."""
    inputs = {s: [torch.from_numpy(a[0])] for s, a in _bn_inputs("NCHW").items()}
    kernel = treg.get_kernel("batch_norm")
    synced = kernel(inputs, {"sync_bn": True}, CPU)
    local = kernel(inputs, {"sync_bn": False}, CPU)
    for slot in ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        torch.testing.assert_close(synced[slot], local[slot], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# activations and losses
# ---------------------------------------------------------------------------
def _probs(n, c):
    e = np.exp(_f32(n, c))
    return (e / e.sum(-1, keepdims=True)).astype("float32")


ACT_CASES = {
    "relu": ("relu", {"X": [_f32(3, 4, 5)]}, "Out", {}),
    "softmax_last": ("softmax", {"X": [_f32(4, 7, scale=3.0)]}, "Out", {"axis": -1}),
    "softmax_axis1": ("softmax", {"X": [_f32(2, 5, 3)]}, "Out", {"axis": 1}),
    "cross_entropy_hard": ("cross_entropy",
                           {"X": [_probs(6, 10)],
                            "Label": [RNG.randint(0, 10, (6, 1)).astype("int64")]},
                           "Y", {"soft_label": False, "ignore_index": -100}),
    "cross_entropy_hard_flat": ("cross_entropy",
                                {"X": [_probs(6, 10)],
                                 "Label": [RNG.randint(0, 10, (6,)).astype("int64")]},
                                "Y", {"soft_label": False}),
    "cross_entropy_soft": ("cross_entropy", {"X": [_probs(5, 4)], "Label": [_probs(5, 4)]},
                           "Y", {"soft_label": True}),
}


@pytest.mark.parametrize("case", sorted(ACT_CASES))
def test_activation_and_loss_forward_and_grad(case):
    op_type, inputs, out_slot, attrs = ACT_CASES[case]
    res, _ = _kernels_both(op_type, inputs, attrs)
    _assert_close(res, **FP32)
    out = res[out_slot][0][1]
    _grad_both(op_type, inputs, {out_slot: [_f32(*out.shape)]}, attrs)


def test_cross_entropy_keeps_the_epsilon():
    """A zero probability gives -log(1e-8), finite, as in the JAX op."""
    x = np.array([[0.0, 1.0]], "float32")
    res, _ = _kernels_both("cross_entropy", {"X": [x], "Label": [np.array([[0]], "int64")]}, {})
    j, t = res["Y"][0]
    np.testing.assert_allclose(t, j, rtol=1e-6)
    np.testing.assert_allclose(t, [[-np.log(np.float32(1e-8))]], rtol=1e-6)


def test_relu_bf16():
    res, tout = _kernels_both("relu", {"X": [_f32(4, 6)]}, {}, bf16_slots={"X"})
    assert tout["Out"].dtype == torch.bfloat16
    _assert_close(res, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# momentum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_momentum_parity(nesterov):
    inputs = {"Param": [_f32(5, 7)], "Grad": [_f32(5, 7)], "Velocity": [_f32(5, 7, scale=0.1)],
              "LearningRate": [np.array([0.1], "float32")]}
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    res, tout = _kernels_both("momentum", inputs, attrs)
    assert set(res) == {"ParamOut", "VelocityOut"}
    _assert_close(res, atol=1e-6, rtol=1e-6)
    p, g, v = (inputs[s][0].astype(np.float64) for s in ("Param", "Grad", "Velocity"))
    v_new = 0.9 * v + g
    p_new = p - 0.1 * (g + 0.9 * v_new) if nesterov else p - 0.1 * v_new
    np.testing.assert_allclose(tout["ParamOut"].numpy(), p_new, atol=1e-6, rtol=1e-6)


def test_momentum_casts_lr_to_the_param_type():
    inputs = {"Param": [torch.ones(3, dtype=torch.float64)], "Grad": [torch.ones(3, dtype=torch.float64)],
              "Velocity": [torch.zeros(3, dtype=torch.float64)],
              "LearningRate": [torch.tensor([0.5])]}
    out = treg.get_kernel("momentum")(inputs, {"mu": 0.9}, CPU)
    assert out["ParamOut"].dtype == torch.float64
    torch.testing.assert_close(out["ParamOut"], torch.full((3,), 0.5, dtype=torch.float64))


# ---------------------------------------------------------------------------
# gaussian_random
# ---------------------------------------------------------------------------
def _gauss(seed, mean=0.5, std=2.0, n=200_000, dtype="float32"):
    attrs = {"shape": [n], "dtype": dtype, "mean": mean, "std": std, "seed": seed}
    return treg.get_kernel("gaussian_random")({}, attrs, CPU)["Out"]


def test_gaussian_random_distribution():
    out = _gauss(7).double().numpy()
    assert out.shape == (200_000,)
    assert abs(out.mean() - 0.5) <= 5 * 2.0 / np.sqrt(out.size)
    assert abs(out.std() - 2.0) <= 0.01 * 2.0
    # the JAX op's draw of the same attrs: the same distribution
    j = np.asarray(jreg.get_kernel("gaussian_random")(
        {}, {"shape": [200_000], "dtype": "float32", "mean": 0.5, "std": 2.0, "seed": 7})["Out"])
    assert abs(j.mean() - out.mean()) <= 10 * 2.0 / np.sqrt(out.size)
    assert abs(j.std() - out.std()) <= 0.02 * 2.0


def test_gaussian_random_seeded():
    assert torch.equal(_gauss(11, n=1000), _gauss(11, n=1000))
    assert not torch.equal(_gauss(11, n=1000), _gauss(12, n=1000))
    assert _gauss(11, n=10, dtype="bfloat16").dtype == torch.bfloat16
    assert treg.get_op("gaussian_random").random


def test_normal_initializer_and_xavier_normal_append_gaussian_random():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        tfluid.layers.create_parameter([4, 6], "float32", name="w",
                                       default_initializer=tfluid.initializer.Normal(0.0, 0.1))
        tfluid.layers.create_parameter([4, 6], "float32", name="v",
                                       default_initializer=tfluid.initializer.Xavier(uniform=False))
    ops = startup.global_block().ops
    assert [o.type for o in ops] == ["gaussian_random", "gaussian_random"]
    assert ops[0].attr("std") == 0.1 and ops[1].attr("std") == pytest.approx(np.sqrt(2 / 10))
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    assert scope.get("w").shape == (4, 6) and scope.get("w").std() < 0.3


# ---------------------------------------------------------------------------
# each new op type through the executor's cached entry
# ---------------------------------------------------------------------------
def _one_op_program(op_type, inputs, attrs, out_slots, state=()):
    """A program of one op: every input a feed, except ``state``, which
    are persistable vars that the op also writes (as batch_norm and
    momentum do)."""
    main = tfluid.Program()
    blk = main.global_block()
    feeds = {}
    for slot, arrs in inputs.items():
        persistable = slot in state
        blk.create_var(name=slot.lower(), shape=arrs[0].shape, dtype=str(arrs[0].dtype),
                       persistable=persistable)
        if not persistable:
            feeds[slot.lower()] = arrs[0]
    outputs = {}
    for slot in out_slots:
        name = state[slot] if slot in state else slot.lower() + "_out"
        if slot not in state:
            blk.create_var(name=name, dtype="float32")
        outputs[slot] = [name]
    blk.append_op(op_type, inputs={s: [s.lower()] for s in inputs}, outputs=outputs,
                  attrs=dict(attrs))
    return main, feeds


CACHED_CASES = {
    "relu": ("relu", {"X": [_f32(3, 4)]}, {}, ("Out",), {}),
    "softmax": ("softmax", {"X": [_f32(3, 4)]}, {"axis": -1}, ("Out",), {}),
    "cross_entropy": ("cross_entropy", {"X": [_probs(4, 5)],
                                        "Label": [np.array([[0], [4], [2], [1]], "int64")]},
                      {}, ("Y",), {}),
    "conv2d": ("conv2d", *_conv_case("NHWC", *CONV_CASES["dilated_grouped_bias"]),
               ("Output",), {}),
    "pool2d": ("pool2d", {"X": [_f32(2, 3, 6, 6)]}, POOL_CASES["max_ceil_pad"][1], ("Out",), {}),
    "batch_norm": ("batch_norm", _bn_inputs("NHWC"), {"is_test": False, "data_layout": "NHWC"},
                   ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
                   {"Mean": "mean", "Variance": "variance", "MeanOut": "mean",
                    "VarianceOut": "variance"}),
    "momentum": ("momentum", {"Param": [_f32(4, 3)], "Grad": [_f32(4, 3)],
                              "Velocity": [_f32(4, 3)],
                              "LearningRate": [np.array([0.1], "float32")]},
                 {"mu": 0.9, "use_nesterov": True}, ("ParamOut", "VelocityOut"),
                 {"Param": "param", "Velocity": "velocity", "LearningRate": "learningrate",
                  "ParamOut": "param", "VelocityOut": "velocity"}),
}


@pytest.mark.parametrize("case", sorted(CACHED_CASES))
def test_new_op_runs_under_the_cached_entry(case):
    """Three runs of the same entry (a miss, then hits), each against the
    kernel called directly on the state the run started from; state the
    op writes is written back to the scope."""
    op_type, inputs, attrs, out_slots, state = CACHED_CASES[case]
    main, feeds = _one_op_program(op_type, inputs, attrs, out_slots, state)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope(device="cpu")
    for slot in inputs:
        if slot in state:
            scope.set(slot.lower(), inputs[slot][0])
    fetch = [state.get(s, s.lower() + "_out") for s in out_slots]
    for _ in range(3):
        before = {n: v.clone() for n, v in scope.vars.items()}
        got = exe.run(main, feed=feeds, fetch_list=fetch, scope=scope)
        ref = treg.get_kernel(op_type)(
            {s: [before[s.lower()] if s in state else torch.from_numpy(np.require(a[0], requirements="C"))]
             for s, a in inputs.items()}, dict(attrs), CPU)
        for name, slot, g in zip(fetch, out_slots, got):
            np.testing.assert_array_equal(g, ref[slot].numpy(), err_msg=name)
    stats = exe.jit_cache_stats()
    assert stats["misses"] == 1 and stats["hits"] == 2
    if state:
        written = {state[s] for s in out_slots if s in state}
        for n in written:
            assert not torch.equal(scope.vars[n], torch.from_numpy(inputs[
                next(s for s in inputs if s.lower() == n)][0])), n
