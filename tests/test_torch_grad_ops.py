"""Op and grad parity of the BERT-pretraining slice: each op kernel of
paddle_tpu_torch, and each ``<type>_grad`` kernel, against paddle_tpu's
on the same numpy inputs; and the fused attention gradient itself.

fp32 compares at atol 1e-5, rtol 1e-5 (the two frameworks sum in
different orders).  The JAX side runs on the CPU as its own tests run
it: ``fused_attention`` takes its einsum branch and ``jax.vjp``
differentiates that.  A grad op gets the forward inputs and the
upstream gradients of the outputs that carry one, with the attrs
``backward.py`` gives it (``__fwd_output_slots__``,
``__grad_input_slots__``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch import kernels
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.kernels import fused_attention as fa

CPU = torch.device("cpu")
FP32 = dict(atol=1e-5, rtol=1e-5)
# bf16 against fp32: one to two bf16 ulps at any output scale
BF16 = dict(atol=2e-2, rtol=2.0 ** -7)


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).detach().numpy()
    return np.asarray(x)


def _kernels_both(op_type, inputs, attrs):
    """Run the op type's kernel in both packages on the same numpy inputs;
    returns {slot: [(jax value, port value), ...]} as numpy."""
    jin = {s: [jnp.asarray(a) for a in arrs] for s, arrs in inputs.items()}
    # np.require keeps 0-d arrays 0-d (ascontiguousarray makes them 1-d)
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
        res[slot] = [(None if a is None else _np(a), None if b is None else _np(b))
                     for a, b in zip(jv, tv)]
    return res


def _assert_close(res, **tol):
    for slot, pairs in res.items():
        for j, t in pairs:
            assert (j is None) == (t is None), slot
            if j is None:
                continue
            assert j.shape == t.shape, (slot, j.shape, t.shape)
            if j.dtype.kind in "iub":
                np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=slot)
            elif j.size:
                np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                                           err_msg=slot, **tol)


def _grad_both(op_type, inputs, out_grads, attrs, tol=FP32):
    """``<op_type>_grad`` in both packages: forward inputs plus
    ``<slot>@GRAD`` for the outputs in ``out_grads``."""
    opdef = treg.get_op(op_type)
    fwd_out = tuple(_kernels_both(op_type, inputs, attrs))
    want = tuple(s for s in inputs if s not in opdef.no_grad_set)
    g_attrs = dict(attrs, __fwd_output_slots__=fwd_out, __grad_input_slots__=want)
    g_inputs = dict(inputs)
    for slot, arrs in out_grads.items():
        g_inputs[slot + "@GRAD"] = arrs
    res = _kernels_both(op_type + "_grad", g_inputs, g_attrs)
    assert set(res) == {s + "@GRAD" for s in want}, res.keys()
    _assert_close(res, **tol)
    return res


RNG = np.random.RandomState(21)


def _f32(*shape, scale=1.0):
    return np.asarray(RNG.randn(*shape) * scale, dtype="float32")


# ---------------------------------------------------------------------------
# forward parity of the slice's new op types, and the optimizer ops
# ---------------------------------------------------------------------------
FORWARD_CASES = {
    "matmul_tY": ("matmul", {"X": [_f32(6, 8)], "Y": [_f32(10, 8)]},
                  {"transpose_X": False, "transpose_Y": True, "alpha": 1.0}),
    "matmul_tX_alpha": ("matmul", {"X": [_f32(2, 8, 6)], "Y": [_f32(2, 8, 5)]},
                        {"transpose_X": True, "transpose_Y": False, "alpha": 0.5}),
    "sum3": ("sum", {"X": [_f32(4, 5), _f32(4, 5), _f32(4, 5)]}, {}),
    "mean": ("mean", {"X": [_f32(7, 3)]}, {}),
    "tanh": ("tanh", {"X": [_f32(5, 6, scale=2.0)]}, {}),
    "softmax_xent": ("softmax_with_cross_entropy",
                     {"Logits": [_f32(6, 10, scale=3.0)],
                      "Label": [RNG.randint(0, 10, (6, 1)).astype("int64")]},
                     {"soft_label": False, "ignore_index": -100, "axis": -1}),
    "softmax_xent_ignore": ("softmax_with_cross_entropy",
                            {"Logits": [_f32(6, 10)],
                             "Label": [np.array([[1], [3], [3], [0], [9], [3]], "int64")]},
                            {"soft_label": False, "ignore_index": 3, "axis": -1}),
    "gather": ("gather", {"X": [_f32(12, 4)], "Index": [np.array([3, 0, 11, 3, 7], "int64")]}, {}),
    "slice_cls": ("slice", {"Input": [_f32(3, 5, 4)]}, {"axes": [1], "starts": [0], "ends": [1]}),
    "slice_neg": ("slice", {"Input": [_f32(3, 5, 4)]},
                  {"axes": [0, 2], "starts": [-2, 1], "ends": [10, -1]}),
    "top_k": ("top_k", {"X": [_f32(6, 9)]}, {"k": 3}),
    "accuracy": ("accuracy", {"Indices": [np.array([[1], [0], [1], [1]], "int64")],
                              "Label": [np.array([[1], [1], [0], [1]], "int64")]}, {}),
    "accuracy_top2": ("accuracy", {"Indices": [np.array([[1, 2], [0, 3], [2, 1]], "int64")],
                                   "Label": [np.array([[2], [1], [0]], "int64")]}, {}),
}


@pytest.mark.parametrize("case", sorted(FORWARD_CASES))
def test_forward_parity(case):
    op_type, inputs, attrs = FORWARD_CASES[case]
    _assert_close(_kernels_both(op_type, inputs, attrs), **FP32)


def _adam_inputs(shape):
    return {
        "Param": [_f32(*shape)], "Grad": [_f32(*shape)],
        "Moment1": [_f32(*shape, scale=0.1)], "Moment2": [np.abs(_f32(*shape, scale=0.1))],
        "Beta1Pow": [np.array([0.9 ** 3], "float32")], "Beta2Pow": [np.array([0.999 ** 3], "float32")],
        "LearningRate": [np.array([1e-3], "float32")],
    }


def test_adam_parity():
    res = _kernels_both("adam", _adam_inputs((5, 7)), {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    assert set(res) == {"ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut", "Beta2PowOut"}
    _assert_close(res, atol=1e-6, rtol=1e-6)


def test_sgd_parity():
    inputs = {"Param": [_f32(4, 3)], "Grad": [_f32(4, 3)], "LearningRate": [np.array([0.1], "float32")]}
    _assert_close(_kernels_both("sgd", inputs, {}), atol=1e-7, rtol=1e-7)


# ---------------------------------------------------------------------------
# grad parity of every differentiable op type of the training program
# ---------------------------------------------------------------------------
def _ids(shape, hi):
    return RNG.randint(0, hi, shape).astype("int64")


GRAD_CASES = {
    "elementwise_add_bias": ("elementwise_add", {"X": [_f32(2, 5, 8)], "Y": [_f32(8)]},
                             {"Out": [_f32(2, 5, 8)]}, {"axis": 2}),
    "elementwise_add_same": ("elementwise_add", {"X": [_f32(3, 4)], "Y": [_f32(3, 4)]},
                             {"Out": [_f32(3, 4)]}, {"axis": -1}),
    "elementwise_add_scalar": ("elementwise_add", {"X": [_f32()], "Y": [_f32()]},
                               {"Out": [_f32()]}, {"axis": -1}),
    "mul_fc3": ("mul", {"X": [_f32(2, 3, 16)], "Y": [_f32(16, 5)]}, {"Out": [_f32(2, 3, 5)]},
                {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "mul_fc2": ("mul", {"X": [_f32(6, 8)], "Y": [_f32(8, 3)]}, {"Out": [_f32(6, 3)]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "matmul_tied": ("matmul", {"X": [_f32(6, 8)], "Y": [_f32(10, 8)]}, {"Out": [_f32(6, 10)]},
                    {"transpose_X": False, "transpose_Y": True, "alpha": 1.0}),
    "reshape2": ("reshape2", {"X": [_f32(2, 6, 8)]}, {"Out": [_f32(2, 6, 2, 4)]},
                 {"shape": [0, 0, 2, 4]}),
    "transpose2": ("transpose2", {"X": [_f32(2, 3, 4, 5)]}, {"Out": [_f32(2, 4, 3, 5)]},
                   {"axis": [0, 2, 1, 3]}),
    "layer_norm_seq": ("layer_norm", {"X": [_f32(2, 5, 8, scale=3.0)], "Scale": [_f32(8)],
                                      "Bias": [_f32(8)]},
                       {"Y": [_f32(2, 5, 8)]}, {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "layer_norm_rows": ("layer_norm", {"X": [_f32(6, 8)], "Scale": [_f32(8)], "Bias": [_f32(8)]},
                        {"Y": [_f32(6, 8)]}, {"epsilon": 1e-5, "begin_norm_axis": 1}),
    "lookup_table": ("lookup_table", {"W": [_f32(10, 4)], "Ids": [_ids((2, 6), 10)]},
                     {"Out": [_f32(2, 6, 4)]}, {"padding_idx": -1}),
    "gelu": ("gelu", {"X": [_f32(3, 7, scale=2.0)]}, {"Out": [_f32(3, 7)]}, {}),
    "tanh": ("tanh", {"X": [_f32(3, 7, scale=2.0)]}, {"Out": [_f32(3, 7)]}, {}),
    "gather": ("gather", {"X": [_f32(12, 4)], "Index": [np.array([3, 0, 11, 3, 7], "int64")]},
               {"Out": [_f32(5, 4)]}, {}),
    "slice": ("slice", {"Input": [_f32(3, 5, 4)]}, {"Out": [_f32(3, 1, 4)]},
              {"axes": [1], "starts": [0], "ends": [1]}),
    # the loss grad fill_constant is shape [1] while mean's output is a scalar
    "mean": ("mean", {"X": [_f32(7, 3)]}, {"Out": [np.array([1.0], "float32")]}, {}),
    "softmax_xent": ("softmax_with_cross_entropy",
                     {"Logits": [_f32(6, 10, scale=3.0)], "Label": [_ids((6, 1), 10)]},
                     {"Loss": [_f32(6, 1)]}, {"soft_label": False, "ignore_index": -100, "axis": -1}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_parity(case):
    op_type, inputs, out_grads, attrs = GRAD_CASES[case]
    _grad_both(op_type, inputs, out_grads, attrs)


def test_layer_norm_grad_with_two_out_grads():
    """Gradients arriving at two outputs of one op add up, as in jax.vjp."""
    inputs = {"X": [_f32(4, 6, scale=2.0)], "Scale": [_f32(6)], "Bias": [_f32(6)]}
    _grad_both("layer_norm", inputs, {"Y": [_f32(4, 6)], "Mean": [_f32(4)]},
               {"epsilon": 1e-5, "begin_norm_axis": 1})


def test_grad_kernel_differentiates_under_no_grad():
    """The executor runs blocks under torch.no_grad(); a grad op still
    differentiates."""
    inputs = {"X": [torch.from_numpy(_f32(3, 4))]}
    with torch.no_grad():
        out = treg.get_kernel("tanh_grad")(
            dict(inputs, **{"Out@GRAD": [torch.ones(3, 4)]}),
            {"__fwd_output_slots__": ("Out",), "__grad_input_slots__": ("X",)}, CPU)
    (g,) = out["X@GRAD"]
    np.testing.assert_allclose(g.numpy(), 1 - np.tanh(inputs["X"][0].numpy()) ** 2, **FP32)


def _attn_inputs(n, h, s, d, with_mask, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(n, h, s, d).astype("float32") for _ in range(3))
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if with_mask:
        lens = rng.randint(1, s + 1, n)
        lens[0] = s  # one all-real row
        inputs["Mask"] = [(np.arange(s)[None, :] < lens[:, None]).astype("float32")]
    return inputs, rng.randn(n, h, s, d).astype("float32")


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_grad_parity(with_mask, causal):
    inputs, d_out = _attn_inputs(3, 4, 16, 8, with_mask, seed=31)
    res = _grad_both("fused_attention", inputs, {"Out": [d_out]},
                     {"causal": causal, "scale": 1 / np.sqrt(8)})
    assert set(res) == {"Q@GRAD", "K@GRAD", "V@GRAD"}  # none to Mask


def test_fused_attention_grad_ragged():
    inputs, d_out = _attn_inputs(2, 3, 13, 5, True, seed=33)
    _grad_both("fused_attention", inputs, {"Out": [d_out]}, {"causal": True, "scale": 0.3})


# ---------------------------------------------------------------------------
# the fused attention gradient: plain backward, autograd.Function, meta path
# ---------------------------------------------------------------------------
def _qkv_mask(dtype, n=2, h=3, s=11, d=8, seed=0, requires_grad=False):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(n, h, s, d, generator=g, dtype=dtype).requires_grad_(requires_grad)
               for _ in range(3))
    mask = torch.ones(n, s, dtype=dtype)
    mask[1, 7:] = 0
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_attention_gradcheck_float64(causal):
    """torch.autograd.gradcheck through fused_attention_fwd: on a CPU
    tensor the Function's forward and backward are the plain versions."""
    q, k, v, mask = _qkv_mask(torch.float64, s=7, d=4, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.fused_attention_fwd(a, b, c, mask, causal, 0.45), (q, k, v))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_backward_bf16_against_fp32(causal):
    q, k, v, mask = _qkv_mask(torch.float32, seed=4)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    scale = 1 / np.sqrt(8)
    outs = {}
    for name, (a, b, c, do) in {"fp32": (qb.float(), kb.float(), vb.float(), d_out.bfloat16().float()),
                                "bf16": (qb, kb, vb, d_out.bfloat16())}.items():
        out, stats = fa.fused_attention_plain(a, b, c, mask, causal, scale, return_stats=True)
        outs[name] = fa.fused_attention_bwd_plain(a, b, c, mask, causal, scale, out, do, stats)
    for g32, g16 in zip(outs["fp32"], outs["bf16"]):
        assert g16.dtype == torch.bfloat16
        torch.testing.assert_close(g16.float(), g32, **BF16)


def test_plain_lse_is_logsumexp_of_scores():
    q, k, v, mask = _qkv_mask(torch.float32, seed=6)
    out, stats = fa.fused_attention_plain(q, k, v, mask, True, 0.3, return_stats=True)
    assert torch.equal(out, fa.fused_attention_plain(q, k, v, mask, True, 0.3))
    assert stats.shape == (2, 2, 3, 11) and stats.dtype == torch.float32
    lse = fa.row_lse(stats)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.3
    s = s + torch.triu(torch.full((11, 11), -1e9), 1) + ((mask - 1) * 1e9)[:, None, None, :]
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), **FP32)


def test_function_backward_uses_plain_on_cpu_and_launches_nothing(monkeypatch):
    q, k, v, mask = _qkv_mask(torch.float32, seed=7, requires_grad=True)
    calls = []
    plain = fa.fused_attention_bwd_plain

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(fa, "fused_attention_bwd_plain", spy)
    kernels.reset_launch_counts()
    out = fa.fused_attention_fwd(q, k, v, mask, False, 0.5)
    out.sum().backward()
    assert len(calls) == 1
    assert q.grad is not None and k.grad is not None and v.grad is not None
    assert kernels.launch_counts() == {}


def test_function_meta_gives_shape_only_grads():
    q, k, v, mask = (t.to("meta") for t in _qkv_mask(torch.float32, s=9, d=5))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = fa.fused_attention_fwd(q, k, v, mask, True, 0.5)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 3, 9, 5)
    gq, gk, gv = torch.autograd.grad([out], [q, k, v], [torch.empty_like(out)])
    for g, t in ((gq, q), (gk, k), (gv, v)):
        assert g.device.type == "meta" and g.shape == t.shape and g.dtype == t.dtype
    out, stats = fa.fused_attention_fwd(q, k, v, mask, False, 0.5, return_stats=True)
    assert stats.device.type == "meta" and tuple(stats.shape) == (2, 2, 3, 9)
    assert stats.dtype == torch.float32


def test_grad_op_shape_inference_over_meta():
    """A fused_attention_grad op appended to a block gets its output
    shapes from the grad kernel run over meta tensors."""
    import paddle_tpu_torch as tfluid

    main = tfluid.Program()
    blk = main.global_block()
    for name in ("q", "k", "v", "o@GRAD"):
        blk.create_var(name=name, shape=(-1, 2, 6, 4), dtype="float32")
    for name in ("q@GRAD", "k@GRAD", "v@GRAD"):
        blk.create_var(name=name, dtype="float32")
    blk.append_op("fused_attention_grad",
                  inputs={"Q": ["q"], "K": ["k"], "V": ["v"], "Out@GRAD": ["o@GRAD"]},
                  outputs={"Q@GRAD": ["q@GRAD"], "K@GRAD": ["k@GRAD"], "V@GRAD": ["v@GRAD"]},
                  attrs={"causal": False, "scale": 0.5, "__fwd_output_slots__": ("Out",),
                         "__grad_input_slots__": ("Q", "K", "V")})
    for name in ("q@GRAD", "k@GRAD", "v@GRAD"):
        assert blk.var(name).shape == (-1, 2, 6, 4)


def test_per_kernel_wrappers_on_cpu_give_the_plain_pieces():
    """fused_attention_bwd_dkv and fused_attention_bwd_dq, the wrappers of
    the two backward kernels, take the plain backward on a CPU tensor and
    launch nothing."""
    q, k, v, mask = _qkv_mask(torch.float32, seed=8)
    d_out = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    out, stats = fa.fused_attention_plain(q, k, v, mask, True, 0.35, return_stats=True)
    di = (out * d_out).sum(-1)
    kernels.reset_launch_counts()
    dk, dv = fa.fused_attention_bwd_dkv(q, k, v, mask, True, 0.35, d_out, stats, di)
    dq = fa.fused_attention_bwd_dq(q, k, v, mask, True, 0.35, d_out, stats, di)
    assert kernels.launch_counts() == {}
    rq, rk, rv = fa.fused_attention_bwd_plain(q, k, v, mask, True, 0.35, out, d_out, stats)
    for g, r in ((dq, rq), (dk, rk), (dv, rv)):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
