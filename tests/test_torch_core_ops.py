"""The math, tensor and plain nn op types of paddle_tpu_torch against
paddle_tpu's, forward and vjp (``torch_parity_util.op_parity``: the JAX
kernel and ``jax.vjp`` against the port's kernel and autograd, on the
same numpy inputs made from a seed, with seeded cotangents).

Tolerances: rtol 1e-5, atol 1e-6 for fp32 elementwise work, reductions
and gathers (the two frameworks round transcendental functions and sums
differently by an ulp or so); rtol 1e-4, atol 1e-5 where a convolution,
an interpolation or a contraction sums tens of products in another
order (conv2d_transpose, depthwise_conv2d, bilinear_interp,
bilinear_tensor_product, spectral_norm's power iteration); integer and
bool outputs exactly.  Ids are int32 in the JAX package (its 64-bit
types are off) and int64 in the port, so they compare as numbers.
Inputs keep away from the points where a function's derivative jumps
(0 for prelu, maxout's and the reductions' ties are made on purpose
where the JAX op's rule for them is the thing held).

The random op types (``uniform_random_batch_size_like``, ``sampling_id``)
cannot match jax.random's bits: they are held by their distribution
(moments, and a chi-square test of the drawn ids at p > 1e-3).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from torch_parity_util import op_parity

CONV_TOL = dict(rtol=1e-4, atol=1e-5)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype("float32")


def _away_from_zero(rng, *shape):
    x = _f32(rng, *shape)
    return np.where(np.abs(x) < 0.1, 0.1 * np.sign(x) + 0.1 * (x == 0), x).astype("float32")


def _cases():
    """name -> (op type, inputs, attrs, grad slots, tolerance)."""
    rng = np.random.RandomState(11)
    c = {}
    x345 = _f32(rng, 3, 4, 5)
    ties = (np.round(2 * _f32(rng, 4, 6)) / 2).astype("float32")  # many equal values a row
    for op in ("reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "reduce_sum"):
        c[op + "_dim1"] = (op, {"X": [x345]}, {"dim": [1], "keep_dim": False}, ("X",), {})
        c[op + "_dims_keep"] = (op, {"X": [x345]}, {"dim": [-1, 0], "keep_dim": True}, ("X",), {})
        c[op + "_all"] = (op, {"X": [x345]}, {"dim": [0], "reduce_all": True}, ("X",), {})
    for op in ("reduce_max", "reduce_min"):
        c[op + "_ties"] = (op, {"X": [ties]}, {"dim": [1]}, ("X",), {})
        c[op + "_ties_all"] = (op, {"X": [ties]}, {"reduce_all": True}, ("X",), {})
    b = rng.rand(3, 4, 5) > 0.3
    for op in ("reduce_all", "reduce_any"):
        c[op + "_dim"] = (op, {"X": [b]}, {"dim": [2]}, (), {})
        c[op + "_all_keep"] = (op, {"X": [b]}, {"reduce_all": True, "keep_dim": True}, (), {})
    # mod and floordiv on operands of both signs, off the points where x / y
    # is a whole number
    xm = _f32(rng, 4, 6, scale=5.0)
    ym = (np.sign(_f32(rng, 4, 6)) * (1.3 + rng.rand(4, 6))).astype("float32")
    c["elementwise_mod"] = ("elementwise_mod", {"X": [xm], "Y": [ym]}, {"axis": -1}, ("X", "Y"), {})
    c["elementwise_mod_bcast"] = ("elementwise_mod", {"X": [xm], "Y": [ym[0]]}, {"axis": 1},
                                  ("X", "Y"), {})
    c["elementwise_floordiv"] = ("elementwise_floordiv", {"X": [xm], "Y": [ym]}, {"axis": -1},
                                 ("X", "Y"), {})
    xi = rng.randint(-20, 20, (4, 6)).astype("int32")
    yi = (rng.choice([-1, 1], (4, 6)) * rng.randint(1, 7, (4, 6))).astype("int32")
    c["elementwise_mod_int"] = ("elementwise_mod", {"X": [xi], "Y": [yi]}, {}, (), {})
    c["elementwise_floordiv_int"] = ("elementwise_floordiv", {"X": [xi], "Y": [yi]}, {}, (), {})
    pos = (np.abs(_f32(rng, 3, 5)) + 0.2).astype("float32")
    c["pow"] = ("pow", {"X": [pos]}, {"factor": 2.5}, ("X",), {})
    c["pow_int_factor"] = ("pow", {"X": [_f32(rng, 3, 5)]}, {"factor": 3.0}, ("X",), {})
    bad = _f32(rng, 2, 3)
    bad[1, 2] = np.inf
    c["isfinite_true"] = ("isfinite", {"X": [_f32(rng, 2, 3)]}, {}, (), {})
    c["isfinite_inf"] = ("isfinite", {"X": [bad]}, {}, (), {})

    # tensor ops
    x234 = _f32(rng, 2, 3, 4)
    c["transpose"] = ("transpose", {"X": [x234]}, {"axis": [2, 0, 1]}, ("X",), {})
    sq = _f32(rng, 3, 1, 4, 1)
    c["squeeze2_axes"] = ("squeeze2", {"X": [sq]}, {"axes": [1, 0]}, ("X",), {})
    c["squeeze2_all"] = ("squeeze2", {"X": [sq]}, {"axes": []}, ("X",), {})
    c["squeeze2_negative"] = ("squeeze2", {"X": [sq]}, {"axes": [-1]}, ("X",), {})
    c["unsqueeze2"] = ("unsqueeze2", {"X": [x234]}, {"axes": [2, 0]}, ("X",), {})
    c["flatten2"] = ("flatten2", {"X": [_f32(rng, 2, 3, 4, 5)]}, {"axis": 2}, ("X",), {})
    x264 = _f32(rng, 2, 6, 4)
    c["split_num"] = ("split", {"X": [x264]}, {"num": 3, "axis": 1}, ("X",), {})
    c["split_sections"] = ("split", {"X": [x264]}, {"sections": [1, 2, 3], "axis": 1, "num": 0},
                           ("X",), {})
    c["stack"] = ("stack", {"X": [_f32(rng, 3, 4) for _ in range(3)]}, {"axis": 1}, ("X",), {})
    c["unstack"] = ("unstack", {"X": [x234]}, {"axis": 1}, ("X",), {})
    x68 = _f32(rng, 6, 8)
    c["strided_slice"] = ("strided_slice", {"Input": [x68]},
                          {"axes": [0, 1], "starts": [1, 0], "ends": [6, 7], "strides": [2, 3]},
                          ("Input",), {})
    c["strided_slice_negative"] = ("strided_slice", {"Input": [x68]},
                                   {"axes": [1, 0], "starts": [6, -1], "ends": [0, -7],
                                    "strides": [-2, -1]}, ("Input",), {})
    c["shape"] = ("shape", {"Input": [x234]}, {}, (), {})
    c["pad"] = ("pad", {"X": [x234]}, {"paddings": [1, 0, 0, 2, 2, 1], "pad_value": 0.5},
                ("X",), {})
    x4 = _f32(rng, 2, 3, 5, 6)
    for mode in ("constant", "reflect", "edge"):
        c["pad2d_" + mode] = ("pad2d", {"X": [x4]},
                              {"paddings": [1, 2, 3, 0], "mode": mode, "pad_value": -1.0},
                              ("X",), {})
    ids = rng.randint(0, 10, (3, 2)).astype("int64")
    c["lookup_table_v2"] = ("lookup_table_v2", {"W": [_f32(rng, 10, 4)], "Ids": [ids]}, {},
                            ("W",), {})
    c["lookup_table_v2_pad"] = ("lookup_table_v2", {"W": [_f32(rng, 10, 4)], "Ids": [ids[..., None]]},
                                {"padding_idx": int(ids[0, 0])}, ("W",), {})
    c["one_hot"] = ("one_hot", {"X": [np.array([[0], [3], [7], [-1], [2]], "int64")]},
                    {"depth": 4}, (), {})
    c["gather_nd"] = ("gather_nd", {"X": [_f32(rng, 4, 5, 6)],
                                    "Index": [np.array([[0, 1], [3, 4], [0, 1]], "int64")]},
                      {}, ("X",), {})
    c["scatter_overwrite"] = ("scatter", {"X": [_f32(rng, 6, 3)],
                                          "Ids": [np.array([4, 0, 2], "int64")],
                                          "Updates": [_f32(rng, 3, 3)]},
                              {"overwrite": True}, ("X", "Updates"), {})
    c["scatter_add"] = ("scatter", {"X": [_f32(rng, 6, 3)], "Ids": [np.array([4, 0, 4, 1], "int64")],
                                    "Updates": [_f32(rng, 4, 3)]},
                        {"overwrite": False}, ("X", "Updates"), {})
    c["arg_min"] = ("arg_min", {"X": [ties]}, {"axis": 1}, (), {})
    c["arg_min_axis0"] = ("arg_min", {"X": [ties]}, {"axis": 0}, (), {})
    for desc in (False, True):
        c["argsort_%s" % ("desc" if desc else "asc")] = (
            "argsort", {"X": [ties]}, {"axis": -1, "descending": desc}, (), {})
        c["argsort_axis0_%s" % ("desc" if desc else "asc")] = (
            "argsort", {"X": [ties]}, {"axis": 0, "descending": desc}, (), {})
    for attrs in ({"axis": 1}, {"axis": 2, "exclusive": True}, {"axis": 0, "reverse": True},
                  {"axis": 1, "reverse": True, "exclusive": True}, {"flatten": True}):
        name = "cumsum_" + "_".join(k for k, v in sorted(attrs.items()) if v is True) or "cumsum"
        c[name.rstrip("_") + "_%d" % attrs.get("axis", 9)] = ("cumsum", {"X": [x234]}, attrs,
                                                              ("X",), {})
    c["crop_attrs"] = ("crop", {"X": [_f32(rng, 5, 6)]}, {"offsets": [1, 2], "shape": [3, 3]},
                       ("X",), {})
    c["crop_y"] = ("crop", {"X": [_f32(rng, 5, 6)], "Y": [_f32(rng, 2, 4)]}, {"offsets": [3, 1]},
                   ("X",), {})
    c["crop_clamped"] = ("crop", {"X": [_f32(rng, 5, 6)]}, {"offsets": [4, 5], "shape": [3, 3]},
                         ("X",), {})
    c["crop_tensor"] = ("crop_tensor", {"X": [_f32(rng, 5, 6)]},
                        {"offsets": [0, 2], "shape": [4, 4]}, ("X",), {})
    c["pad_constant_like"] = ("pad_constant_like", {"X": [_f32(rng, 4, 5)], "Y": [_f32(rng, 2, 3)]},
                              {"pad_value": 1.5}, ("Y",), {})
    c["linspace"] = ("linspace", {"Start": [np.array([-1.5], "float32")],
                                  "Stop": [np.array([2.0], "float32")],
                                  "Num": [np.array([7], "int32")]}, {"dtype": "float32"}, (), {})
    c["meshgrid"] = ("meshgrid", {"X": [_f32(rng, 3), _f32(rng, 4)]}, {}, ("X",), {})
    c["roll"] = ("roll", {"X": [x234]}, {"shifts": [1, -2], "axis": [0, 2]}, ("X",), {})
    c["roll_flat"] = ("roll", {"X": [x234]}, {"shifts": [5]}, ("X",), {})

    # plain nn ops
    xa = _away_from_zero(rng, 2, 3, 4, 4)
    c["prelu_all"] = ("prelu", {"X": [xa], "Alpha": [np.array([0.25], "float32")]},
                      {"mode": "all"}, ("X", "Alpha"), {})
    c["prelu_channel"] = ("prelu", {"X": [xa], "Alpha": [_f32(rng, 3)]}, {"mode": "channel"},
                          ("X", "Alpha"), {})
    c["prelu_element"] = ("prelu", {"X": [xa], "Alpha": [_f32(rng, 3, 4, 4)]},
                          {"mode": "element"}, ("X", "Alpha"), {})
    c["prelu_channel_placeholder"] = ("prelu_channel", {"X": [xa]}, {}, ("X",), {})
    c["log_softmax"] = ("log_softmax", {"X": [_f32(rng, 4, 9)]}, {"axis": -1}, ("X",), {})
    c["log_softmax_axis1"] = ("log_softmax", {"X": [x234]}, {"axis": 1}, ("X",), {})
    for fmt, xs in (("NCHW", (2, 4, 7, 7)), ("NHWC", (2, 7, 7, 4))):
        c["depthwise_conv2d_" + fmt] = (
            "depthwise_conv2d", {"Input": [_f32(rng, *xs)], "Filter": [_f32(rng, 4, 1, 3, 3)]},
            {"strides": [2, 1], "paddings": [1, 1], "dilations": [1, 1], "data_format": fmt},
            ("Input", "Filter"), CONV_TOL)
    c["conv2d_transpose"] = ("conv2d_transpose",
                             {"Input": [_f32(rng, 2, 3, 5, 4)], "Filter": [_f32(rng, 3, 4, 3, 3)]},
                             {"strides": [2, 2], "paddings": [1, 0], "dilations": [1, 1]},
                             ("Input", "Filter"), CONV_TOL)
    c["conv2d_transpose_dilated"] = ("conv2d_transpose",
                                     {"Input": [_f32(rng, 1, 2, 4, 4)],
                                      "Filter": [_f32(rng, 2, 3, 2, 3)]},
                                     {"strides": [1, 2], "paddings": [0, 1], "dilations": [2, 1]},
                                     ("Input", "Filter"), CONV_TOL)
    c["group_norm"] = ("group_norm", {"X": [_f32(rng, 2, 6, 4, 3)], "Scale": [_f32(rng, 6)],
                                      "Bias": [_f32(rng, 6)]},
                       {"groups": 3, "epsilon": 1e-5}, ("X", "Scale", "Bias"), CONV_TOL)
    xl, yl = _f32(rng, 8, 1, scale=2.0), _f32(rng, 8, 1, scale=2.0)
    c["huber_loss"] = ("huber_loss", {"X": [xl], "Y": [yl]}, {"delta": 1.0}, ("X",), {})
    c["smooth_l1_loss"] = ("smooth_l1_loss", {"X": [_f32(rng, 6, 4)], "Y": [_f32(rng, 6, 4)]},
                           {"sigma": 1.5}, ("X",), {})
    probs = (0.05 + 0.9 * rng.rand(8, 1)).astype("float32")
    c["log_loss"] = ("log_loss", {"Predicted": [probs],
                                  "Labels": [rng.randint(0, 2, (8, 1)).astype("float32")]},
                     {"epsilon": 1e-4}, ("Predicted",), {})
    for op in ("l2_normalize", "norm"):
        c[op] = (op, {"X": [_f32(rng, 4, 6)]}, {"axis": 1, "epsilon": 1e-10}, ("X",), {})
    c["l2_normalize_axis0"] = ("l2_normalize", {"X": [x234]}, {"axis": 0, "epsilon": 1e-12},
                               ("X",), {})
    c["maxout"] = ("maxout", {"X": [_f32(rng, 2, 6, 3, 3)]}, {"groups": 2}, ("X",), {})
    xr = _f32(rng, 2, 3, 4, 5)
    for method in ("bilinear", "nearest"):
        op = method + "_interp"
        for align in (True, False):
            tag = "%s_%s" % (method, "align" if align else "half")
            c[tag + "_up"] = (op, {"X": [xr]}, {"out_h": 7, "out_w": 9, "align_corners": align},
                              ("X",), CONV_TOL)
            c[tag + "_down"] = (op, {"X": [xr]}, {"out_h": 3, "out_w": 2, "align_corners": align},
                                ("X",), CONV_TOL)
        c[method + "_scale"] = (op, {"X": [xr]}, {"scale": 2.0}, ("X",), CONV_TOL)
        c[method + "_to_one"] = (op, {"X": [xr]}, {"out_h": 1, "out_w": 3}, ("X",), CONV_TOL)
    c["pixel_shuffle"] = ("pixel_shuffle", {"X": [_f32(rng, 2, 8, 3, 3)]}, {"upscale_factor": 2},
                          ("X",), {})
    c["shuffle_channel"] = ("shuffle_channel", {"X": [_f32(rng, 2, 6, 3, 3)]}, {"group": 3},
                            ("X",), {})
    c["spectral_norm"] = ("spectral_norm", {"Weight": [_f32(rng, 6, 4, 2)], "U": [_f32(rng, 4)],
                                            "V": [_f32(rng, 12)]},
                          {"dim": 1, "power_iters": 2, "eps": 1e-12}, ("Weight",), CONV_TOL)
    c["data_norm"] = ("data_norm", {"X": [_f32(rng, 8, 5)],
                                    "BatchSize": [(1e2 + rng.rand(5)).astype("float32")],
                                    "BatchSum": [_f32(rng, 5)],
                                    "BatchSquareSum": [(1e2 + rng.rand(5)).astype("float32")]},
                      {"epsilon": 1e-4}, ("X", "BatchSize", "BatchSum", "BatchSquareSum"), {})
    c["data_norm_nchw"] = ("data_norm", {"X": [_f32(rng, 4, 3, 2, 2)],
                                         "BatchSize": [np.full(3, 50.0, "float32")],
                                         "BatchSum": [_f32(rng, 3)],
                                         "BatchSquareSum": [np.full(3, 60.0, "float32")]},
                           {"epsilon": 1e-4, "data_layout": "NCHW"},
                           ("X", "BatchSize", "BatchSum", "BatchSquareSum"), {})
    c["bilinear_tensor_product"] = ("bilinear_tensor_product",
                                    {"X": [_f32(rng, 5, 4)], "Y": [_f32(rng, 5, 3)],
                                     "Weight": [_f32(rng, 2, 4, 3)], "Bias": [_f32(rng, 1, 2)]},
                                    {}, ("X", "Y", "Weight", "Bias"), CONV_TOL)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_vjp_match_the_jax_op(case):
    """Every output, and the vjp into each float input of the grad slots;
    an ``XShape`` output carries no data (the reference's companion of
    the input's shape) and no gradient."""
    op_type, inputs, attrs, grad_slots, tol = CASES[case]
    out_slots = ["Out"] if op_type in ("squeeze2", "unsqueeze2", "flatten2") else None
    op_parity(op_type, inputs, attrs, grad_slots=grad_slots, out_slots=out_slots, **(tol or {}))


@pytest.mark.parametrize("op_type,groups,in_c,out_per_group", [
    ("conv2d_transpose", 2, 4, 3), ("conv2d_transpose", 3, 6, 2),
    ("depthwise_conv2d_transpose", 4, 4, 1)])
def test_grouped_conv2d_transpose_matches_the_jax_op_group_by_group(op_type, groups, in_c,
                                                                     out_per_group):
    """The JAX op ignores ``groups`` (ROADMAP queue C); the port passes it
    to ``F.conv_transpose2d``.  Held against the JAX op applied group by
    group: Input split by channel and Filter ([in_c, out_c / groups, kh,
    kw]) along its first axis, each part through the JAX
    conv2d_transpose, the outputs joined by channel.  Forward and vjp at
    CONV_TOL."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    x, w = _f32(rng, 2, in_c, 5, 4), _f32(rng, in_c, out_per_group, 3, 3)
    attrs = {"strides": [2, 1], "paddings": [1, 0], "dilations": [1, 2], "groups": groups}
    jk = jreg.get_kernel("conv2d_transpose")

    def by_group(x, w):
        return jnp.concatenate([jk({"Input": [a], "Filter": [b]}, attrs)["Output"]
                                for a, b in zip(jnp.split(x, groups, 1), jnp.split(w, groups, 0))],
                               axis=1)

    jout, vjp = jax.vjp(by_group, jnp.asarray(x), jnp.asarray(w))
    cot = rng.randn(*jout.shape).astype("float32")
    jdx, jdw = vjp(jnp.asarray(cot))
    tx, tw = (torch.from_numpy(v).requires_grad_(True) for v in (x, w))
    with torch.enable_grad():
        tout = treg.get_kernel(op_type)({"Input": [tx], "Filter": [tw]}, attrs,
                                        torch.device("cpu"))["Output"]
        tdx, tdw = torch.autograd.grad(tout, [tx, tw], torch.from_numpy(cot))
    assert tout.shape == jout.shape == (2, groups * out_per_group, 9, 8)
    for t, j in ((tout, jout), (tdx, jdx), (tdw, jdw)):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **CONV_TOL)


DTYPES = {"reduce_all_dim": torch.bool, "isfinite_inf": torch.bool, "one_hot": torch.float32,
          "shape": torch.int32, "arg_min": torch.int64, "elementwise_mod_int": torch.int32,
          "elementwise_floordiv_int": torch.int32, "linspace": torch.float32}


@pytest.mark.parametrize("case", sorted(DTYPES))
def test_output_dtypes(case):
    """bool reductions and isfinite, float32 one_hot, int32 shape; the
    port's ids are int64 (the JAX package's int32 is its x64 switch)."""
    op_type, inputs, attrs, _, _ = CASES[case]
    tin = {s: [torch.from_numpy(np.ascontiguousarray(v)) for v in vs] for s, vs in inputs.items()}
    out = treg.get_kernel(op_type)(tin, attrs, torch.device("cpu"))
    first = next(iter(out.values()))
    first = first[0] if isinstance(first, list) else first
    assert first.dtype == DTYPES[case]


def test_cumsum_exclusive_negative_axis():
    """An exclusive cumsum along axis -1 keeps X's shape.  The JAX op pads
    that axis and then slices only a non-negative axis back, so it returns
    one element too many there (ROADMAP queue C); the port is held to
    numpy's sums instead."""
    x = np.random.RandomState(2).randn(2, 3, 4).astype("float32")
    out = treg.get_kernel("cumsum")({"X": [torch.from_numpy(x)]}, {"axis": -1, "exclusive": True},
                                    torch.device("cpu"))["Out"].numpy()
    want = np.concatenate([np.zeros((2, 3, 1), "float32"), np.cumsum(x, -1)[..., :-1]], -1)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)
    jout = jreg.get_kernel("cumsum")({"X": [x]}, {"axis": -1, "exclusive": True})["Out"]
    assert np.shape(jout) == (2, 3, 5)


def test_isfinite_values():
    k = treg.get_kernel("isfinite")
    for v, want in ((1.0, True), (np.inf, False), (np.nan, False)):
        out = k({"X": [torch.tensor([0.0, v])]}, {}, torch.device("cpu"))["Out"]
        assert out.shape == (1,) and bool(out[0]) is want


def test_argsort_indices_and_values():
    """Ties: ascending keeps the lower index first, descending the higher
    (the reversed stable order, as the JAX op)."""
    x = torch.tensor([[2.0, 1.0, 2.0, 1.0]])
    k = treg.get_kernel("argsort")
    asc = k({"X": [x]}, {"axis": -1}, torch.device("cpu"))
    desc = k({"X": [x]}, {"axis": -1, "descending": True}, torch.device("cpu"))
    assert asc["Indices"].tolist() == [[1, 3, 0, 2]] and desc["Indices"].tolist() == [[2, 0, 3, 1]]
    assert desc["Out"].tolist() == [[2.0, 2.0, 1.0, 1.0]]


ALIASES = ["squeeze", "unsqueeze", "flatten", "fill_zeros_like2", "lstm", "lstmp", "gru", "fill",
           "depthwise_conv2d_transpose"]


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_names_the_same_op(alias):
    """The alias lines of the JAX package's extended_ops: each name is the
    very OpDef of the type it stands for, in both packages."""
    targets = {"squeeze": "squeeze2", "unsqueeze": "unsqueeze2", "flatten": "flatten2",
               "fill_zeros_like2": "fill_zeros_like", "lstm": "dynamic_lstm",
               "lstmp": "dynamic_lstmp", "gru": "dynamic_gru", "fill": "fill_constant",
               "depthwise_conv2d_transpose": "conv2d_transpose"}
    assert treg.get_op(alias) is treg.get_op(targets[alias])
    assert jreg.get_op(alias) is jreg.get_op(targets[alias])


@pytest.mark.parametrize("alias,inputs,attrs", [
    ("squeeze", {"X": [np.ones((2, 1, 3), "float32")]}, {"axes": [1]}),
    ("unsqueeze", {"X": [np.ones((2, 3), "float32")]}, {"axes": [1]}),
    ("flatten", {"X": [np.arange(24, dtype="float32").reshape(2, 3, 4)]}, {"axis": 1}),
    ("fill_zeros_like2", {"X": [np.ones((2, 3), "float32")]}, {}),
    ("fill", {}, {"shape": [2, 3], "dtype": "float32", "value": 1.5}),
    ("depthwise_conv2d_transpose", {"Input": [np.ones((1, 2, 3, 3), "float32")],
                                    "Filter": [np.ones((2, 1, 2, 2), "float32")]},
     {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1]}),
])
def test_alias_runs_as_its_type(alias, inputs, attrs):
    op_parity(alias, inputs, attrs)


def test_every_new_type_is_registered():
    """The op types of this slice are in the port's registry, as in the
    JAX package's."""
    new = {c[0] for c in CASES.values()} | set(ALIASES) | {
        "uniform_random_batch_size_like", "sampling_id", "py_func", "load"}
    for t in new:
        assert t in treg._REGISTRY and t in jreg._REGISTRY, t


def _chi2_p(counts, probs):
    from scipy import stats

    n = counts.sum()
    return stats.chisquare(counts, n * probs).pvalue


def test_sampling_id_by_its_distribution():
    """4,000 rows of one distribution: the drawn ids' counts against it
    (chi-square, p > 1e-3), the same draws again for the same seed, and
    the seed-0 default (7919, the registration the JAX package keeps)
    reproducible; ids int64 of shape [rows]."""
    probs = np.array([0.1, 0.4, 0.05, 0.3, 0.15])
    x = torch.from_numpy(np.tile(probs, (4000, 1)).astype("float32"))
    k = treg.get_kernel("sampling_id")
    cpu = torch.device("cpu")
    a = k({"X": [x]}, {"seed": 5}, cpu)["Out"]
    b = k({"X": [x]}, {"seed": 5}, cpu)["Out"]
    assert a.dtype == torch.int64 and a.shape == (4000,)
    assert torch.equal(a, b)
    assert torch.equal(k({"X": [x]}, {"seed": 0}, cpu)["Out"], k({"X": [x]}, {"seed": 7919}, cpu)["Out"])
    counts = np.bincount(a.numpy(), minlength=5)
    assert _chi2_p(counts, probs) > 1e-3
    jout = np.asarray(jreg.get_kernel("sampling_id")({"X": [x.numpy()]}, {"seed": 5})["Out"])
    assert jout.shape == (4000,)
    assert _chi2_p(np.bincount(jout, minlength=5), probs) > 1e-3
    assert treg.get_op("sampling_id").random


def test_uniform_random_batch_size_like_by_its_distribution():
    """Shape from Input's batch, values in [min, max) with the uniform's
    mean and variance (within 5 standard errors), the same as the JAX
    op's shape and dtype."""
    inp = np.zeros((500, 3), "float32")
    attrs = {"shape": [-1, 40], "min": -2.0, "max": 3.0, "seed": 9, "dtype": "float32"}
    out = treg.get_kernel("uniform_random_batch_size_like")(
        {"Input": [torch.from_numpy(inp)]}, attrs, torch.device("cpu"))["Out"].numpy()
    jout = np.asarray(jreg.get_kernel("uniform_random_batch_size_like")({"Input": [inp]}, attrs)["Out"])
    assert out.shape == jout.shape == (500, 40) and out.dtype == jout.dtype
    assert out.min() >= -2.0 and out.max() < 3.0
    n, mean, var = out.size, 0.5, 25.0 / 12
    assert abs(out.mean() - mean) < 5 * np.sqrt(var / n)
    assert abs(out.var() - var) < 5 * np.sqrt((5.0 ** 4 / 80 - var ** 2) / n)  # mu4 = (b-a)^4/80
    assert treg.get_op("uniform_random_batch_size_like").random


def test_host_read_and_random_ops_keep_their_plans_eager():
    """py_func, load and linspace read on the host; sampling_id and
    uniform_random_batch_size_like draw from a generator: a plan holding
    any of them stays on the interpreter."""
    for t in ("py_func", "load", "linspace"):
        assert treg.get_op(t).host_read, t
    for t in ("sampling_id", "uniform_random_batch_size_like"):
        assert treg.get_op(t).random, t
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [5])
        ids = tfluid.layers.data("ids", [1], dtype="int64")
        main.global_block().append_op(
            "sampling_id", inputs={"X": [x]},
            outputs={"Out": [main.global_block().create_var(name="sid", dtype="int64")]},
            attrs={"seed": 3})
    plan = tfluid.Executor(tfluid.CPUPlace())._analyze(main, ("ids", "x"), ("sid",))
    assert plan.eager_ops == ("sampling_id",)
