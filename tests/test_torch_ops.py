"""Op parity: each op kernel of paddle_tpu_torch against paddle_tpu's on
the same numpy inputs.

fp32 ops compare at atol 1e-5, rtol 1e-5 (the two frameworks sum in
different orders); bf16 attention at atol 2e-2, one to two bf16 ulps at
unit scale.  The JAX side runs on the CPU as its own tests run it: its
``fused_attention`` takes the einsum branch there, which is the plain
reference the port's kernel is held to.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

CPU = torch.device("cpu")
FP32 = dict(atol=1e-5, rtol=1e-5)


def _run_both(op_type, inputs, attrs, bf16=False):
    """Run the op in both packages; returns {slot: (jax_out, port_out)} as
    float64/int64 numpy."""
    jin = {s: [jnp.asarray(a, dtype=jnp.bfloat16) if bf16 and a.dtype.kind == "f"
               else jnp.asarray(a) for a in arrs] for s, arrs in inputs.items()}
    tin = {s: [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
               if bf16 and a.dtype.kind == "f" else torch.from_numpy(np.ascontiguousarray(a))
               for a in arrs] for s, arrs in inputs.items()}
    jout = jreg.get_kernel(op_type)(jin, dict(attrs))
    tout = treg.get_kernel(op_type)(tin, dict(attrs), CPU)
    res = {}
    for slot, jv in jout.items():
        tv = tout[slot]
        jv = jv[0] if isinstance(jv, (list, tuple)) else jv
        tv = tv[0] if isinstance(tv, (list, tuple)) else tv
        jn = np.asarray(jnp.asarray(jv, dtype=jnp.float32) if bf16 else jv)
        tn = (tv.float() if tv.dtype == torch.bfloat16 else tv).numpy()
        res[slot] = (jn, tn)
    return res


def _assert_close(res, **tol):
    for slot, (j, t) in res.items():
        assert j.shape == t.shape, (slot, j.shape, t.shape)
        if j.size:
            np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                                       err_msg=slot, **tol)


RNG = np.random.RandomState(7)


def _f32(*shape):
    return RNG.randn(*shape).astype("float32")


ELEMENTWISE_CASES = {
    "same_shape": ({"X": [_f32(2, 3, 4)], "Y": [_f32(2, 3, 4)]}, {"axis": -1}),
    "trailing": ({"X": [_f32(2, 3, 4)], "Y": [_f32(3, 4)]}, {"axis": -1}),
    "axis1": ({"X": [_f32(2, 3, 4)], "Y": [_f32(3)]}, {"axis": 1}),
    "bias_axis2": ({"X": [_f32(2, 5, 8)], "Y": [_f32(8)]}, {"axis": 2}),
}


@pytest.mark.parametrize("case", sorted(ELEMENTWISE_CASES))
def test_elementwise_add_parity(case):
    inputs, attrs = ELEMENTWISE_CASES[case]
    _assert_close(_run_both("elementwise_add", inputs, attrs), **FP32)


MUL_CASES = {
    "fc3": ({"X": [_f32(2, 3, 16)], "Y": [_f32(16, 5)]}, {"x_num_col_dims": 2, "y_num_col_dims": 1}),
    "fc2": ({"X": [_f32(6, 8)], "Y": [_f32(8, 3)]}, {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    "flatten": ({"X": [_f32(4, 2, 3)], "Y": [_f32(6, 7)]}, {"x_num_col_dims": 1, "y_num_col_dims": 1}),
}


@pytest.mark.parametrize("case", sorted(MUL_CASES))
def test_mul_parity(case):
    inputs, attrs = MUL_CASES[case]
    _assert_close(_run_both("mul", inputs, attrs), **FP32)


@pytest.mark.parametrize("shape", [[0, 0, 4, 2], [-1, 8], [2, 12, 4]])
def test_reshape2_parity(shape):
    res = _run_both("reshape2", {"X": [_f32(2, 6, 8)]}, {"shape": shape})
    _assert_close(res, atol=0, rtol=0)


@pytest.mark.parametrize("perm", [[0, 2, 1, 3], [3, 1, 0, 2]])
def test_transpose2_parity(perm):
    res = _run_both("transpose2", {"X": [_f32(2, 3, 4, 5)]}, {"axis": perm})
    _assert_close(res, atol=0, rtol=0)


@pytest.mark.parametrize("begin,affine", [(2, True), (1, True), (2, False)])
def test_layer_norm_parity(begin, affine):
    x = _f32(2, 5, 8) * 3 + 1
    norm = int(np.prod(x.shape[begin:]))
    inputs = {"X": [x]}
    if affine:
        inputs["Scale"] = [_f32(norm)]
        inputs["Bias"] = [_f32(norm)]
    res = _run_both("layer_norm", inputs, {"epsilon": 1e-5, "begin_norm_axis": begin})
    assert set(res) == {"Y", "Mean", "Variance"}
    _assert_close(res, **FP32)


@pytest.mark.parametrize("ids_shape,padding_idx", [((2, 3), -1), ((2, 3, 1), -1), ((4,), 2)])
def test_lookup_table_parity(ids_shape, padding_idx):
    ids = RNG.randint(0, 10, ids_shape).astype("int64")
    res = _run_both("lookup_table", {"W": [_f32(10, 4)], "Ids": [ids]},
                    {"padding_idx": padding_idx})
    _assert_close(res, atol=0, rtol=0)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_parity(approximate):
    attrs = {"approximate": True} if approximate else {}
    _assert_close(_run_both("gelu", {"X": [_f32(3, 7) * 3]}, attrs), **FP32)


@pytest.mark.parametrize("start,end,step", [(0, 16, 1), (2, 11, 3)])
def test_range_parity(start, end, step):
    attrs = {"start": float(start), "end": float(end), "step": float(step), "dtype": "int64"}
    res = _run_both("range", {}, attrs)
    (j, t), = res.values()
    np.testing.assert_array_equal(t, j)
    assert t.dtype == np.int64  # the port keeps int64; jax (x64 off) says int32


def test_fill_constant_parity():
    attrs = {"shape": [3, 4], "dtype": "float32", "value": 1.5}
    _assert_close(_run_both("fill_constant", {}, attrs), atol=0, rtol=0)


def test_uniform_random_distribution():
    """Bits cannot match jax.random; hold the draw to its distribution,
    and to determinism per seed."""
    k = treg.get_kernel("uniform_random")
    attrs = {"shape": [200, 50], "dtype": "float32", "min": -0.5, "max": 0.25, "seed": 17}
    a = k({}, attrs, CPU)["Out"]
    b = k({}, attrs, CPU)["Out"]
    c = k({}, dict(attrs, seed=18), CPU)["Out"]
    assert a.shape == (200, 50) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= -0.5 and a.max() < 0.25
    assert abs(a.mean().item() - (-0.125)) < 0.01
    assert abs(a.var().item() - 0.75 ** 2 / 12) < 0.005


def _attn_inputs(n, h, s, d, with_mask, seed=3):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(n, h, s, d).astype("float32") for _ in range(3))
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if with_mask:
        lens = rng.randint(1, s + 1, n)
        lens[0] = s  # one all-real row
        inputs["Mask"] = [(np.arange(s)[None, :] < lens[:, None]).astype("float32")]
    return inputs


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_parity_fp32(with_mask, causal):
    inputs = _attn_inputs(3, 4, 16, 8, with_mask)
    res = _run_both("fused_attention", inputs, {"causal": causal, "scale": 1 / np.sqrt(8)})
    _assert_close(res, **FP32)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_fused_attention_parity_bf16(with_mask, causal):
    inputs = _attn_inputs(2, 4, 16, 8, with_mask, seed=5)
    res = _run_both("fused_attention", inputs, {"causal": causal, "scale": 1 / np.sqrt(8)},
                    bf16=True)
    _assert_close(res, atol=2e-2, rtol=0)


def test_fused_attention_ragged_shape():
    """A sequence length that is not a multiple of any tile and a small
    head dim, as the chip check's ragged case."""
    inputs = _attn_inputs(2, 3, 13, 5, True, seed=9)
    res = _run_both("fused_attention", inputs, {"causal": True, "scale": 0.3})
    _assert_close(res, **FP32)
