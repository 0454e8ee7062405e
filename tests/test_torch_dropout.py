"""The ``dropout`` op of paddle_tpu_torch: its counter-based generator,
its mask, its gradient, and its branches against paddle_tpu's op.

The mask is Philox4x32-10 of (seed, element index) (kernels/dropout.py),
so it cannot match the bits of the JAX package's ``jax.random`` mask.
What the two must share is held exactly:

* Philox4x32-10 gives the Random123 known-answer vectors;
* the keep rate is 1 - p within 5 standard deviations, and the kept
  words are spread over the whole index range;
* the same seed gives the same mask, and two ops of one program (seeds
  from ``Program.next_seed``) give different ones;
* the generic vjp grad op, which runs the forward again, sees the
  forward's mask: dX = where(Mask, dOut, 0), divided by 1 - p under
  ``upscale_in_train``;
* both ``is_test`` branches and p = 0 match the JAX op bit for bit, and
  in training, on the elements both masks keep, Out and dX match the JAX
  op's bit for bit (the rest are 0 in both), in fp32 and bf16.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.kernels import dropout as kd

CPU = torch.device("cpu")
RNG = np.random.RandomState(3)
IMPLS = ["downgrade_in_infer", "upscale_in_train"]
DTYPES = {"float32": (torch.float32, np.float32), "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}


def _words(ctr, key):
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    return [int(w) for w in kd.philox4x32_10(c, key)]


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32 with 10 rounds."""
    assert _words(ctr, key) == want


def test_counter_layout():
    """Element i takes word i % 4 of the call at counter (i // 4, 0, 0, 0)."""
    seed = 77
    got = kd.philox_words(4 * 5 + 3, seed, CPU).tolist()
    for i in (0, 1, 5, 11, 22):
        assert got[i] == _words((i // 4, 0, 0, 0), (seed, 0))[i % 4]
    # the high word of the counter is used past 2^32 groups
    g = torch.tensor([(1 << 32) + 3], dtype=torch.int64)
    hi = kd.philox4x32_10([g & 0xFFFFFFFF, g >> 32, g * 0, g * 0], (seed, 0))
    assert [int(w) for w in hi] == _words((3, 1, 0, 0), (seed, 0))


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_keep_rate_within_five_sigma(p):
    n = 200_003  # not a multiple of 4
    _, mask = kd.dropout_train(torch.ones(n), p, 1234, False)
    kept = mask.double().mean().item()
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(kept - (1 - p)) <= 5 * sigma, (kept, 1 - p, sigma)
    # no region of the index range is starved: each tenth within 5 sigma
    tenths = mask.double()[: n - n % 10].reshape(10, -1).mean(1)
    assert ((tenths - (1 - p)).abs() <= 5 * np.sqrt(p * (1 - p) / (n // 10))).all()
    assert kd.keep_threshold(p) == round((1 - p) * 2 ** 24)


def test_same_seed_same_mask_and_seeds_differ():
    x = torch.randn(3, 50, 7)
    a = kd.dropout_train(x, 0.3, 11, False)[1]
    b = kd.dropout_train(x, 0.3, 11, False)[1]
    c = kd.dropout_train(x, 0.3, 12, False)[1]
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    # seed 0 means 12345, as the JAX package's prng
    assert torch.equal(kd.dropout_train(x, 0.3, 0, False)[1], kd.dropout_train(x, 0.3, 12345, False)[1])


def test_two_ops_of_one_program_get_different_masks():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [64])
        a = tfluid.layers.dropout(x, 0.5)
        b = tfluid.layers.dropout(x, 0.5)
    ops = [op for op in main.global_block().ops if op.type == "dropout"]
    seeds = [op.attr("seed") for op in ops]
    assert seeds[0] != seeds[1]
    assert not treg.get_op("dropout").random  # its plans are captured
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": np.ones((4, 64), "float32")}
    ma, mb = exe.run(main, feed=feed, fetch_list=[ops[0].output("Mask")[0], ops[1].output("Mask")[0]],
                     scope=tfluid.Scope())
    assert not np.array_equal(ma, mb)
    again = exe.run(main, feed=feed, fetch_list=[a, b], scope=tfluid.Scope())
    np.testing.assert_array_equal(again[0], np.where(ma > 0, 1.0, 0.0))
    np.testing.assert_array_equal(again[1], np.where(mb > 0, 1.0, 0.0))


def _attrs(p, impl, is_test=False, seed=99):
    return {"dropout_prob": p, "is_test": is_test, "seed": seed, "dropout_implementation": impl}


def _both(x_np, dtype, attrs, d_out=None):
    """(JAX Out, Mask[, dX]), (port Out, Mask[, dX]) as float64 numpy."""
    tdt, ndt = DTYPES[dtype]
    xj = jnp.asarray(x_np.astype(ndt))
    xt = torch.from_numpy(x_np).to(tdt)
    jk = jreg.get_kernel("dropout")
    jo = jk({"X": [xj]}, dict(attrs))
    to = treg.get_kernel("dropout")({"X": [xt]}, dict(attrs), CPU)
    jr = [np.asarray(jo["Out"]), np.asarray(jo["Mask"])]
    tr = [to["Out"], to["Mask"]]
    assert str(tr[0].dtype).endswith(dtype) and str(tr[1].dtype).endswith(dtype)
    if d_out is not None:
        g = d_out.astype(ndt)
        _, vjp = jax.vjp(lambda v: jk({"X": [v]}, dict(attrs))["Out"], xj)
        jr.append(np.asarray(vjp(jnp.asarray(g))[0]))
        g_attrs = dict(attrs, __fwd_output_slots__=("Out", "Mask"), __grad_input_slots__=("X",))
        tg = treg.get_kernel("dropout_grad")(
            {"X": [xt], "Out@GRAD": [torch.from_numpy(d_out).to(tdt)]}, g_attrs, CPU)
        tr.append(tg["X@GRAD"][0])
    return ([a.astype(np.float64) for a in jr],
            [t.float().numpy().astype(np.float64) for t in tr])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_is_test_branch_matches_jax_exactly(p, impl, dtype):
    x = RNG.randn(4, 33).astype("float32")
    (jo, jm), (to, tm) = _both(x, dtype, _attrs(p, impl, is_test=True))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
def test_rate_zero_matches_jax_exactly(impl, dtype):
    x = RNG.randn(4, 33).astype("float32")
    g = RNG.randn(4, 33).astype("float32")
    jr, tr = _both(x, dtype, _attrs(0.0, impl), d_out=g)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("p", [0.1, 0.5])
def test_training_branch_matches_jax_where_both_keep(p, impl, dtype):
    x = RNG.randn(8, 129).astype("float32")
    g = RNG.randn(8, 129).astype("float32")
    (jo, jm, jg), (to, tm, tg) = _both(x, dtype, _attrs(p, impl), d_out=g)
    for m in (jm, tm):
        assert set(np.unique(m)) <= {0.0, 1.0}
    both = (jm == 1) & (tm == 1)
    assert both.sum() > 0.5 * (1 - p) ** 2 * x.size
    np.testing.assert_array_equal(to[both], jo[both])
    np.testing.assert_array_equal(tg[both], jg[both])
    # dropped elements are 0 in Out and in dX
    assert not to[tm == 0].any() and not tg[tm == 0].any()
    # the vjp recompute saw the forward's mask: dX = where(Mask, dOut / div, 0)
    tdt = DTYPES[dtype][0]
    gt = torch.from_numpy(g).to(tdt).float()
    if impl == "upscale_in_train":
        gt = gt / kd.divisor(p, tdt)
    want = torch.where(torch.from_numpy(tm) == 1, gt.to(tdt).float(), 0.0).double().numpy()
    np.testing.assert_array_equal(tg, want)
    # and the kept values are X (or X / (1 - p) in X's type)
    xt = torch.from_numpy(x).to(tdt).float()
    if impl == "upscale_in_train":
        xt = xt / kd.divisor(p, tdt)
    np.testing.assert_array_equal(to, np.where(tm == 1, xt.to(tdt).double().numpy(), 0.0))


def test_meta_shapes_and_layer_desc():
    out, mask = kd.dropout_train(torch.empty(3, 5, device="meta", dtype=torch.bfloat16), 0.2, 1, True)
    assert out.shape == mask.shape == (3, 5) and out.dtype == mask.dtype == torch.bfloat16
    import paddle_tpu as jfluid

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = 9
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [6])
            y = fluid.layers.dropout(x, 0.25, dropout_implementation="upscale_in_train")
            z = fluid.layers.dropout(y, 0.5, is_test=True, seed=17)
        return main, z

    jm, jz = build(jfluid)
    tm, tz = build(tfluid)
    assert tm.to_json() == jm.to_json()
    assert tz.name == jz.name
