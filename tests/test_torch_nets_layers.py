"""The sequence, RNN-unit and sampled-loss layers of ``layers/nn.py``,
``nets.py`` and the ``layers/extended.py`` names ported with them, in
paddle_tpu_torch against paddle_tpu.

Each case builds the same small program in both packages: the two descs
(main and startup) must be the same JSON (ids compare as int64, the JAX
package's int32 being its x64 switch), and the port, started from the
JAX package's startup state, must fetch what the JAX package fetches
from the same seeded feed (rtol 1e-5, atol 1e-5: fp32 sums in another
order; ids, counts and shapes as numbers).  The cases with parameters
also train two SGD steps (lr 0.1) and compare the losses and every
parameter after them at the same tolerance.

``nce`` and the random wrappers draw other bits than jax.random, so
their programs are held by desc only; an ``nce`` program then runs in
the port, its cost the op's cost function at the negatives its sampler
draws for the batch.  Every name of the JAX package's ``layers/nn.py``
``__all__`` reaches ``paddle_tpu_torch.layers``, and so do the
``layers/extended.py`` names ported with this slice.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import nets as jnets
from paddle_tpu.layers import extended as jext
from paddle_tpu_torch import nets as tnets
from paddle_tpu_torch.ops import nn_ops as tnn
from torch_parity_util import assert_same_program, jax_startup_state, run_jax, run_port

TOL = dict(rtol=1e-5, atol=1e-5)
B, T, D = 4, 7, 5
NETS = {jfluid: jnets, tfluid: tnets}

# the layers/extended.py names this slice ports (their op types registered here or before)
EXTENDED = ["cos_sim", "sequence_reshape", "sequence_scatter", "chunk_eval", "reduce_all",
            "reduce_any", "elementwise_mod", "elementwise_floordiv", "logical_xor", "sum",
            "sampling_id", "gaussian_random", "gaussian_random_batch_size_like",
            "uniform_random_batch_size_like", "npair_loss", "autoincreased_step_counter",
            "rank", "size", "eye", "linspace", "image_resize_short", "dice_loss",
            "get_tensor_from_selected_rows", "merge_selected_rows", "lod_reset", "lod_append",
            "lstm", "tensor_array_to_tensor", "is_empty"]


def _data(fluid, name, shape, dtype="float32", **kw):
    return fluid.layers.data(name, shape, dtype=dtype, **kw)


def _seq(f):
    x = _data(f, "seq", [T, D])
    return x, _data(f, "seq_len", [-1], dtype="int32", append_batch_size=False)


def _feeds(rng):
    lens = np.array([T, 0, 3, 5], "int32")
    return {
        "img": rng.randn(B, 4, 6, 6).astype("float32"),
        "x": rng.randn(B, 6).astype("float32"),
        "y": rng.randn(B, 6).astype("float32"),
        "seq": rng.randn(B, T, D).astype("float32"),
        "seq_len": lens,
        "label": rng.randint(0, 10, (B, 1)).astype("int64"),
        "logits": rng.randn(B, 8, 5).astype("float32"),
        "ctc_label": rng.randint(1, 5, (B, 3)).astype("int64"),
        "logits_len": np.array([8, 6, 8, 2], "int64"),
        "ctc_label_len": np.array([3, 1, 0, 3], "int64"),
        "tags": rng.randint(0, 7, (B, T)).astype("int64"),
        "pred_tags": rng.randint(0, 7, (B, T)).astype("int64"),
        "scatter_ids": rng.randint(0, 6, (B, T)).astype("int64"),
        "nested": rng.randn(B, 3, 4, D).astype("float32"),
        "outer_len": np.array([3, 1, 0, 2], "int32"),
        "inner_len": rng.randint(0, 5, (B, 3)).astype("int32"),
        "ptable": np.array([[0, 1, 3], [0, 2, -1], [0, 1, 4], [0, -1, -1]], "int64"),
        "pcode": rng.randint(0, 2, (B, 3)).astype("int64"),
        "ints": rng.randint(-9, 9, (B, 6)).astype("int64"),
        "nz_ints": rng.choice([-4, -3, -2, 2, 3, 5], (B, 6)).astype("int64"),
        "flags": rng.rand(B, 6) > 0.5,
        "flags2": rng.rand(B, 6) > 0.5,
    }


def _loss(L, *outs):
    return L.sums([L.reduce_mean(L.square(o)) for o in outs])


# name -> make(fluid, L) returning the vars to fetch
def _forward_cases():
    def ctc(f, L):
        logits = _data(f, "logits", [8, 5])
        lbl = _data(f, "ctc_label", [3], dtype="int64")
        ll = _data(f, "logits_len", [-1], dtype="int64", append_batch_size=False)
        bl = _data(f, "ctc_label_len", [-1], dtype="int64", append_batch_size=False)
        return [L.warpctc(logits, lbl, blank=0, norm_by_times=True, input_length=ll,
                          label_length=bl), L.warpctc(logits, lbl)]

    def nested(f, L):
        x = _data(f, "nested", [3, 4, D])
        outer = _data(f, "outer_len", [-1], dtype="int32", append_batch_size=False)
        inner = _data(f, "inner_len", [3], dtype="int32")
        return [L.nested_sequence_pool(x, outer, inner, pool_type="sum"),
                L.nested_sequence_pool(x, outer, [inner], pool_type="max",
                                       inner_pool_type="average")]

    def chunks(f, L):
        inf = _data(f, "pred_tags", [T], dtype="int64")
        lab = _data(f, "tags", [T], dtype="int64")
        _, lens = _seq(f)
        return list(L.chunk_eval(inf, lab, "IOB", 3, seq_length=lens)) + list(
            L.chunk_eval(inf, lab, "IOBES", 1, excluded_chunk_types=[0]))

    def seq_ext(f, L):
        x, lens = _seq(f)
        out, new_len = L.sequence_reshape(x, 7, seq_len=lens)
        ids = _data(f, "scatter_ids", [T], dtype="int64")
        return [out, new_len, L.sequence_reshape(x, 35),
                L.sequence_scatter(_data(f, "x", [6]), ids, L.reduce_sum(x, dim=2),
                                   seq_len=lens)]

    def ints(f, L):
        a = _data(f, "ints", [6], dtype="int64")
        b = _data(f, "nz_ints", [6], dtype="int64")
        p, q = _data(f, "flags", [6], dtype="bool"), _data(f, "flags2", [6], dtype="bool")
        return [L.elementwise_mod(a, b), L.elementwise_floordiv(a, b), L.logical_xor(p, q),
                L.reduce_all(p), L.reduce_any(p, dim=1), L.reduce_all(q, dim=[1], keep_dim=True),
                L.reduce_any(q)]

    def consts(f, L):
        x = _data(f, "img", [4, 6, 6])
        r, c = L.lod_reset(x, target_lod=[0, 2, 5, 5, 9])
        _, a = L.lod_append(x, [1, 2, 3, 1])
        out, sizes = L.tensor_array_to_tensor([_data(f, "x", [6]), _data(f, "y", [6])], axis=1)
        return [L.rank(x), L.size(L.reduce_sum(x, dim=0)), L.eye(3, 4), L.eye(2, batch_shape=[3]),
                L.linspace(-1.0, 2.0, 7), c, a, out, sizes, L.is_empty(x),
                L.get_tensor_from_selected_rows(x), L.merge_selected_rows(r)]

    def counter(f, L):
        c = L.autoincreased_step_counter(begin=3, step=2)
        return [c, L.elementwise_add(_data(f, "x", [6]), L.cast(c, "float32"))]

    return {
        "im2sequence": lambda f, L: [
            L.im2sequence(_data(f, "img", [4, 6, 6]), filter_size=[2, 3], stride=[1, 2],
                          padding=1),
            L.im2sequence(_data(f, "img", [4, 6, 6]), filter_size=3, stride=3)],
        "warpctc": ctc,
        "nested_sequence_pool": nested,
        "cos_sim": lambda f, L: [L.cos_sim(_data(f, "x", [6]), _data(f, "y", [6])),
                                 L.cos_sim(_data(f, "x", [6]), L.reduce_mean(
                                     _data(f, "y", [6]), dim=0, keep_dim=True))],
        "chunk_eval": chunks,
        "sequence_reshape_scatter": seq_ext,
        "int_and_bool_tails": ints,
        "constants_and_shims": consts,
        "sum_dice_npair": lambda f, L: [
            L.sum([_data(f, "x", [6]), _data(f, "y", [6])]), L.sum(_data(f, "x", [6])),
            L.dice_loss(L.sigmoid(_data(f, "x", [6])), L.cast(_data(f, "flags", [6], "bool"),
                                                             "float32")),
            L.npair_loss(_data(f, "x", [6]), _data(f, "y", [6]), _data(f, "label", [1], "int64"))],
        "image_resize_short": lambda f, L: [
            L.image_resize_short(_data(f, "img", [4, 6, 6]), 9),
            L.image_resize_short(L.pool2d(_data(f, "img", [4, 6, 6]), pool_size=[1, 2],
                                          pool_stride=[1, 2]), 4, resample="NEAREST")],
        "autoincreased_step_counter": counter,
        "glu": lambda f, L: [NETS[f].glu(_data(f, "x", [6])),
                             NETS[f].glu(_data(f, "img", [4, 6, 6]), dim=1)],
        "scaled_dot_product_attention": lambda f, L: [
            NETS[f].scaled_dot_product_attention(_seq(f)[0], _seq(f)[0], _seq(f)[0]),
            NETS[f].scaled_dot_product_attention(
                L.fc(_seq(f)[0], 6, num_flatten_dims=2), L.fc(_seq(f)[0], 6, num_flatten_dims=2),
                L.fc(_seq(f)[0], 6, num_flatten_dims=2), num_heads=2)],
    }


def _param_cases():
    """Layers with parameters, each ending in a scalar loss to train."""
    def seq_conv(f, L):
        x, lens = _seq(f)
        return _loss(L, L.sequence_conv(x, 6, filter_size=3, act="tanh", seq_len=lens),
                     L.sequence_conv(x, 4, filter_size=4, bias_attr=False, seq_len=lens),
                     L.sequence_conv(x, 3, filter_size=2))

    def seq_conv_pool(f, L):
        x, lens = _seq(f)
        a = NETS[f].sequence_conv_pool(x, 6, 3, act="tanh", pool_type="sqrt", seq_len=lens)
        b = NETS[f].sequence_conv_pool(x, 6, 4, act="tanh", pool_type="max", seq_len=lens)
        return _loss(L, L.fc(L.concat([a, b], axis=1), 2, act="softmax"))

    def row(f, L):
        x, lens = _seq(f)
        return _loss(L, L.row_conv(x, 2, act="relu", seq_len=lens), L.row_conv(x, 4))

    def units(f, L):
        x = _data(f, "x", [6])
        h0, c0 = L.fc(_data(f, "y", [6]), 3), L.fc(_data(f, "y", [6]), 3, act="tanh")
        h, c = L.lstm_unit(x, h0, c0, forget_bias=0.5)
        gh, reset, gate = L.gru_unit(L.fc(x, 9), h, 9)
        return _loss(L, h, c, gh, reset, gate)

    def hsig(f, L):
        x = _data(f, "x", [6])
        lbl = _data(f, "label", [1], dtype="int64")
        table = _data(f, "ptable", [3], dtype="int64")
        code = _data(f, "pcode", [3], dtype="int64")
        return _loss(L, L.hsigmoid(x, lbl, 10), L.hsigmoid(x, lbl, 13, bias_attr=False),
                     L.hsigmoid(x, lbl, 5, path_table=table, path_code=code, is_custom=True))

    def img_nets(f, L):
        img = _data(f, "img", [4, 6, 6])
        a = NETS[f].simple_img_conv_pool(img, 3, 3, pool_size=2, pool_stride=2, act="relu")
        b = NETS[f].img_conv_group(img, [3, 5], pool_size=2, conv_act="relu",
                                   conv_with_batchnorm=[False, True], pool_stride=2)
        return _loss(L, a, b)

    def lstm(f, L):
        x, _ = _seq(f)
        h, last_h, last_c = L.lstm(x, None, None, T, 3, 2)
        hb, _, _ = L.lstm(x, None, None, T, 2, 1, is_bidirec=True)
        return _loss(L, h, last_h, last_c, hb)

    return {"sequence_conv": seq_conv, "sequence_conv_pool": seq_conv_pool, "row_conv": row,
            "lstm_unit_gru_unit": units, "hsigmoid": hsig, "img_nets": img_nets, "lstm": lstm}


def _desc_only_cases():
    """Programs whose run draws other bits than jax.random: desc only."""
    def nce(f, L):
        x = _data(f, "x", [6])
        lbl = _data(f, "label", [1], dtype="int64")
        return [L.nce(x, lbl, 10, num_neg_samples=3),
                L.nce(x, lbl, 10, sample_weight=_data(f, "y", [1]), sampler="log_uniform",
                      seed=7, bias_attr=False),
                L.nce(x, lbl, 10, custom_dist=np.arange(1, 11) / 55.0, num_neg_samples=4)]

    return {
        "nce": nce,
        "random_wrappers": lambda f, L: [
            L.sampling_id(L.softmax(_data(f, "x", [6])), seed=3),
            L.gaussian_random_batch_size_like(_data(f, "x", [6]), [-1, 2], std=2.0),
            L.uniform_random_batch_size_like(_data(f, "y", [6]), [-1, 3], min=0.0, seed=9)],
        "img_conv_group_dropout": lambda f, L: [NETS[f].img_conv_group(
            _data(f, "img", [4, 6, 6]), [3, 3], 2, conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[0.2, 0.0], conv_act="relu")],
    }


def _build(fluid, make, train=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        outs = make(fluid, fluid.layers)
        if train:
            fluid.optimizer.SGD(0.1).minimize(outs)
            outs = [outs]
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    return main, startup, [o.name for o in outs]


def _feed_for(main, rng):
    names = {v.name for v in main.list_vars() if getattr(v, "is_data", False)}
    return {n: v for n, v in _feeds(rng).items() if n in names}


@pytest.mark.parametrize("case", sorted(_forward_cases()))
def test_layer_desc_and_run_match_the_jax_package(case):
    make = _forward_cases()[case]
    jm, js, names = _build(jfluid, make)
    tm, ts, tnames = _build(tfluid, make)
    assert names == tnames
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    feed = _feed_for(jm, np.random.RandomState(3))
    state = jax_startup_state(js, jm)
    (jout,), _ = run_jax(jm, state, feed, names)
    (tout,), _ = run_port(tm, state, feed, names)
    for n, j, t in zip(names, jout, tout):
        assert np.shape(t) == np.shape(j), n
        np.testing.assert_allclose(np.asarray(t, np.float64), np.asarray(j, np.float64),
                                   err_msg=n, **TOL)


@pytest.mark.parametrize("case", sorted(_param_cases()))
def test_param_layer_trains_as_in_the_jax_package(case):
    make = _param_cases()[case]
    jm, js, names = _build(jfluid, make, train=True)
    tm, ts, _ = _build(tfluid, make, train=True)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    rng = np.random.RandomState(4)
    feeds = [_feed_for(jm, rng) for _ in range(2)]
    state = jax_startup_state(js, jm)
    jl, jscope = run_jax(jm, state, feeds, names, steps=2)
    tl, tscope = run_port(tm, state, feeds, names, steps=2)
    np.testing.assert_allclose([float(l[0]) for l in tl], [float(l[0]) for l in jl], **TOL)
    params = [p.name for p in jm.all_parameters()]
    assert params
    for n in params:
        np.testing.assert_allclose(tscope.get(n).numpy(), np.asarray(jscope.get(n)), err_msg=n,
                                   **TOL)


@pytest.mark.parametrize("case", sorted(_desc_only_cases()))
def test_random_layer_desc_matches_the_jax_package(case):
    make = _desc_only_cases()[case]
    jm, js, names = _build(jfluid, make)
    tm, ts, tnames = _build(tfluid, make)
    assert names == tnames
    assert_same_program(jm, tm)
    assert_same_program(js, ts)


def test_gaussian_random_layer_builds_in_the_port():
    """The JAX package's ``layers.gaussian_random`` raises IndexError (its
    ``_simple`` reads the first input of the empty ShapeLike list); the
    port's appends the op the reference's layer appends, and runs it."""
    with jfluid.program_guard(jfluid.Program(), jfluid.Program()):
        with pytest.raises(IndexError):
            jfluid.layers.gaussian_random([2, 3])
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        out = tfluid.layers.gaussian_random([2000, 3], mean=1.0, std=2.0)
    op, = main.global_block().ops
    assert (op.type, op.inputs, op.attrs["shape"], op.attrs["seed"]) == (
        "gaussian_random", {"ShapeLike": []}, [2000, 3], 5 * 1000003 + 1)
    v, = tfluid.Executor(tfluid.CPUPlace()).run(main, fetch_list=[out], scope=tfluid.Scope())
    assert v.shape == (2000, 3)
    assert abs(v.mean() - 1.0) < 0.1 and abs(v.std() - 2.0) < 0.1


def test_nce_program_costs_its_drawn_negatives_and_trains():
    """The port's nce program: each sampler's cost is ``nce_cost`` at the
    negatives ``nce_negatives`` draws for the batch's labels; two runs on
    the same batch agree bit for bit; SGD steps lower the cost."""
    main, startup, names = _build(tfluid, _desc_only_cases()["nce"])
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = _feed_for(main, np.random.RandomState(6))
    feed["y"] = np.abs(feed["y"][:, :1]) + 0.5
    outs = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    again = exe.run(main, feed=feed, fetch_list=names, scope=scope)
    assert all(np.array_equal(a, b) for a, b in zip(outs, again))
    label = torch.from_numpy(feed["label"]).reshape(-1)
    x = torch.from_numpy(feed["x"])
    ops = [op for op in main.global_block().ops if op.type == "nce"]
    for op, got in zip(ops, outs):
        a = op.attrs
        probs = None
        if a["sampler"] == "custom_dist":
            probs = torch.from_numpy(np.asarray(a["custom_dist"], np.float32))
            probs = probs / torch.sum(probs)
        neg = tnn.nce_negatives(label.sum(), a["seed"], a["num_neg_samples"], 10, a["sampler"],
                                probs)
        w = scope.get(op.inputs["Weight"][0])
        b = scope.get(op.inputs["Bias"][0]) if op.inputs.get("Bias") else None
        sw = torch.from_numpy(feed["y"]) if op.inputs.get("SampleWeight") else None
        want = tnn.nce_cost(x, label, w, b, sw, neg, a["num_neg_samples"], a["sampler"], probs)
        np.testing.assert_array_equal(got, want.numpy())
    tm, ts, loss = _build(tfluid, lambda f, L: L.reduce_mean(
        L.sums(_desc_only_cases()["nce"](f, L))), train=True)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(ts, scope=scope)
    losses = [float(exe.run(tm, feed=feed, fetch_list=loss, scope=scope)[0]) for _ in range(5)]
    assert losses[-1] < losses[0], losses


def test_layers_namespace_has_the_slice_names():
    """The nine layers/nn.py names of this slice, the extended names and
    nets.py's five functions reach the port's namespaces."""
    for n in ("im2sequence", "warpctc", "sequence_conv", "nce", "hsigmoid", "lstm_unit",
              "gru_unit", "row_conv", "nested_sequence_pool"):
        assert n in tfluid.layers.nn.__all__ and hasattr(tfluid.layers, n), n
    for n in EXTENDED:
        assert n in jext.__all__, n
        assert n in tfluid.layers.extended.__all__ and hasattr(tfluid.layers, n), n
    assert set(tfluid.layers.extended.__all__) <= set(jext.__all__)
    assert tfluid.nets is tnets and tnets.__all__ == jnets.__all__
    for n in jnets.__all__:
        assert callable(getattr(tnets, n)), n
