"""The layers of ``layers/tensor.py``, the plain ``layers/nn.py`` names and
``layers/io.py`` in paddle_tpu_torch against paddle_tpu.

Each layer case builds the same small program in both packages: the two
descs (main and startup) must be the same JSON (ids compare as int64,
the JAX package's int32 being its x64 switch), and the port, started
from the JAX package's startup state, must fetch what the JAX package
fetches from the same seeded feed (rtol 1e-5, atol 1e-5: fp32 sums in
another order; ids and shapes as numbers).  The cases with parameters
also train two SGD steps (lr 0.1) and compare the losses and every
parameter after them at the same tolerance, data_norm's accumulators
included (its gradient folds the batch's statistics into them).

``py_func`` runs its host function at its place in the step, ``load``
reads a ``save_vars`` file; both keep their plans on the interpreter.
The io layers return the port's iterable ``PyReader`` and its decorator
forms; ``read_file``, ``open_files``, ``random_data_generator`` and
``Preprocessor`` raise ``NotImplementedError`` in both packages.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.layers import extended as jext
from paddle_tpu.layers import io as jio
from paddle_tpu.layers import nn as jnn
from paddle_tpu.layers import tensor as jtensor
from torch_parity_util import assert_same_program, jax_startup_state, run_jax, run_port

TOL = dict(rtol=1e-5, atol=1e-5)
B = 4


def _img(fluid, c=4, hw=6):
    return fluid.layers.data("img", [c, hw, hw])


def _vec(fluid, n=6, name="x"):
    return fluid.layers.data(name, [n])


# name -> make(fluid, L) returning the vars to fetch; the feed comes
# from FEEDS by the data layers' names
def _tensor_cases():
    return {
        "split_num": lambda f, L: L.split(_vec(f), 3, dim=1),
        "split_sections": lambda f, L: L.split(_vec(f), [1, 5], dim=-1),
        "ones_zeros_like": lambda f, L: [L.ones([2, 3], "float32"), L.zeros_like(_vec(f)),
                                         L.ones_like(_vec(f, name="y"))],
        "squeeze_unsqueeze_flatten": lambda f, L: [
            L.squeeze(L.unsqueeze(_vec(f), [1, 3]), [3]), L.flatten(_img(f), axis=2)],
        "stack_unstack": lambda f, L: [L.stack([_vec(f), _vec(f, name="y")], axis=1)]
        + L.unstack(_img(f), axis=1),
        "increment_const_pow": lambda f, L: [L.increment_const(_vec(f), 2.5),
                                             L.pow(L.abs(_vec(f, name="y")), 1.5)],
        "reductions": lambda f, L: [L.reduce_mean(_img(f), dim=[2, 3]),
                                    L.reduce_max(_img(f), dim=1, keep_dim=True),
                                    L.reduce_min(_img(f)), L.reduce_prod(_vec(f), dim=-1)],
        "argmin_argsort": lambda f, L: [L.argmin(_vec(f), axis=1)]
        + list(L.argsort(_vec(f), axis=-1, descending=True)),
        "scatter": lambda f, L: [L.scatter(
            _vec(f), L.assign(np.array([2, 0], "int64")),
            L.slice(_vec(f, name="y"), axes=[0], starts=[0], ends=[2]))],
        "shape_cumsum_isfinite": lambda f, L: [L.shape(_img(f)), L.cumsum(_vec(f), axis=1),
                                               L.cumsum(_vec(f), axis=1, exclusive=True,
                                                        reverse=True),
                                               L.isfinite(_vec(f))],
        "create_tensor_cast": lambda f, L: [L.cast(_vec(f), "float32"),
                                            L.assign(_vec(f), L.create_tensor("float32"))],
    }


def _nn_cases():
    def resize(f, L):
        x = _img(f)
        return [L.image_resize(x, out_shape=[9, 7]), L.resize_bilinear(x, scale=2.0),
                L.resize_nearest(x, out_shape=[3, 4]),
                L.resize_bilinear(x, out_shape=[4, 4], align_corners=False)]

    def losses(f, L):
        x, y = _vec(f), _vec(f, name="y")
        p = L.sigmoid(x)
        return [L.huber_loss(x, y, 1.0), L.smooth_l1(x, y, sigma=2.0),
                L.log_loss(p, L.cast(L.greater_than(y, L.zeros_like(y)), "float32"))]

    def crop(f, L):
        x = _img(f)
        return [L.crop(x, shape=[B, 2, 3, 3], offsets=[0, 1, 2, 1]),
                L.crop(x, shape=L.pool2d(x, 2, pool_stride=2), offsets=[0, 0, 1, 1]),
                L.pad_constant_like(x, L.crop(x, shape=[B, 2, 3, 3]), pad_value=-2.0)]

    return {
        "mul": lambda f, L: [L.mul(_img(f), L.assign(np.ones((144, 3), "float32") / 7))],
        "one_hot_label_smooth": lambda f, L: [
            L.label_smooth(L.one_hot(f.layers.data("ids", [1], dtype="int64"), 5), epsilon=0.2)],
        "log_softmax": lambda f, L: [L.log_softmax(_vec(f)), L.log_softmax(_img(f), axis=1)],
        "pad_pad2d": lambda f, L: [L.pad(_vec(f), [0, 1, 2, 0], pad_value=0.5),
                                   L.pad2d(_img(f), [1, 0, 2, 1], mode="reflect"),
                                   L.pad2d(_img(f), [1, 1, 0, 2], pad_value=3.0)],
        "crop_pad_constant_like": crop,
        "resize": resize,
        "losses": losses,
        "l2_normalize_maxout": lambda f, L: [L.l2_normalize(_vec(f), axis=1),
                                             L.maxout(_img(f), groups=2)],
        "pixel_shuffle_channel": lambda f, L: [L.pixel_shuffle(_img(f), 2),
                                               L.shuffle_channel(_img(f), 2)],
    }


def _param_cases():
    """Layers with parameters, each ending in a scalar loss to train."""
    def loss(L, *outs):
        return L.sums([L.reduce_mean(L.square(o)) for o in outs])

    return {
        "conv2d_transpose_group_norm": lambda f, L: loss(L, L.group_norm(
            L.conv2d_transpose(_img(f), 6, filter_size=3, stride=2, padding=1, act="relu"),
            groups=3)),
        "prelu": lambda f, L: loss(L, L.prelu(_img(f), "all"), L.prelu(_img(f), "channel"),
                                   L.prelu(_img(f), "element")),
        "spectral_norm": lambda f, L: loss(L, L.mul(_vec(f), L.spectral_norm(
            L.create_parameter([6, 5], "float32", name="sn_w"), dim=1, power_iters=2))),
        "data_norm": lambda f, L: loss(L, L.data_norm(_vec(f), name="dn")),
        "bilinear_tensor_product": lambda f, L: loss(L, L.bilinear_tensor_product(
            _vec(f), _vec(f, n=3, name="y"), 4, act="tanh")),
    }


def _feeds(rng):
    return {"img": rng.randn(B, 4, 6, 6).astype("float32"),
            "x": rng.randn(B, 6).astype("float32"),
            "y": rng.randn(B, 6).astype("float32"),
            "ids": rng.randint(0, 5, (B, 1)).astype("int64")}


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
    y_width = {v.name: v.shape[-1] for v in main.list_vars() if v.name == "y"}
    feed = {n: v for n, v in _feeds(rng).items() if n in names}
    if "y" in feed and y_width.get("y") == 3:
        feed["y"] = feed["y"][:, :3]
    return feed


CASES = dict(_tensor_cases(), **_nn_cases())


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_desc_and_run_match_the_jax_package(case):
    jm, js, names = _build(jfluid, CASES[case])
    tm, ts, tnames = _build(tfluid, CASES[case])
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


def test_data_norm_folds_the_batch_statistics():
    """After one SGD step at lr 1 from zero accumulators' gradient, each
    accumulator moved by minus the reference's cotangent: N, sum(x) and
    sum((x - mean)^2) + N * epsilon per channel."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [3])
        y = tfluid.layers.data_norm(x, name="dn", epsilon=1e-4)
        loss = tfluid.layers.reduce_sum(y) * 0.0
        tfluid.optimizer.SGD(1.0).minimize(loss)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).randn(5, 3).astype("float32")
    exe.run(main, feed={"x": xv}, fetch_list=[loss], scope=scope)
    mean = 0.0 / 1e4
    np.testing.assert_allclose(scope.get("dn.batch_size").numpy(), 1e4 - 5, rtol=1e-6)
    np.testing.assert_allclose(scope.get("dn.batch_sum").numpy(), -xv.sum(0), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(scope.get("dn.batch_square_sum").numpy(),
                               1e4 - (((xv - mean) ** 2).sum(0) + 5 * 1e-4), rtol=1e-5)


def test_py_func_runs_on_the_host_at_its_place():
    """The host function sees the batch as numpy and its result feeds the
    next op, as in the JAX package; the plan stays on the interpreter."""
    seen = {}

    def host(x):
        seen["type"] = type(x)
        return np.tanh(x) * 2.0

    outs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [6])
            out = main.current_block().create_var(name="py_out", shape=[-1, 6], dtype="float32")
            y = fluid.layers.py_func(host, fluid.layers.scale(x, 3.0), out)
            z = fluid.layers.reduce_sum(y, dim=1)
        exe = fluid.Executor(fluid.CPUPlace())
        feed = {"x": np.random.RandomState(1).randn(3, 6).astype("float32")}
        if fluid is tfluid:
            assert [op.type for op in main.global_block().ops][1] == "py_func"
            assert z.shape == (-1,)
            outs.append(exe.run(main, feed=feed, fetch_list=[z], scope=fluid.Scope())[0])
            assert exe._analyze(main, ("x",), (z.name,)).eager_ops == ("py_func",)
        else:
            with fluid.scope_guard(fluid.Scope()):
                outs.append(np.asarray(exe.run(main, feed=feed, fetch_list=[z])[0]))
    assert seen["type"] is np.ndarray
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1], (np.tanh(3 * feed["x"]) * 2).sum(1), rtol=1e-5)


def test_py_func_out_shape_fn_and_refusals():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [4])
        out = main.current_block().create_var(name="o", shape=[-1, -1], dtype="float32")
        tfluid.layers.py_func(lambda a: np.concatenate([a, a], 1), x, out,
                              out_shape_fn=lambda shapes: [(shapes[0][0], 2 * shapes[0][1])])
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=["o"], scope=tfluid.Scope())
    assert got.shape == (2, 8)
    with pytest.raises(NotImplementedError):
        tfluid.layers.py_func(lambda a: a, x, out, backward_func=lambda *a: a)


def test_load_layer_reads_a_save_vars_file(tmp_path):
    """``layers.load`` in a startup program fills the var from the file,
    in both packages; the port's plan with it stays on the interpreter."""
    arr = np.random.RandomState(2).randn(3, 5).astype("float32")
    np.save(str(tmp_path / "w.npy"), arr)
    got = []
    for fluid in (jfluid, tfluid):
        prog = fluid.Program()
        with fluid.program_guard(prog, fluid.Program()):
            w = prog.global_block().create_var(name="w", shape=[3, 5], dtype="float32",
                                               persistable=True)
            fluid.layers.load(w, str(tmp_path / "w"))
        exe = fluid.Executor(fluid.CPUPlace())
        if fluid is tfluid:
            scope = fluid.Scope()
            got.append(exe.run(prog, fetch_list=["w"], scope=scope)[0])
            assert exe._analyze(prog, (), ("w",)).eager_ops == ("load",)
            np.testing.assert_array_equal(scope.get("w").numpy(), arr)
        else:
            with fluid.scope_guard(fluid.Scope()):
                got.append(np.asarray(exe.run(prog, fetch_list=["w"])[0]))
        assert json.loads(prog.to_json())["blocks"][0]["ops"][0]["type"] == "load"
    np.testing.assert_array_equal(got[0], arr)
    np.testing.assert_array_equal(got[1], arr)


def test_layers_namespace_has_the_slice_names():
    """Every name of the JAX package's layers/tensor.py, layers/io.py and
    layers/nn.py __all__ reaches ``fluid.layers``, and so does each
    layers/extended.py name whose op types the port registers."""
    for mod in (jtensor, jio, jnn):
        for n in mod.__all__:
            assert hasattr(tfluid.layers, n), n
    assert set(jtensor.__all__) <= set(tfluid.layers.tensor.__all__)
    assert set(jio.__all__) == set(tfluid.layers.io.__all__)
    assert set(jnn.__all__) == set(tfluid.layers.nn.__all__)
    extended = {"cos_sim", "sequence_reshape", "sequence_scatter", "chunk_eval", "reduce_all",
                "reduce_any", "elementwise_mod", "elementwise_floordiv", "logical_xor", "sum",
                "sampling_id", "gaussian_random", "gaussian_random_batch_size_like",
                "uniform_random_batch_size_like", "npair_loss", "autoincreased_step_counter"}
    assert extended <= set(jext.__all__)
    for n in extended:
        assert hasattr(tfluid.layers, n), n


def test_create_py_reader_by_data_feeds_the_executor():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [3])
        y = tfluid.layers.data("y", [1], dtype="int64")
        reader = tfluid.layers.create_py_reader_by_data(capacity=2, feed_list=[x, y])
        s = tfluid.layers.reduce_sum(x)
    assert isinstance(reader, tfluid.PyReader)
    assert isinstance(jfluid.layers.create_py_reader_by_data(2, []), jfluid.PyReader)
    rng = np.random.RandomState(0)
    batches = [(rng.randn(2, 3).astype("float32"), rng.randint(0, 3, (2, 1))) for _ in range(3)]
    reader.decorate_batch_generator(lambda: iter(batches), places=tfluid.CPUPlace())
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [float(exe.run(main, feed=feed, fetch_list=[s], scope=tfluid.Scope())[0])
           for feed in reader()]
    np.testing.assert_allclose(got, [b[0].sum() for b in batches], rtol=1e-5)


def test_py_reader_and_decorator_forms():
    r = tfluid.layers.py_reader(capacity=4, shapes=[[-1, 3]], dtypes=["float32"])
    assert isinstance(r, tfluid.PyReader) and r._use_double_buffer
    samples = lambda: iter(range(10))  # noqa: E731
    assert list(tfluid.layers.batch(samples, 4)()) == list(jfluid.layers.batch(samples, 4)())
    assert list(tfluid.layers.batch(samples, 4, drop_last=True)()) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert sorted(tfluid.layers.shuffle(samples, 3)()) == list(range(10))
    assert tfluid.layers.double_buffer(samples) is samples


@pytest.mark.parametrize("name,args", [
    ("read_file", (None,)),
    ("open_files", (["a"], [[1]], [0], ["float32"])),
    ("random_data_generator", (0.0, 1.0, [[1]], [0])),
    ("Preprocessor", (None,)),
])
def test_file_reader_layers_raise_as_in_the_jax_package(name, args):
    for fluid in (jfluid, tfluid):
        with pytest.raises(NotImplementedError):
            getattr(fluid.layers, name)(*args)


def test_multiprocess_reader_interleaves_every_sample():
    readers = [lambda k=k: iter(range(100 * k, 100 * k + 20)) for k in range(3)]
    got = list(tfluid.reader.multiprocess_reader(readers, queue_size=4)())
    assert sorted(got) == sorted(v for r in readers for v in r())
    for k in range(3):  # each reader's own order is kept
        mine = [v for v in got if 100 * k <= v < 100 * k + 20]
        assert mine == list(range(100 * k, 100 * k + 20))
    jgot = list(jfluid.reader.multiprocess_reader(readers)())
    assert sorted(jgot) == sorted(got)


def test_ops_under_amp_keep_the_jax_casts():
    """A program of the new gray and white ops under the AMP rewrite: the
    same desc in both packages (the cast ops, and each var's dtype)."""
    progs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = _img(fluid)
            h = fluid.layers.conv2d_transpose(x, 4, filter_size=3, act=None)
            h = fluid.layers.group_norm(fluid.layers.prelu(h, "channel"), groups=2)
            h = fluid.layers.pad2d(h, [1, 1, 1, 1])
            parts = fluid.layers.split(fluid.layers.flatten(h, axis=1), 2, dim=1)
            h = fluid.layers.stack([fluid.layers.squeeze(fluid.layers.unsqueeze(p, [1]), [1])
                                    for p in parts], axis=1)
            loss = fluid.layers.reduce_mean(h)
            opt = fluid.contrib.mixed_precision.decorate(fluid.optimizer.SGD(0.1))
            opt.minimize(loss)
        progs.append((main, startup))
    assert_same_program(progs[0][0], progs[1][0])
    main, startup = progs[1]
    assert "bfloat16" in {v.dtype for v in main.list_vars()}
    feed = {"img": np.random.RandomState(0).randn(2, 4, 6, 6).astype("float32")}
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    out, = exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
    assert np.isfinite(out).all()
