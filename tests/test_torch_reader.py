"""The input pipeline of paddle_tpu_torch against paddle_tpu: the reader
decorators, DataFeeder, PyReader and device_buffered.

* Each decorator gives the JAX package's items, in its order (the same
  seeded ``random.Random`` shuffles both).
* DataFeeder gives the JAX package's arrays, dense and ragged (padded,
  with the int32 ``<name>_seq_len``), bit for bit; a sample of several
  rows reshapes to its var as the reference's does.
* PyReader feeds three CPU training steps whose losses equal, bit for
  bit, the same batches fed as dicts, and the JAX package's run from the
  same state at rtol 1e-5.
* device_buffered keeps the order, stacks ``steps=N`` chunks that
  ``Executor.run(steps=N, per_step_feed=True)`` runs as N single runs
  (the same bits), shuts its thread down when the consumer leaves,
  counts stalls, and surfaces a producer's exception in the consumer.
* Nothing falls back: ``device="auto"`` without a card raises, and the
  sharded mode raises naming the multi-device slice.  The staging on a
  card's side stream is held by tests/test_torch_cuda.py.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import reader as JR
from paddle_tpu_torch import reader as TR
from paddle_tpu_torch.monitor import registry as mon


def _src():
    yield from range(10)


def _pairs():
    for i in range(5):
        yield (i, -i)


DECORATORS = {
    "firstn": lambda R: R.firstn(_src, 3),
    "shuffle": lambda R: R.shuffle(_src, 4, seed=3),
    "batch": lambda R: R.batch(_src, 4),
    "batch_drop_last": lambda R: R.batch(_src, 4, drop_last=True),
    "buffered": lambda R: R.buffered(_src, 2),
    "map_readers": lambda R: R.map_readers(lambda a, b: a * b, _src, _src),
    "chain": lambda R: R.chain(_src, _pairs),
    "compose": lambda R: R.compose(_pairs, _pairs),
    "cache": lambda R: R.cache(_src),
    "xmap_ordered": lambda R: R.xmap_readers(lambda v: v * v, _src, 3, 4, order=True),
    "fake": lambda R: R.Fake()(_pairs, 4),
    "pipe": lambda R: R.PipeReader("printf a\\nbb\\nccc").get_line,
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_decorator_matches_jax(name):
    want = list(DECORATORS[name](JR)())
    got = list(DECORATORS[name](TR)())
    assert got == want and got


def test_unordered_xmap_and_misaligned_compose():
    got = TR.xmap_readers(lambda v: v + 1, _src, 4, 2)()
    assert sorted(got) == list(range(1, 11))
    with pytest.raises(TR.ComposeNotAligned):
        list(TR.compose(_src, _pairs)())
    with pytest.raises(RuntimeError, match="status"):
        list(TR.PipeReader("false").get_line())


def _feed_vars(fluid):
    prog = fluid.Program()
    with fluid.program_guard(prog, fluid.Program()):
        x = fluid.layers.data("x", [4])
        ids = fluid.layers.data("ids", [2], dtype="int64")
        seq = fluid.layers.data("seq", [3], dtype="float32", lod_level=1)
    return prog, [x, ids, seq]


def test_data_feeder_matches_jax():
    rng = np.random.RandomState(0)
    samples = [(rng.randn(4).astype("float32"), rng.randint(0, 9, 2),
                rng.randn(n, 3).astype("float32")) for n in (2, 5, 1)]
    jprog, jvars = _feed_vars(jfluid)
    tprog, tvars = _feed_vars(tfluid)
    assert tprog.to_json() == jprog.to_json()  # the ragged var's companion
    want = jfluid.DataFeeder(jvars, jfluid.CPUPlace()).feed(samples)
    got = tfluid.DataFeeder(tvars, tfluid.CPUPlace()).feed(samples)
    assert list(got) == list(want) == ["x", "ids", "seq", "seq_seq_len"]
    for n in want:
        assert got[n].dtype == want[n].dtype, n
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert got["seq"].shape == (3, 5, 3)
    np.testing.assert_array_equal(got["seq_seq_len"], [2, 5, 1])
    with pytest.raises(ValueError, match="sample width"):
        tfluid.DataFeeder(tvars[:2]).feed(samples)


def test_data_feeder_reshapes_a_sample_of_several_rows():
    """A var declared [-1, 1] takes samples of [3, 1] each, reshaped with
    -1 inferred as the reference's converter does (the JAX package would
    leave [2, 3, 1]); a batch that fits no reshape raises."""
    prog = tfluid.Program()
    with tfluid.program_guard(prog, tfluid.Program()):
        pos = tfluid.layers.data("mask_pos", [1], dtype="int64")
        grid = tfluid.layers.data("grid", [2, 3])
    got = tfluid.DataFeeder([pos]).feed([(np.arange(3).reshape(3, 1),),
                                         (np.arange(3, 6).reshape(3, 1),)])
    np.testing.assert_array_equal(got["mask_pos"], np.arange(6).reshape(6, 1))
    with pytest.raises(ValueError, match="grid"):
        tfluid.DataFeeder([grid]).feed([(np.ones(5),), (np.ones(5),)])


# ---------------------------------------------------------------------------
# PyReader feeding training steps
# ---------------------------------------------------------------------------
def _mlp(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [16])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        p = fluid.layers.fc(fluid.layers.fc(img, 32, act="relu"), 5, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(p, lbl))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss, [img, lbl]


def _samples():
    rng = np.random.RandomState(5)
    for _ in range(24):
        yield rng.randn(16).astype("float32"), np.array([rng.randint(0, 5)], dtype="int64")


def test_pyreader_feeds_three_cpu_steps():
    jm, js, jloss, jvars = _mlp(jfluid)
    tm, _, tloss, tvars = _mlp(tfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = [v.name for v in jm.list_vars() if v.persistable]
    init = {n: np.asarray(jscope.get(n)) for n in names}

    jreader = jfluid.PyReader(feed_list=jvars, capacity=4)
    jreader.decorate_sample_list_generator(JR.batch(_samples, 8))
    treader = tfluid.PyReader(feed_list=tvars, capacity=4, use_double_buffer=True)
    treader.decorate_sample_list_generator(TR.batch(_samples, 8), places=tfluid.CPUPlace())

    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope, dscope = tfluid.Scope(), tfluid.Scope()
    for s in (tscope, dscope):
        tfluid.io.set_params_from_numpy(s, init, texe.device, program=tm)
    losses = []
    with jfluid.scope_guard(jscope):
        for jfeed, tfeed, samples in zip(jreader(), treader(), TR.batch(_samples, 8)()):
            assert set(tfeed) == {"img", "lbl"}
            assert isinstance(tfeed["img"], np.ndarray)  # host staging on the CPU
            jl, = jexe.run(jm, feed=jfeed, fetch_list=[jloss])
            tl, = texe.run(tm, feed=tfeed, fetch_list=[tloss], scope=tscope)
            dict_feed = {"img": np.stack([s[0] for s in samples]),
                         "lbl": np.stack([s[1] for s in samples])}
            dl, = texe.run(tm, feed=dict_feed, fetch_list=[tloss], scope=dscope)
            losses.append((float(np.asarray(jl)), float(tl), float(dl)))
    assert len(losses) == 3
    for j, t, d in losses:
        assert t == d
        np.testing.assert_allclose(t, j, rtol=1e-5)
    # return_list and a batch generator give the same arrays, in feed order
    breader = tfluid.PyReader(feed_list=tvars, return_list=True)
    breader.decorate_batch_generator(
        lambda: iter([(np.ones((2, 16)), np.zeros((2, 1)))]), places=tfluid.CPUPlace())
    (img, lbl), = list(breader())
    assert img.dtype == np.float32 and lbl.dtype == np.int64


# ---------------------------------------------------------------------------
# device_buffered
# ---------------------------------------------------------------------------
def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name.startswith("ptpu-prefetch")]


def test_device_buffered_order_and_chunks():
    src = [{"a": np.full((2,), i, "float32")} for i in range(10)]
    out = list(TR.device_buffered(src, size=3, device=None)())
    assert [int(b["a"][0]) for b in out] == list(range(10))
    chunks = list(TR.device_buffered(src, size=2, device="cpu", steps=4)())
    assert len(chunks) == 2 and chunks[1]["a"].shape == (4, 2)
    assert [int(v) for v in chunks[1]["a"][:, 0]] == [4, 5, 6, 7]
    tail = list(TR.device_buffered(src, size=2, device=None, steps=4, drop_last=False)())
    assert [c["a"].shape[0] for c in tail] == [4, 4, 2]
    seq = list(TR.device_buffered([(np.ones(3), np.zeros(1))] * 4, device=None, steps=2)())
    assert len(seq) == 2 and seq[0][0].shape == (2, 3)


def test_device_buffered_chunks_run_as_single_steps():
    main, startup, loss, _ = _mlp(tfluid)
    exe, boot = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=boot)
    init = {n: v.clone() for n, v in boot.vars.items()}
    rng = np.random.RandomState(7)
    batches = [{"img": rng.randn(4, 16).astype("float32"),
                "lbl": rng.randint(0, 5, (4, 1)).astype("int64")} for _ in range(8)]
    single, chunked = tfluid.Scope(), tfluid.Scope()
    for s in (single, chunked):
        s.bind_device(exe.device)
        s.vars.update({n: v.clone() for n, v in init.items()})
    singles = [float(exe.run(main, feed=b, fetch_list=[loss], scope=single)[0]) for b in batches]
    lasts = [float(exe.run(main, feed=c, fetch_list=[loss], scope=chunked, steps=4,
                           per_step_feed=True)[0])
             for c in TR.device_buffered(batches, size=2, device=None, steps=4)()]
    assert lasts == [singles[3], singles[7]]
    for n in init:
        assert torch.equal(single.vars[n], chunked.vars[n]), n


def test_device_buffered_clean_shutdown_and_stall_counters():
    base = len(_prefetch_threads())
    p0 = mon.REGISTRY.value("reader_producer_stalls_total")
    c0 = mon.REGISTRY.value("reader_consumer_stalls_total")

    def slow():
        for i in range(3):
            time.sleep(0.05)
            yield i

    assert list(TR.device_buffered(slow, size=2, device=None)()) == [0, 1, 2]
    assert mon.REGISTRY.value("reader_consumer_stalls_total") > c0
    gen = TR.device_buffered(lambda: iter(range(1000)), size=2, device=None)()
    assert [next(gen), next(gen)] == [0, 1]
    time.sleep(0.2)  # queue full: the producer blocks (a counted stall)
    gen.close()  # the consumer abandons the epoch
    deadline = time.time() + 5
    while len(_prefetch_threads()) > base and time.time() < deadline:
        time.sleep(0.01)
    assert len(_prefetch_threads()) == base, "prefetch producer leaked"
    assert mon.REGISTRY.value("reader_producer_stalls_total") > p0
    assert mon.REGISTRY.value("reader_producer_stall_seconds_total") > 0
    snap = mon.REGISTRY.snapshot()
    assert snap["reader_consumer_stalls_total"]["type"] == "counter"


def test_producer_exception_surfaces_in_consumer():
    def broken():
        yield 1
        raise OSError("disk went away")

    gen = TR.device_buffered(broken, size=2, device=None)()
    assert next(gen) == 1
    with pytest.raises(OSError, match="disk went away"):
        next(gen)
    with pytest.raises(OSError, match="disk went away"):
        list(TR.buffered(broken, 2)())


def test_no_fallback_and_no_sharded_mode(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TR.device_buffered([1], device="auto")
    r = tfluid.PyReader(feed_list=_feed_vars(tfluid)[1][:1])
    r.decorate_batch_generator(lambda: iter([(np.ones((1, 4)),)]))  # places: cuda:0
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        list(r())
    with pytest.raises(NotImplementedError, match="A10"):
        TR.device_buffered([1], device=None, compiled=object())
    r.decorate_batch_generator(lambda: iter([(np.ones((1, 4)),)]), places=object())
    with pytest.raises(NotImplementedError, match="A10"):
        list(r())
