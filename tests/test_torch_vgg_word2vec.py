"""VGG-16 (``models/vgg.py``: config D of Simonyan & Zisserman 2014 with
batch norm) and the word2vec N-gram model (``models/word2vec.py``) of
paddle_tpu_torch against paddle_tpu.

Desc parity: the same model calls give the same Program JSON, main
and startup (training under Momentum, with and without the dropouts,
the ``is_test`` build, and VGG under bf16 AMP).  Run parity from the
JAX package's startup state on the same seeded batches, VGG-16 at 32x32
images, 10 classes, no dropout (the dropout masks cannot match
jax.random's bits), under ``MomentumOptimizer(lr, 0.9)``:

* one step at batch 2: the loss at rtol 1e-4 (read 9.4e-6), and all the
  gradients, taken as one vector, within twice the relative L2 distance
  by which the JAX package's own gradient moves when the images move by
  1e-6 relative (read 1.06e-3 against a yardstick of 2.14e-3).  At batch
  2 the batch_norm after the first fc normalises two numbers a feature,
  which it maps to about +-1 whatever they are: its backward is the
  difference of nearly equal terms, so every gradient below it carries
  rounding noise at 1e-3 of its size in either package, and the next
  steps' losses part (the JAX package's own loss moved 1.8% on the third
  step at lr 1e-3 under that nudge; the port's differed 2.6%).
* three steps at batch 16, lr 1e-4, where every batch_norm sees 16 rows
  or more: each step's loss at rtol 1e-4 (read 4.4e-5) and all the
  parameters after them, as one vector, within 1e-4 by relative L2
  distance (read 4.3e-6; a batch_norm bias starts at 0, so alone its
  few steps' moves carry the gradients' noise at a percent).

word2vec: four context words, dict 50, embed 8, hidden 16, ``SGD(0.5)``,
three steps, losses at rtol 1e-4 and parameters within 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch import models as tmodels
from torch_parity_util import assert_same_program, jax_startup_state, run_jax, run_port

PACKAGES = {"jax": (jfluid, jmodels), "torch": (tfluid, tmodels)}
HW, CLASSES, BATCH = 32, 10, 2
DICT, EMBED, HIDDEN, GRAMS = 50, 8, 16, 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vgg(pkg, dropout=False, is_test=False, amp=False, lr=1e-3):
    fluid, models = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, HW, HW])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, acc, pred = models.vgg16(img, lbl, class_num=CLASSES, is_test=is_test,
                                       dropout=dropout)
        if not is_test:
            opt = fluid.optimizer.MomentumOptimizer(lr, 0.9)
            if amp:
                opt = fluid.contrib.mixed_precision.decorate(opt)
            opt.minimize(loss)
    return main, startup, loss, pred


def _word2vec(pkg):
    fluid, models = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = [fluid.layers.data("w%d" % i, [1], dtype="int64") for i in range(GRAMS)]
        nxt = fluid.layers.data("next", [1], dtype="int64")
        loss, _ = models.word2vec.word2vec_ngram(words, nxt, DICT, EMBED, HIDDEN)
        fluid.optimizer.SGD(0.5).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("dropout,is_test,amp", [(False, False, False), (True, False, False),
                                                 (True, True, False), (True, False, True)])
def test_vgg16_desc_parity(dropout, is_test, amp):
    jm, js, _, _ = _vgg("jax", dropout, is_test, amp)
    tm, ts, _, _ = _vgg("torch", dropout, is_test, amp)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    ops = [op.type for op in tm.global_block().ops]
    assert ops.count("conv2d") == 13 and ops.count("batch_norm") == 14
    assert ops.count("dropout") == (2 if dropout else 0)


def test_word2vec_desc_parity():
    jm, js, _ = _word2vec("jax")
    tm, ts, _ = _word2vec("torch")
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    # one table shared by the four context words
    tables = {op.input("W")[0] for op in tm.global_block().ops if op.type == "lookup_table"}
    assert tables == {"shared_w"}


def _max_rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - b).max() / max(np.abs(b).max(), 1e-30))


def _three_steps(jm, js, tm, feeds, loss_name):
    """Three steps in both packages from the JAX package's startup state:
    the losses, and the scopes' parameters after them."""
    state = jax_startup_state(js, jm)
    jout, jscope = run_jax(jm, state, feeds, [loss_name], steps=3)
    tout, tscope = run_port(tm, state, feeds, [loss_name], steps=3)
    np.testing.assert_allclose([float(o[0]) for o in tout], [float(o[0]) for o in jout],
                               rtol=1e-4)
    names = [p.name for p in jm.all_parameters()]
    return [tscope.get(n).numpy() for n in names], [np.asarray(jscope.get(n)) for n in names]


def _vgg_feeds(rng, rows, n):
    return [{"img": rng.uniform(-1, 1, (rows, 3, HW, HW)).astype("float32"),
             "lbl": rng.randint(0, CLASSES, (rows, 1)).astype("int64")} for _ in range(n)]


def _global_rel(a, b):
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2)) for x, y in zip(a, b))
    return float(np.sqrt(num / sum(float(np.sum(np.asarray(y, np.float64) ** 2)) for y in b)))


def test_vgg16_first_step_at_batch_2():
    jm, js, jloss, _ = _vgg("jax")
    tm, _, _, _ = _vgg("torch")
    rng = np.random.RandomState(0)
    feed, = _vgg_feeds(rng, BATCH, 1)
    nudged = dict(feed, img=(feed["img"] * (1 + 1e-6 * rng.standard_normal(
        feed["img"].shape))).astype("float32"))
    state = jax_startup_state(js, jm)
    grads = [p.name + "@GRAD" for p in jm.all_parameters()]
    fetch = [jloss.name] + grads
    (j,), _ = run_jax(jm, state, feed, fetch)
    (jn,), _ = run_jax(jm, state, nudged, fetch)
    (t,), _ = run_port(tm, state, feed, fetch)
    np.testing.assert_allclose(float(t[0]), float(j[0]), rtol=1e-4)
    assert _global_rel(t[1:], j[1:]) <= 2 * _global_rel(jn[1:], j[1:])


def test_vgg16_three_momentum_steps_match():
    jm, js, jloss, _ = _vgg("jax", lr=1e-4)
    tm, _, _, _ = _vgg("torch", lr=1e-4)
    port, jax = _three_steps(jm, js, tm, _vgg_feeds(np.random.RandomState(0), 16, 3), jloss.name)
    assert _global_rel(port, jax) < 1e-4


def test_word2vec_three_sgd_steps_match():
    jm, js, jloss = _word2vec("jax")
    tm, _, _ = _word2vec("torch")
    rng = np.random.RandomState(1)
    feeds = []
    for _ in range(3):
        feed = {"w%d" % i: rng.randint(0, DICT, (8, 1)).astype("int64") for i in range(GRAMS)}
        feed["next"] = rng.randint(0, DICT, (8, 1)).astype("int64")
        feeds.append(feed)
    for p, j in zip(*_three_steps(jm, js, tm, feeds, jloss.name)):
        assert _max_rel(p, j) < 1e-4


def test_vgg16_served_from_a_jax_export(tmp_path):
    """The JAX package's ``is_test`` VGG-16 export, served by the port's
    predictor on the CPU: the same probabilities (atol 1e-5)."""
    jm, js, _, jpred = _vgg("jax", dropout=True, is_test=True)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(js)
        jfluid.io.save_inference_model(str(tmp_path), ["img"], [jpred], exe, main_program=jm)
    img = np.random.RandomState(2).uniform(-1, 1, (3, 3, HW, HW)).astype("float32")
    jcfg = jfluid.inference.AnalysisConfig(str(tmp_path))
    jcfg.disable_gpu()
    want = np.asarray(jfluid.inference.create_paddle_predictor(jcfg).run({"img": img})[0])
    cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    got, = tfluid.inference.create_paddle_predictor(cfg).run({"img": img})
    assert got.shape == (3, CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-5)
