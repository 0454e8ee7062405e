"""The optimizers of paddle_tpu_torch against paddle_tpu.

* Each update op (lars_momentum, adamax, adagrad, decayed_adagrad,
  adadelta, rmsprop, ftrl, lamb, average_accumulates, dgc_momentum) on
  the same numpy inputs as the JAX op, over its attrs: atol 1e-6, rtol
  1e-5 (fp32 in both; the norms of lars and lamb sum in other orders).
  Integer counters compare exactly after a cast (the JAX package runs
  with x64 off, so its counters are int32 where the port's are int64).
  dgc_momentum's inputs have distinct magnitudes, so both top-k pick
  the same elements.
* Every optimizer class builds the JAX package's main and startup
  programs, op for op and var for var.
* Run parity: three steps from the JAX package's startup state on the
  same feeds, the losses at rtol 1e-5 and every persistable (parameters
  and accumulators) at atol 1e-5, rtol 1e-5 after them.  Lamb trains a
  2-layer BERT (d_model 64); each other optimizer trains LeNet-5.  The
  BERT key-projection biases have a gradient that is zero in exact
  arithmetic (the softmax cancels a bias on the keys), so both packages
  compute rounding noise there, which Lamb's normalised update (its trust
  ratio is 1 at the biases' zero start) scales up to lr; those elements
  are held to 2 * lr a step, as tests/test_torch_train.py holds Adam's.
  On LeNet the same holds in small: Adamax and DecayedAdagrad divide
  each gradient element by a running norm of itself, so an element whose
  gradient is a sum that cancels to rounding noise moves by a full
  update, in a direction the rounding picks.  At most one element of a
  tensor, or 1e-3 of its elements where that is more, may lie beyond
  RUN_TOL, each within twice the
  largest move any element of that tensor made over the steps (a step
  the other way); every other element is held to RUN_TOL.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.scope import to_numpy

import jax.numpy as jnp

CPU = torch.device("cpu")
OP_TOL = dict(atol=1e-6, rtol=1e-5)
RUN_TOL = dict(atol=1e-5, rtol=1e-5)


def _f32(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _distinct(rng, *shape):
    """Values whose magnitudes are all distinct (no top-k ties)."""
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1.0) / n
    return (mags * rng.choice([-1.0, 1.0], n)).reshape(shape).astype("float32")


def _op_cases():
    rng = np.random.RandomState(0)
    sh = (6, 5)
    p, g = _f32(rng, *sh), _f32(rng, *sh)
    pos = lambda: (np.abs(_f32(rng, *sh)) + 0.1).astype("float32")  # noqa: E731
    lr = np.array([0.05], "float32")
    zero = np.zeros(sh, "float32")
    lars = {"Param": p, "Grad": g, "Velocity": _f32(rng, *sh), "LearningRate": lr}
    lamb = {"Param": p, "Grad": g, "Moment1": _f32(rng, *sh) * 0.1, "Moment2": pos() * 0.1,
            "Beta1Pow": np.array([0.9 ** 3], "float32"),
            "Beta2Pow": np.array([0.999 ** 3], "float32"), "LearningRate": lr}
    mg = _f32(rng, *sh) * 0.1
    rms = {"Param": p, "Grad": g, "Moment": _f32(rng, *sh), "MeanSquare": pos() + mg * mg,
           "MeanGrad": mg, "LearningRate": lr}
    cases = {
        "lars_momentum": ("lars_momentum", lars, {"mu": 0.9, "lars_coeff": 0.001,
                                                  "lars_weight_decay": 0.0005}),
        "lars_momentum_zero_param": ("lars_momentum", dict(lars, Param=zero),
                                     {"mu": 0.9, "lars_coeff": 0.01, "lars_weight_decay": 0.0}),
        "adamax": ("adamax", {"Param": p, "Grad": g, "Moment": _f32(rng, *sh), "InfNorm": pos(),
                              "Beta1Pow": np.array([0.9 ** 2], "float32"), "LearningRate": lr},
                   {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}),
        "adagrad": ("adagrad", {"Param": p, "Grad": g, "Moment": pos(), "LearningRate": lr},
                    {"epsilon": 1e-6}),
        "decayed_adagrad": ("decayed_adagrad", {"Param": p, "Grad": g, "Moment": pos(),
                                                "LearningRate": lr},
                            {"decay": 0.95, "epsilon": 1e-6}),
        "adadelta": ("adadelta", {"Param": p, "Grad": g, "AvgSquaredGrad": pos(),
                                  "AvgSquaredUpdate": pos()}, {"rho": 0.95, "epsilon": 1e-6}),
        "ftrl": ("ftrl", {"Param": p, "Grad": g, "SquaredAccumulator": pos(),
                          "LinearAccumulator": _f32(rng, *sh), "LearningRate": lr},
                 {"l1": 0.1, "l2": 0.01, "lr_power": -0.5}),
        "ftrl_zero_accumulator": ("ftrl", {"Param": p, "Grad": g, "SquaredAccumulator": zero,
                                           "LinearAccumulator": zero, "LearningRate": lr},
                                  {"l1": 0.0, "l2": 0.0, "lr_power": -0.5}),
        "ftrl_lr_power": ("ftrl", {"Param": p, "Grad": g, "SquaredAccumulator": pos(),
                                   "LinearAccumulator": _f32(rng, *sh), "LearningRate": lr},
                          {"l1": 0.05, "l2": 0.1, "lr_power": -1.0}),
        "lamb": ("lamb", lamb, {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6,
                                "weight_decay": 0.01}),
        "lamb_zero_param": ("lamb", dict(lamb, Param=zero), {"weight_decay": 0.0}),
    }
    for centered in (False, True):
        for mu in (0.0, 0.9):
            cases["rmsprop_%s_mu%g" % ("centered" if centered else "plain", mu)] = (
                "rmsprop", rms, {"decay": 0.9, "epsilon": 1e-6, "momentum": mu,
                                 "centered": centered})
    # average_accumulates: max_num_accumulates 4; counters before the step
    for name, (acc, old, upd) in {"no_restart": (1, 0, 1), "spill": (1, 0, 3),
                                  "restart": (5, 3, 8), "spill_and_restart": (5, 3, 7)}.items():
        cases["average_accumulates_" + name] = (
            "average_accumulates",
            {"Param": p, "Sum1": _f32(rng, *sh), "Sum2": _f32(rng, *sh), "Sum3": _f32(rng, *sh),
             "NumAccumulates": np.array([acc], "int64"),
             "OldNumAccumulates": np.array([old], "int64"),
             "NumUpdates": np.array([upd], "int64")},
            {"average_window": 0.5, "max_num_accumulates": 4, "min_average_window": 3,
             "max_average_window": 6})
    for name, step in (("before_rampup", 1.0), ("after_rampup", 5.0)):
        cases["dgc_momentum_" + name] = (
            "dgc_momentum",
            {"Param": p, "Grad": _distinct(rng, *sh), "U": _distinct(rng, *sh) * 0.5,
             "V": _distinct(rng, *sh) * 0.25, "CurrentStep": np.array([step], "float32"),
             "LearningRate": lr},
            {"mu": 0.9, "sparsity": 0.8, "rampup_begin_step": 2.0})
    return cases


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_update_op_matches_jax(case):
    op_type, inputs, attrs = _op_cases()[case]
    jout = jreg.get_kernel(op_type)({s: [jnp.asarray(a)] for s, a in inputs.items()}, dict(attrs))
    tout = treg.get_kernel(op_type)(
        {s: [torch.from_numpy(np.require(a, requirements="C"))] for s, a in inputs.items()},
        dict(attrs), CPU)
    assert set(tout) == set(jout)
    for slot, jv in jout.items():
        j, t = _np(jv), _np(tout[slot])
        assert t.shape == j.shape, slot
        assert np.isfinite(t).all(), slot
        if j.dtype.kind in "iub":
            assert t.dtype == np.int64, slot
            np.testing.assert_array_equal(t, j.astype(t.dtype), err_msg=slot)
        else:
            np.testing.assert_allclose(t, j, err_msg=slot, **OP_TOL)
    if op_type == "average_accumulates":  # the case names say which branch runs
        n_upd = int(inputs["NumUpdates"][0]) + 1
        assert (n_upd % 4 == 0) == ("spill" in case)
        assert (int(_np(tout["NumAccumulatesOut"])[0]) == 0) == ("restart" in case
                                                                  and "no_restart" not in case)
    if op_type == "dgc_momentum":
        moved = np.count_nonzero(_np(tout["ParamOut"]) != inputs["Param"])
        assert moved == (30 if "before" in case else 6)  # dense, or k = round(30 * 0.2)


def test_dgc_collective_and_pipeline_stages_raise():
    op_type, inputs, attrs = _op_cases()["dgc_momentum_after_rampup"]
    with pytest.raises(NotImplementedError, match="A10"):
        treg.get_kernel(op_type)({s: [torch.from_numpy(a)] for s, a in inputs.items()},
                                 dict(attrs, use_collective=True), CPU)
    with pytest.raises(NotImplementedError, match="A10"):
        tfluid.optimizer.PipelineOptimizer(tfluid.optimizer.SGDOptimizer(0.1), cut_list=["h"])


# ---------------------------------------------------------------------------
# desc parity of every optimizer class
# ---------------------------------------------------------------------------
OPTIMIZERS = {
    "sgd": lambda O: O.SGDOptimizer(0.1),
    "momentum": lambda O: O.MomentumOptimizer(0.05, 0.9, use_nesterov=True),
    "adam": lambda O: O.AdamOptimizer(0.01),
    "lars": lambda O: O.LarsMomentumOptimizer(0.1, 0.9),
    "adagrad": lambda O: O.AdagradOptimizer(0.1, initial_accumulator_value=0.1),
    "decayed_adagrad": lambda O: O.DecayedAdagradOptimizer(0.05),
    "adamax": lambda O: O.AdamaxOptimizer(0.01),
    "adadelta": lambda O: O.AdadeltaOptimizer(1.0, rho=0.9),
    "rmsprop": lambda O: O.RMSPropOptimizer(0.01),
    "rmsprop_centered": lambda O: O.RMSPropOptimizer(0.01, momentum=0.9, centered=True),
    "ftrl": lambda O: O.FtrlOptimizer(0.1, l1=0.01, l2=0.01),
    "lamb": lambda O: O.LambOptimizer(0.01, lamb_weight_decay=0.02),
    "dgc": lambda O: O.DGCMomentumOptimizer(0.05, 0.9, rampup_begin_step=1),
}
ALIASES = {"SGD": "SGDOptimizer", "Momentum": "MomentumOptimizer",
           "LarsMomentum": "LarsMomentumOptimizer", "Adagrad": "AdagradOptimizer",
           "DecayedAdagrad": "DecayedAdagradOptimizer", "Adam": "AdamOptimizer",
           "Adamax": "AdamaxOptimizer", "Adadelta": "AdadeltaOptimizer",
           "RMSProp": "RMSPropOptimizer", "Ftrl": "FtrlOptimizer", "Lamb": "LambOptimizer"}


def _net(fluid, make_opt, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 16, act="relu")
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(fluid.layers.fc(h, 3), y))
        opt = make_opt(fluid.optimizer)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup


def _canon_dtype(d):
    return "int64" if d in ("int32", "int64") else d


def _assert_same_desc(jp, tp):
    jb, tb = jp.global_block(), tp.global_block()
    assert [o.type for o in tb.ops] == [o.type for o in jb.ops]
    for jo, to in zip(jb.ops, tb.ops):
        assert (to.inputs, to.outputs, to.attrs) == (jo.inputs, jo.outputs, jo.attrs), jo.type
    assert list(tb.vars) == list(jb.vars)
    for name, jv in jb.vars.items():
        tv = tb.vars[name]
        assert (tv.shape, _canon_dtype(tv.dtype)) == (jv.shape, _canon_dtype(jv.dtype)), name
        assert (tv.persistable, tv.is_data, tv.stop_gradient) == \
            (jv.persistable, jv.is_data, jv.stop_gradient), name
        assert type(tv).__name__ == type(jv).__name__, name


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_desc_parity(name, amp):
    j = _net(jfluid, OPTIMIZERS[name], amp)
    t = _net(tfluid, OPTIMIZERS[name], amp)
    for jp, tp in zip(j, t):
        _assert_same_desc(jp, tp)


def test_optimizer_aliases():
    for alias, cls in ALIASES.items():
        assert getattr(tfluid.optimizer, alias) is getattr(tfluid.optimizer, cls)
    assert set(tfluid.optimizer.__all__) == set(jfluid.optimizer.__all__)


# ---------------------------------------------------------------------------
# run parity
# ---------------------------------------------------------------------------
def _persistables(program):
    return sorted({v.name for v in program.list_vars() if v.persistable and not v.is_data})


def _train_both(build, batches):
    """Both packages' programs from the JAX package's startup state, one
    step a batch: (losses, {persistable: (jax, port)} after the steps)."""
    (jm, js, jloss), (tm, _, tloss) = build(jfluid), build(tfluid)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = _persistables(jm)
    assert names == _persistables(tm)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.set_params_from_numpy(tscope, {n: np.asarray(jscope.get(n)) for n in names},
                                    texe.device, program=tm)
    init = {n: np.asarray(jscope.get(n)) for n in names}
    losses = []
    for feed in batches:
        with jfluid.scope_guard(jscope):
            jl, = jexe.run(jm, feed=feed, fetch_list=[jloss])
        tl, = texe.run(tm, feed=feed, fetch_list=[tloss.name], scope=tscope)
        losses.append((float(np.asarray(jl)), float(tl)))
    return losses, {n: (np.asarray(jscope.get(n)), to_numpy(tscope.get(n)), init[n])
                    for n in names}


def _lenet(make_opt):
    def build(fluid):
        models = jmodels if fluid is jfluid else tmodels
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 42
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            img = fluid.layers.data("img", [1, 28, 28])
            lbl = fluid.layers.data("lbl", [1], dtype="int64")
            loss, _, _ = models.lenet5(img, lbl)
            make_opt(fluid.optimizer).minimize(loss)
        return main, startup, loss
    return build


def _lenet_feeds(n, seed=0, batch=4):
    rng = np.random.RandomState(seed)
    return [{"img": rng.uniform(0, 1, (batch, 1, 28, 28)).astype("float32"),
             "lbl": rng.randint(0, 10, (batch, 1)).astype("int64")} for _ in range(n)]


@pytest.mark.parametrize("name", sorted(set(OPTIMIZERS) - {"sgd", "momentum", "adam", "lamb"}))
def test_lenet_run_parity_three_steps(name):
    losses, state = _train_both(_lenet(OPTIMIZERS[name]), _lenet_feeds(3))
    for j, t in losses:
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    for n, (j, t, j0) in state.items():
        t = t.reshape(j.shape)
        over = np.abs(t - j) > RUN_TOL["atol"] + RUN_TOL["rtol"] * np.abs(j)
        assert over.sum() <= max(1, 1e-3 * j.size), (n, int(over.sum()))
        if over.any():  # rounding noise through a normalised update
            move = np.abs(j - j0.reshape(j.shape)).max()
            assert np.abs(t - j)[over].max() <= 2 * move, n


SMALL_BERT = dict(vocab_size=100, d_model=64, n_layer=2, n_head=4, d_inner=128, max_pos=64,
                  seq_len=16, dropout_rate=0.0, fused_attention=True)
LAMB_LR = 1e-3


def _bert_lamb(fluid):
    transformer = jtransformer if fluid is jfluid else ttransformer
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 0
    s = SMALL_BERT["seq_len"]
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ins = [fluid.layers.data(n, [w], dtype=d) for n, w, d in (
            ("src_ids", s, "int64"), ("sent_ids", s, "int64"), ("input_mask", s, "float32"),
            ("mask_pos", 1, "int64"), ("mask_label", 1, "int64"), ("nsp_label", 1, "int64"))]
        total = transformer.bert_pretrain(*ins, **SMALL_BERT)[0]
        fluid.optimizer.LambOptimizer(LAMB_LR, lamb_weight_decay=0.01).minimize(total)
    return main, startup, total


def _bert_feed(rng, rows=4, masks=3):
    s, vocab = SMALL_BERT["seq_len"], SMALL_BERT["vocab_size"]
    lens = rng.randint(s // 2, s + 1, rows)
    lens[0] = s
    pos = np.stack([rng.choice(np.arange(1, lens[i]), masks, replace=False) + i * s
                    for i in range(rows)])
    return {"src_ids": rng.randint(0, vocab, (rows, s)).astype("int64"),
            "sent_ids": (np.arange(s)[None, :] >= (lens[:, None] // 2)).astype("int64"),
            "input_mask": (np.arange(s)[None, :] < lens[:, None]).astype("float32"),
            "mask_pos": pos.reshape(-1, 1).astype("int64"),
            "mask_label": rng.randint(0, vocab, (rows * masks, 1)).astype("int64"),
            "nsp_label": rng.randint(0, 2, (rows, 1)).astype("int64")}


def test_lamb_bert_run_parity_three_steps():
    rng = np.random.RandomState(100)
    losses, state = _train_both(_bert_lamb, [_bert_feed(rng) for _ in range(3)])
    for j, t in losses:
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    assert losses[-1][1] < losses[0][1]
    noise = 0
    for n, (j, t, _) in state.items():
        t = t.reshape(j.shape)
        if n.endswith("_att_k_b"):  # rounding noise through a normalised update
            assert np.abs(t - j).max() <= 2 * LAMB_LR * len(losses), n
            noise += int((np.abs(t - j) > RUN_TOL["atol"] + RUN_TOL["rtol"] * np.abs(j)).sum())
        else:
            np.testing.assert_allclose(t, j, err_msg=n, **RUN_TOL)
    assert noise <= 2 * SMALL_BERT["d_model"]
