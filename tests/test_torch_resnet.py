"""The LeNet / ResNet slice of paddle_tpu_torch against paddle_tpu: the
programs' descs, training steps from the JAX package's state, a
JAX-exported ``is_test`` ResNet served by the port's predictor, and the
port's checkpoints.

Sizes: LeNet-5 as the model defines it (1x28x28 images, 10 classes),
batch 4; ResNet-18 and ResNet-50 at 64x64 images, batch 4, 10 classes.
``MomentumOptimizer(0.01, 0.9)``; images uniform in [0, 1) and labels
made from a seed with numpy.  The JAX package runs the startup, and
``io.set_params_from_numpy`` carries every persistable (parameters,
velocities, running statistics, learning rate) into the port's scope.

Why 64x64 and not 32x32: at 32x32 the last stage is 1x1, so with batch 2
each batch_norm there normalises 2 numbers, which it maps to +-1 whatever
they are; two near-equal numbers flip with rounding, and the loss of
ResNet-50's first step differed by 0.89 (of 1.96) between the packages.
At 64x64, batch 4 each such channel has 16 samples.

Tolerances, with what this file's configurations read on the CPU.
LeNet: losses rtol 1e-5, gradients, parameters and velocities atol 1e-5,
rtol 1e-5 (read 2e-7 and 1.3e-6).  ResNet first losses rtol 1e-4 (read
4.6e-6 to 2.3e-5); running statistics within 1e-3 of their largest
magnitude (read 5.5e-5 to 2.8e-4).  ResNet gradients are held as one
vector over all parameters, by relative L2 distance: the first step's
gradient of a randomly initialised ResNet is ill-conditioned (relu
kinks, batch_norm over 16 samples), so an input perturbation of 1e-6
relative moves either package's own ResNet-50 gradient by 4% to 5% and
its largest element by up to 1.9.  ResNet-50's are held to 0.1 (read
0.015 and 0.030), ResNet-18's to 1e-2 (read 7.6e-6).  ResNet-18's three
steps: losses rtol 5e-3 and parameters 1e-3 relative L2, since the
trajectories drift apart as the gradients do (read 5.3e-4 and 3.3e-4 on
the third step).  The AMP step (ResNet-18, NHWC) against the JAX
package's AMP step: loss rtol 2e-2, and against the port's fp32 step
5e-2 (bf16 rounds each conv's inputs to 8 bits of mantissa; read 2e-3
to 1.1e-2 and 3e-3 to 9.8e-3 over three batches).  The exported
``is_test`` model runs no batch statistics: its outputs are held at
atol 1e-5.  The port's own checkpoint round trip is exact on the CPU.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.scope import to_numpy

PACKAGES = {"jax": (jfluid, jmodels), "torch": (tfluid, tmodels)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's CPU kernels on two threads for this file: the tests run
    beside others in parallel, and all cores each would only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


LR = 0.01
HW, BATCH, CLASSES = 64, 4, 10


def build(pkg, model, fmt="NCHW", amp=False, lr=LR, hw=HW, is_test=False, seed=42):
    """(main, startup, avg_loss, prediction, params_grads) of ``model``
    under ``MomentumOptimizer(lr, 0.9)`` (``decorate``d with ``amp``), as
    bench.py builds ResNet-50; no optimizer with ``is_test``."""
    fluid, models = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "lenet5":
            img = fluid.layers.data("img", [1, 28, 28])
        else:
            img = fluid.layers.data("img", [3, hw, hw] if fmt == "NCHW" else [hw, hw, 3])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        if model == "lenet5":
            loss, _, pred = models.lenet5(img, lbl)
        else:
            loss, _, pred = getattr(models.resnet, model)(
                img, lbl, class_num=CLASSES, is_test=is_test, data_format=fmt)
        params_grads = None
        if not is_test:
            opt = fluid.optimizer.MomentumOptimizer(lr, 0.9)
            if amp:
                opt = fluid.contrib.mixed_precision.decorate(opt)
            _, params_grads = opt.minimize(loss)
    return main, startup, loss, pred, params_grads


def feeds(model, fmt, n, seed=0, batch=BATCH, hw=HW):
    rng = np.random.RandomState(seed)
    if model == "lenet5":
        shape = [batch, 1, 28, 28]
    else:
        shape = [batch, 3, hw, hw] if fmt == "NCHW" else [batch, hw, hw, 3]
    return [{"img": rng.uniform(0, 1, shape).astype("float32"),
             "lbl": rng.randint(0, CLASSES, (batch, 1)).astype("int64")} for _ in range(n)]


def _persistables(program):
    return sorted({v.name for v in program.list_vars() if v.persistable and not v.is_data})


def _canon_dtype(d):
    return "int64" if d in ("int32", "int64") else d


# ---------------------------------------------------------------------------
# desc parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model,fmt,amp", [
    ("lenet5", "NCHW", False), ("resnet50", "NCHW", False), ("resnet50", "NHWC", False),
    ("resnet50", "NHWC", True),
], ids=["lenet5", "resnet50_nchw", "resnet50_nhwc", "resnet50_nhwc_amp"])
def test_desc_parity(model, fmt, amp):
    """The same layer calls give the JAX package's Program JSON, main and
    startup, op for op and var for var (int32 and int64 ids aside)."""
    j = build("jax", model, fmt, amp, hw=224)
    t = build("torch", model, fmt, amp, hw=224)
    for jp, tp in zip(j[:2], t[:2]):
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
    if model == "resnet50":
        types = [o.type for o in t[0].global_block().ops]
        assert types.count("conv2d") == types.count("batch_norm") == 53
        assert types.count("momentum") == len(t[4]) == 161
        if amp:
            # conv2d white, batch_norm and pool2d gray: every conv and batch_norm runs bf16
            block = t[0].global_block()
            for op in block.ops:
                if op.type in ("conv2d", "batch_norm"):
                    x = op.input("Input" if op.type == "conv2d" else "X")[0]
                    assert block.var(x).dtype == "bfloat16", op.type
                if op.type == "batch_norm":
                    for slot in ("Scale", "Bias", "Mean", "Variance"):
                        assert block.var(op.input(slot)[0]).dtype == "float32", slot


# ---------------------------------------------------------------------------
# run parity
# ---------------------------------------------------------------------------
def _start_both(model, fmt="NCHW", amp=False):
    """Both packages' programs, from the JAX package's startup state."""
    jm, js, jloss, _, jpg = build("jax", model, fmt, amp)
    tm, _, tloss, _, tpg = build("torch", model, fmt, amp)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = _persistables(jm)
    assert names == _persistables(tm)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.get(n)) for n in names}, texe.device, program=tm)
    grads = [g.name for _, g in jpg]
    assert grads == [g.name for _, g in tpg]
    return (jm, jloss, jexe, jscope), (tm, tloss, texe, tscope), names, grads


def _steps(both, batches, fetch_grads_at=()):
    """Each package's losses over ``batches``, and the gradients of the
    steps in ``fetch_grads_at``."""
    (jm, jloss, jexe, jscope), (tm, tloss, texe, tscope), _, grads = both
    losses, gs = [], {}
    for i, feed in enumerate(batches):
        extra = grads if i in fetch_grads_at else []
        with jfluid.scope_guard(jscope):
            jr = jexe.run(jm, feed=feed, fetch_list=[jloss] + extra)
        tr = texe.run(tm, feed=feed, fetch_list=[tloss.name] + extra, scope=tscope)
        losses.append((float(np.asarray(jr[0])), float(tr[0])))
        if extra:
            gs[i] = ([np.asarray(a) for a in jr[1:]], tr[1:])
    return losses, gs


def _state(both, names):
    (_, _, _, jscope), (_, _, _, tscope) = both[:2]
    return {n: (np.asarray(jscope.get(n)), to_numpy(tscope.get(n))) for n in names}


def _global_rel_l2(js, ts):
    num = sum(float(np.sum((t.reshape(j.shape).astype(np.float64) - j) ** 2)) for j, t in zip(js, ts))
    den = sum(float(np.sum(j.astype(np.float64) ** 2)) for j in js)
    return np.sqrt(num / den)


def _running_stats(names):
    return [n for n in names if n.endswith((".mean_0", ".variance_0"))]


def test_lenet_run_parity_three_momentum_steps():
    both = _start_both("lenet5")
    losses, gs = _steps(both, feeds("lenet5", "NCHW", 3), fetch_grads_at=(0,))
    for j, t in losses:
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    for j, t in zip(*gs[0]):
        np.testing.assert_allclose(t.reshape(j.shape), j, atol=1e-5, rtol=1e-5)
    state = _state(both, both[2])
    assert any(n.endswith("_velocity_0") for n in state)
    for n, (j, t) in state.items():
        np.testing.assert_allclose(t.reshape(j.shape), j, atol=1e-5, rtol=1e-5, err_msg=n)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet18_run_parity_three_steps(fmt):
    both = _start_both("resnet18", fmt)
    losses, gs = _steps(both, feeds("resnet18", fmt, 3, seed=1), fetch_grads_at=(0,))
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=1e-4)
    for j, t in losses:
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=5e-3)
    assert _global_rel_l2(*gs[0]) <= 1e-2
    names = both[2]
    state = _state(both, names)
    stats = _running_stats(names)
    assert len(stats) == 2 * 20  # 20 batch_norms in ResNet-18
    for n in stats:
        j, t = state[n]
        assert np.abs(t - j).max() <= 1e-3 * np.abs(j).max(), n
    params = [n for n in names if n not in stats and "velocity" not in n
              and not n.startswith("learning_rate")]
    assert _global_rel_l2([state[n][0] for n in params], [state[n][1] for n in params]) <= 1e-3


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_resnet50_one_step_parity(fmt):
    """One Momentum step: the loss, the gradient (one vector over all 161
    parameters) and the running statistics it wrote, and each velocity
    equal to its gradient (zero before the step)."""
    both = _start_both("resnet50", fmt)
    names, grads = both[2], both[3]
    losses, gs = _steps(both, feeds("resnet50", fmt, 1, seed=2), fetch_grads_at=(0,))
    (jl, tl), = losses
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jg, tg = gs[0]
    assert len(jg) == 161
    assert _global_rel_l2(jg, tg) <= 0.1
    state = _state(both, names)
    stats = _running_stats(names)
    assert len(stats) == 2 * 53
    for n in stats:
        j, t = state[n]
        assert not np.array_equal(t, np.zeros_like(t) if n.endswith("mean_0") else np.ones_like(t))
        assert np.abs(t - j).max() <= 1e-3 * np.abs(j).max(), n
    for g, t in zip(grads, tg):
        v = state[g[: -len("@GRAD")] + "_velocity_0"][1]
        np.testing.assert_array_equal(v.reshape(t.shape), t)


def test_amp_resnet_step_on_the_cpu():
    """The AMP rewrite's program runs on the port: every new op takes the
    bf16 it is fed (conv2d, batch_norm, pool2d, relu, the residual adds),
    the loss matches the JAX package's AMP step and the fp32 step's within
    bf16's reach, and the master weights stay fp32."""
    both = _start_both("resnet18", "NHWC", amp=True)
    batch = feeds("resnet18", "NHWC", 1, seed=3)
    losses, _ = _steps(both, batch)
    (jl, tl), = losses
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    fp32 = _start_both("resnet18", "NHWC")
    (fj, ft), = _steps(fp32, batch)[0]
    np.testing.assert_allclose(tl, ft, rtol=5e-2)
    tscope = both[1][3]
    for n in both[2]:
        assert str(tscope.get(n).dtype) == "torch.float32", n


# ---------------------------------------------------------------------------
# an is_test export of the JAX package, served by the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_port_predictor_runs_jax_exported_resnet(tmp_path, fmt):
    main, startup, _, pred, _ = build("jax", "resnet50", fmt, is_test=True)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    rng = np.random.RandomState(5)
    with jfluid.scope_guard(scope):
        exe.run(startup)
        # running statistics away from their initial 0 and 1
        for n in _running_stats(_persistables(main)):
            c = np.asarray(scope.get(n)).shape
            scope.set(n, (rng.uniform(-0.1, 0.1, c) if n.endswith("mean_0")
                          else rng.uniform(0.5, 2.0, c)).astype("float32"))
        jfluid.io.save_inference_model(str(tmp_path), ["img"], [pred], exe, main_program=main)
        batch = feeds("resnet50", fmt, 1, seed=6)[0]
        ref, = exe.run(main, feed=batch, fetch_list=[pred])  # the JAX executor runs the loss too
    cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    cfg.disable_gpu()
    predictor = tfluid.inference.create_paddle_predictor(cfg)
    out, = predictor.run({"img": batch["img"]})
    assert out.shape == (BATCH, CLASSES) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _port_start(model="resnet18", fmt="NHWC", seed=42):
    main, startup, loss, _, _ = build("torch", model, fmt, seed=seed)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, loss, exe, scope


def test_save_and_load_persistables_round_trip(tmp_path):
    """Two steps, save_persistables, load_persistables into a fresh scope:
    the next step's loss and state are the uninterrupted run's, bit for
    bit.  The checkpoint holds the velocities and the running statistics;
    save_params holds the parameters alone: resuming from it gives the
    same loss (a training step's forward reads no velocity or running
    statistic) but another update (the velocities restart from zero)."""
    main, loss, exe, scope = _port_start()
    batches = feeds("resnet18", "NHWC", 3, seed=7)
    for f in batches[:2]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    tfluid.io.save_persistables(exe, str(tmp_path / "ckpt"), main, scope=scope)
    tfluid.io.save_params(exe, str(tmp_path / "params"), main, scope=scope)
    ref, = exe.run(main, feed=batches[2], fetch_list=[loss], scope=scope)

    names = _persistables(main)
    saved = {p.name for p in main.all_parameters()}
    stats = _running_stats(names)
    velocities = [n for n in names if n.endswith("_velocity_0")]
    assert stats and velocities and not (set(stats) | set(velocities)) & saved
    assert sorted(f.name[:-4] for f in (tmp_path / "params").glob("*.npy")) == sorted(saved)
    assert sorted(f.name[:-4] for f in (tmp_path / "ckpt").glob("*.npy")) == names

    fresh = tfluid.Scope()
    tfluid.io.load_persistables(exe, str(tmp_path / "ckpt"), main, scope=fresh)
    assert sorted(fresh.vars) == names
    got, = exe.run(main, feed=batches[2], fetch_list=[loss], scope=fresh)
    np.testing.assert_array_equal(got, ref)
    for n in names:
        np.testing.assert_array_equal(to_numpy(fresh.get(n)), to_numpy(scope.get(n)), err_msg=n)

    params_only = tfluid.Scope()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    exe2.run(build("torch", "resnet18", "NHWC")[1], scope=params_only)  # zero velocities, 0/1 stats
    tfluid.io.load_params(exe2, str(tmp_path / "params"), main, scope=params_only)
    other, = exe2.run(main, feed=batches[2], fetch_list=[loss], scope=params_only)
    np.testing.assert_array_equal(other, ref)
    w = "conv2d_0.w_0"
    assert not np.array_equal(to_numpy(params_only.get(w)), to_numpy(scope.get(w)))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A checkpoint written by the JAX package's save_persistables (after
    a Momentum step there) resumes on the port: the next step's loss
    matches the JAX package's."""
    jm, js, jloss, _, _ = build("jax", "lenet5")
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    b = feeds("lenet5", "NCHW", 2, seed=8)
    with jfluid.scope_guard(scope):
        exe.run(js)
        exe.run(jm, feed=b[0], fetch_list=[jloss])
        jfluid.io.save_persistables(exe, str(tmp_path), jm)
        ref, = exe.run(jm, feed=b[1], fetch_list=[jloss])
    tm, _, tloss, _, _ = build("torch", "lenet5")
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(texe, str(tmp_path), tm, scope=tscope)
    got, = texe.run(tm, feed=b[1], fetch_list=[tloss], scope=tscope)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)


def test_load_vars_by_name_and_predicate(tmp_path):
    main, loss, exe, scope = _port_start("lenet5", "NCHW")
    tfluid.io.save_persistables(exe, str(tmp_path), main, scope=scope, filename="all")
    one = tfluid.Scope()
    tfluid.io.load_vars(exe, str(tmp_path), main, vars=["conv2d_0.w_0"], scope=one)
    assert list(one.vars) == ["conv2d_0.w_0"]
    some = tfluid.Scope()
    tfluid.io.load_vars(exe, str(tmp_path), main, scope=some,
                        predicate=lambda v: v.name.startswith("fc_") and "velocity" not in v.name)
    assert sorted(some.vars) == ["fc_0.b_0", "fc_0.w_0", "fc_1.b_0", "fc_1.w_0"]


# ---------------------------------------------------------------------------
# the port alone: LeNet learns
# ---------------------------------------------------------------------------
def test_lenet_trains_from_its_own_startup():
    main, loss, exe, scope = _port_start("lenet5", "NCHW", seed=3)
    f = feeds("lenet5", "NCHW", 1, seed=9, batch=16)[0]
    losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]) for _ in range(12)]
    assert all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0]
