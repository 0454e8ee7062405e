"""DeepFM in paddle_tpu_torch against paddle_tpu: the model
(``models.deepfm_ctr``) in both table modes, its two new ops, and its
training.

Small size, as tests/test_models.py builds it: 8 fields, 200 features,
embed 4, deep (16, 16), batch 32; inputs from a numpy seed.

* Desc parity: the same Program JSON (ops, attrs, vars and the
  ``distributed_tables`` metadata) in both modes, main and startup.
* Op parity, forward and vjp (the generic ``<type>_grad``):
  ``sigmoid_cross_entropy_with_logits`` with and without ``ignore_index``
  and ``normalize``, and ``distributed_lookup_table`` with and without
  ``padding_idx``, on [B, F, 1] and [B, F] ids; fp32 at rtol 1e-5, atol
  1e-6 (the two frameworks round log1p and exp by an ulp or so).  The
  sigmoid loss's vjp is also held to sigmoid(x) - label in float64; the
  JAX package's takes -label at a logit of exactly 0, the one exception
  (ROADMAP queue C).
* Run parity: 6 ``AdamOptimizer(1e-3)`` steps from the JAX package's
  saved startup state in HBM mode: losses within rtol 1e-5 and every
  parameter within atol 1e-5 (summation order; Adam's first steps move a
  parameter by about lr).  In PS mode the port's and the JAX package's
  trainers, each against servers of its own package (zero rows,
  server-side SGD 0.05) and from the same saved head, 6 steps on a batch:
  losses within rtol 2e-4, atol 1e-6 (the PS-against-dense tolerance of
  tests/test_distributed.py).
* ``Auc`` of the fetched probabilities is the JAX package's, exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import models as jmodels
from paddle_tpu.core import registry as jreg
from paddle_tpu.distributed import ps as jps
from paddle_tpu_torch import models as tmodels
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.distributed import ps as tps

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)
F, NF, EMB, DEEP, B = 8, 200, 4, (16, 16), 32
PKG = {"jax": (jfluid, jmodels), "torch": (tfluid, tmodels)}


def build(pkg, distributed=False, opt="adam", seed=7, ids_shape=(F, 1)):
    fluid, models = PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", list(ids_shape), dtype="int64")
        vals = fluid.layers.data("vals", [F], dtype="float32")
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, prob = models.deepfm_ctr(ids, vals, lbl, num_features=NF, num_fields=F,
                                       embed_dim=EMB, deep_layers=DEEP,
                                       distributed_emb=distributed)
        if opt == "adam":
            fluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
        elif opt == "sgd":
            fluid.optimizer.SGDOptimizer(0.05).minimize(loss)
    return main, startup, loss, prob


def feeds(n, seed=0, rows=B):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, NF, (rows, F, 1)).astype("int64"),
             "vals": rng.uniform(0, 1, (rows, F)).astype("float32"),
             "lbl": rng.randint(0, 2, (rows, 1)).astype("int64")} for _ in range(n)]


# ---------------------------------------------------------------------------
# desc parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("program", ["main", "startup"])
@pytest.mark.parametrize("distributed", [False, True], ids=["hbm", "ps"])
@pytest.mark.parametrize("opt", ["adam", "sgd", None])
def test_desc_parity(distributed, program, opt):
    j = build("jax", distributed, opt)
    t = build("torch", distributed, opt)
    idx = 0 if program == "main" else 1
    assert json.loads(t[idx].to_json()) == json.loads(j[idx].to_json())
    assert (t[2].name, t[3].name) == (j[2].name, j[3].name)
    if distributed and program == "main":
        assert t[0]._distributed_tables == j[0]._distributed_tables
        assert {m["table"] for m in t[0]._distributed_tables.values()} == {
            "deepfm_w1_emb", "deepfm_fm_emb"}
        assert not any(p.name.endswith("_emb") for p in t[0].all_parameters())


def test_ps_mode_ops():
    types = [o.type for o in build("torch", True)[0].global_block().ops]
    assert types.count("distributed_lookup_table") == 2 and "lookup_table" not in types
    assert types.count("distributed_lookup_table_grad") == 2
    types = [o.type for o in build("torch", False)[0].global_block().ops]
    assert types.count("lookup_table") == 2 and types.count("adam") == 2 + 2 * (len(DEEP) + 1)


def test_auc_layer_raises_in_both():
    for pkg in PKG:
        fluid = PKG[pkg][0]
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data("x", [1])
            with pytest.raises(NotImplementedError, match="metrics.Auc"):
                fluid.layers.auc(x, x)


# ---------------------------------------------------------------------------
# op parity, forward and vjp
# ---------------------------------------------------------------------------
def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run(op_type, inputs, attrs):
    jin = {s: [jnp.asarray(a) for a in arrs] for s, arrs in inputs.items()}
    tin = {s: [torch.from_numpy(np.require(a, requirements="C")) for a in arrs]
           for s, arrs in inputs.items()}
    jout = jreg.get_kernel(op_type)(jin, dict(attrs))
    tout = treg.get_kernel(op_type)(tin, dict(attrs), CPU)
    res = {}
    for slot, jv in jout.items():
        jv = jv if isinstance(jv, (list, tuple)) else [jv]
        tv = tout[slot]
        tv = tv if isinstance(tv, (list, tuple)) else [tv]
        res[slot] = [(_np(a), _np(b)) for a, b in zip(jv, tv)]
    return res


def _check(res):
    for slot, pairs in res.items():
        for j, t in pairs:
            assert j.shape == t.shape and t.dtype == j.dtype, (slot, t.shape, j.shape)
            np.testing.assert_allclose(t, j, err_msg=slot, **TOL)


def _check_op_and_grad(op_type, inputs, attrs, rng):
    outs = _run(op_type, inputs, attrs)
    _check(outs)
    want = tuple(s for s in inputs if s not in treg.get_op(op_type).no_grad_set)
    g_attrs = dict(attrs, __fwd_output_slots__=tuple(outs), __grad_input_slots__=want)
    g_inputs = dict(inputs)
    g_inputs["Out@GRAD"] = [rng.randn(*outs["Out"][0][0].shape).astype("float32")]
    res = _run(op_type + "_grad", g_inputs, g_attrs)
    assert set(res) == {s + "@GRAD" for s in want}
    _check(res)
    return outs, res


@pytest.mark.parametrize("ignore,normalize", [(-100, False), (-1, False), (-1, True),
                                              (0, True)])
def test_sigmoid_cross_entropy_with_logits(ignore, normalize):
    rng = np.random.RandomState(3)
    x = rng.uniform(-4, 4, (B, 3)).astype("float32")
    x[::4, 0] = 0.0  # logits of a zero-initialised model: max(x, 0)'s tie
    label = rng.randint(0, 2, (B, 3)).astype("float32")
    if ignore == -1:
        label[::5, 1] = -1.0
    attrs = {"ignore_index": ignore, "normalize": normalize}
    outs = _run("sigmoid_cross_entropy_with_logits", {"X": [x], "Label": [label]}, attrs)
    _check(outs)
    dout = rng.randn(B, 3).astype("float32")
    g_attrs = dict(attrs, __fwd_output_slots__=("Out",), __grad_input_slots__=("X",))
    grads = _run("sigmoid_cross_entropy_with_logits_grad",
                 {"X": [x], "Label": [label], "Out@GRAD": [dout]}, g_attrs)
    assert set(grads) == {"X@GRAD"}
    jg, tg = grads["X@GRAD"][0]
    assert tg.shape == jg.shape and tg.dtype == jg.dtype
    ignored = label == ignore
    assert ignored.any() == (ignore != -100)
    assert (outs["Out"][0][1][ignored] == 0).all()
    assert (tg[ignored] == 0).all()
    # the calculus, in float64: (sigmoid(x) - label) * dOut / norm where kept
    norm = max(int((~ignored).sum()), 1) if normalize else 1
    want = (1 / (1 + np.exp(-x.astype(np.float64))) - label) * dout / norm
    want[ignored] = 0
    np.testing.assert_allclose(tg, want, **TOL)
    # the JAX package's vjp agrees everywhere but at a logit of exactly 0,
    # where its jnp.abs takes slope 1 and gives -label (ROADMAP queue C)
    tie = (x == 0) & ~ignored
    assert tie.any()
    np.testing.assert_allclose(tg[~tie], jg[~tie], **TOL)
    np.testing.assert_allclose(jg[tie], (-label * dout / norm)[tie], **TOL)


@pytest.mark.parametrize("ids_shape", [(B, F, 1), (B, F)], ids=["BF1", "BF"])
@pytest.mark.parametrize("padding_idx", [-1, 0, 5])
def test_distributed_lookup_table(padding_idx, ids_shape):
    rng = np.random.RandomState(4)
    orig = rng.randint(0, 12, ids_shape).astype("int64")
    orig.reshape(-1)[::7] = 5  # some pad tokens for padding_idx 5
    uniq, inv = np.unique(orig, return_inverse=True)
    local = inv.reshape(orig.shape[:2]).astype("int32")
    rows = rng.randn(16, EMB).astype("float32")  # a bucket of 16 rows, 12 used at most
    outs, grads = _check_op_and_grad(
        "distributed_lookup_table",
        {"Rows": [rows], "Ids": [local], "OrigIds": [orig]},
        {"table": "t", "padding_idx": padding_idx}, rng)
    out = outs["Out"][0][1]
    assert out.shape == (B, F, EMB)
    flat = orig.reshape(B, F)
    if padding_idx >= 0:
        assert (out[flat == padding_idx] == 0).all()
        pad_row = np.where(uniq == padding_idx)[0]
        if len(pad_row):  # a pad token's row gets no gradient
            assert (grads["Rows@GRAD"][0][1][pad_row] == 0).all()
    assert (grads["Rows@GRAD"][0][1][len(uniq):] == 0).all()  # the bucket's padding rows


# ---------------------------------------------------------------------------
# run parity
# ---------------------------------------------------------------------------
def _jax_state(tmp_path, distributed=False, opt="adam"):
    jm, js, jl, jp = build("jax", distributed, opt)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / ("jax_%s_%s" % (distributed, opt)))
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.io.save_persistables(exe, d, jm)
    return jm, jl, jp, exe, scope, d


def test_six_adam_steps_match_jax(tmp_path):
    jm, jl, jp, jexe, jscope, d = _jax_state(tmp_path)
    tm, _, tl, tp = build("torch")
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.load_persistables(texe, d, tm, scope=tscope)
    jprobs, tprobs, labels = [], [], []
    for step, f in enumerate(feeds(6)):
        with jfluid.scope_guard(jscope):
            jloss, jprob = jexe.run(jm, feed=f, fetch_list=[jl, jp])
        tloss, tprob = texe.run(tm, feed=f, fetch_list=[tl, tp], scope=tscope)
        np.testing.assert_allclose(float(tloss), float(np.asarray(jloss)), rtol=1e-5, err_msg=step)
        np.testing.assert_allclose(tprob, np.asarray(jprob), **TOL)
        jprobs.append(np.asarray(jprob))
        tprobs.append(tprob)
        labels.append(f["lbl"])
    for p in tm.all_parameters():
        j = np.asarray(jscope.get(p.name))
        t = tfluid.scope.to_numpy(tscope.get(p.name)).reshape(j.shape)
        assert np.abs(t - j).max() <= 1e-5, (p.name, np.abs(t - j).max())
    # the CTR user's read-out: a streaming AUC over the epoch's probabilities
    jauc, tauc = jfluid.metrics.Auc("auc"), tfluid.metrics.Auc("auc")
    for jpr, tpr, lb in zip(jprobs, tprobs, labels):
        jauc.update(np.concatenate([1 - jpr, jpr], 1), lb)
        tauc.update(np.concatenate([1 - jpr, jpr], 1), lb)
    assert tauc.eval() == jauc.eval() and 0.0 <= tauc.eval() <= 1.0


def test_bf_feed_of_a_bf1_var(tmp_path):
    """The dataset gives ``[B, F]`` ids for a ``[F, 1]`` var: both modes
    take it, with the same loss as ``[B, F, 1]``."""
    *_, d = _jax_state(tmp_path)
    f = feeds(1)[0]
    flat = dict(f, ids=f["ids"].reshape(B, F))
    out = []
    for feed in (f, flat):
        tm, _, tl, _ = build("torch")
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        tfluid.io.load_persistables(exe, d, tm, scope=scope)
        out.append(float(exe.run(tm.clone(for_test=True), feed=feed, fetch_list=[tl],
                                 scope=scope)[0]))
    assert out[0] == out[1]


def test_ps_mode_trains_as_the_jax_package(tmp_path):
    """Both trainers against servers of their own package, zero rows and
    server-side SGD 0.05, from the same saved head.  The head's output
    bias starts at 0.3, not 0: with zero rows and a zero bias every first
    logit is exactly 0, where the JAX package's loss gradient is off
    (ROADMAP queue C; the next test holds the port there)."""
    jm, jl, _, jexe, jscope, d = _jax_state(tmp_path, distributed=True, opt="sgd")
    np.save(tmp_path / ("jax_%s_%s" % (True, "sgd")) / "fc_2.b_0.npy",
            np.full([1], 0.3, np.float32))
    fs = feeds(1, seed=2) * 6  # one batch, six times: the loss must fall
    losses = {}
    for pkg, mod in (("jax", jps), ("torch", tps)):
        fluid = PKG[pkg][0]
        s1, s2 = mod.ParameterServer().start(), mod.ParameterServer().start()
        try:
            main, _, loss, _ = build(pkg, True, "sgd")
            fluid.distributed.bind_distributed_tables(main, [s1.endpoint, s2.endpoint],
                                                      optimizer="sgd", lr=0.05,
                                                      initializer="zeros")
            if pkg == "jax":
                exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
                with jfluid.scope_guard(scope):
                    jfluid.io.load_persistables(exe, d, main)
                    losses[pkg] = [float(np.asarray(exe.run(main, feed=dict(f),
                                                            fetch_list=[loss])[0])) for f in fs]
            else:
                exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
                tfluid.io.load_persistables(exe, d, main, scope=scope)
                losses[pkg] = [float(exe.run(main, feed=dict(f), fetch_list=[loss],
                                             scope=scope)[0]) for f in fs]
                stats = exe.jit_cache_stats()
                assert stats["misses"] == 1 and stats["hits"] == len(fs) - 1  # one entry
                served = s1._dispatch({"op": "stats"})["deepfm_fm_emb"] + \
                    s2._dispatch({"op": "stats"})["deepfm_fm_emb"]
                assert served <= NF
        finally:
            s1.stop()
            s2.stop()
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=2e-4, atol=1e-6)
    assert losses["torch"][-1] < losses["torch"][0]


def test_ps_first_step_pushes_the_calculus_gradient():
    """Zero rows and a zero head bias put every first logit at exactly 0.
    The first-order table's pushed gradient must still be the calculus's,
    sum of vals * (sigmoid(0) - label) / B over each id's occurrences (the
    JAX package pushes -label there, ROADMAP queue C): server-side SGD at
    lr 1 leaves minus that gradient in the rows, held in float64 at rtol
    1e-5, atol 1e-7."""
    f = feeds(1, seed=2)[0]
    main, startup, loss, _ = build("torch", True, "sgd")
    s1, s2 = tps.ParameterServer().start(), tps.ParameterServer().start()
    try:
        tfluid.distributed.bind_distributed_tables(main, [s1.endpoint, s2.endpoint],
                                                   optimizer="sgd", lr=1.0,
                                                   initializer="zeros")
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        assert float(tfluid.scope.to_numpy(scope.get("fc_2.b_0"))[0]) == 0.0
        first = float(exe.run(main, feed=dict(f), fetch_list=[loss], scope=scope)[0])
        assert first == pytest.approx(np.log(2.0), rel=1e-6)  # every logit 0
        ids = f["ids"].reshape(-1)
        uniq, inv = np.unique(ids, return_inverse=True)
        per = (f["vals"].astype(np.float64) * (0.5 - f["lbl"].astype(np.float64))).reshape(-1)
        want = np.zeros(len(uniq))
        np.add.at(want, inv, per / B)
        cli = tps.PSClient([s1.endpoint, s2.endpoint])
        try:
            rows = np.asarray(cli.pull_sparse("deepfm_w1_emb", uniq), np.float64)
        finally:
            cli.close()
        np.testing.assert_allclose(rows.reshape(-1), -want, rtol=1e-5, atol=1e-7)
    finally:
        s1.stop()
        s2.stop()
