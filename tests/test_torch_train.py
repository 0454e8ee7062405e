"""The BERT-pretraining slice of paddle_tpu_torch against paddle_tpu:
the training program's desc, and training steps from the same state.

Small size: 2 layers, d_model 64, 4 heads, d_inner 128, seq 16, vocab
100, max_pos 64; inputs made from a seed with numpy.  Both packages
build ``bert_pretrain(..., fused_attention=True, dropout_rate=0.0)``
and minimize its total loss; the JAX package runs the startup, and
``io.set_params_from_numpy`` carries every persistable (parameters,
Adam moments, beta pows, learning rate) into the port's scope.

Tolerances: losses rtol 1e-5; step-1 gradients atol 1e-5, rtol 1e-4;
parameters after 3 steps atol 1e-6 with SGD and 1e-5 with Adam (the two
frameworks sum in different orders).  One exception, stated and
counted: the key-projection biases (``*_att_k_b``) have a gradient that
is zero in exact arithmetic (a bias on the keys shifts every score of a
query row by the same amount, which the softmax cancels), so both
frameworks compute rounding noise of about 1e-9 there, and Adam scales
noise up to an update of size lr.  Those elements differ by up to
2 * lr per step; the test holds them to that and checks that no other
parameter needs it.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.models import transformer as ttransformer

SMALL = dict(vocab_size=100, d_model=64, n_layer=2, n_head=4, d_inner=128, max_pos=64,
             seq_len=16, dropout_rate=0.0, fused_attention=True)
FEEDS = ["src_ids", "sent_ids", "input_mask", "mask_pos", "mask_label", "nsp_label"]
LR = {"adam": 1e-4, "sgd": 0.05}
PARAM_TOL = {"adam": 1e-5, "sgd": 1e-6}
FWD_TYPES = {"lookup_table", "range", "reshape2", "elementwise_add", "layer_norm", "mul",
             "transpose2", "fused_attention", "gelu", "gather", "matmul",
             "softmax_with_cross_entropy", "mean", "slice", "tanh", "top_k", "accuracy"}
GRAD_TYPES = {"elementwise_add", "mul", "reshape2", "transpose2", "layer_norm", "lookup_table",
              "fused_attention", "gelu", "gather", "matmul", "softmax_with_cross_entropy",
              "mean", "slice", "tanh"}


def build_pretrain(fluid, transformer, opt="adam", seed=0, cfg=SMALL):
    """(main, startup, [total, mlm_loss, nsp_acc], params_grads)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    s = cfg["seq_len"]
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src_ids", [s], dtype="int64")
        sent = fluid.layers.data("sent_ids", [s], dtype="int64")
        mask = fluid.layers.data("input_mask", [s])
        mpos = fluid.layers.data("mask_pos", [1], dtype="int64")
        mlab = fluid.layers.data("mask_label", [1], dtype="int64")
        nlab = fluid.layers.data("nsp_label", [1], dtype="int64")
        outs = transformer.bert_pretrain(src, sent, mask, mpos, mlab, nlab, **cfg)
        optimizer = (fluid.optimizer.AdamOptimizer(LR["adam"]) if opt == "adam"
                     else fluid.optimizer.SGDOptimizer(LR["sgd"]))
        _, params_grads = optimizer.minimize(outs[0])
    return main, startup, list(outs), params_grads


def pretrain_feed(rng, rows, cfg=SMALL, masks=3):
    """int64 ids and labels; random pad tails leave each row at least half
    real; masked positions and [CLS] lie on real tokens."""
    s, vocab = cfg["seq_len"], cfg["vocab_size"]
    lens = rng.randint(s // 2, s + 1, rows)
    lens[0] = s
    pos = np.stack([rng.choice(np.arange(1, lens[i]), masks, replace=False) + i * s
                    for i in range(rows)])
    return {
        "src_ids": rng.randint(0, vocab, (rows, s)).astype("int64"),
        "sent_ids": (np.arange(s)[None, :] >= (lens[:, None] // 2)).astype("int64"),
        "input_mask": (np.arange(s)[None, :] < lens[:, None]).astype("float32"),
        "mask_pos": pos.reshape(-1, 1).astype("int64"),
        "mask_label": rng.randint(0, vocab, (rows * masks, 1)).astype("int64"),
        "nsp_label": rng.randint(0, 2, (rows, 1)).astype("int64"),
    }


def _canon_dtype(d):
    return "int64" if d in ("int32", "int64") else d


def _persistables(program):
    return sorted({v.name for v in program.list_vars() if v.persistable and not v.is_data})


# ---------------------------------------------------------------------------
# desc parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt", ["adam", "sgd"])
@pytest.mark.parametrize("program", ["main", "startup"])
def test_train_desc_parity(program, opt):
    jm, js, _, _ = build_pretrain(jfluid, jtransformer, opt)
    tm, ts, _, _ = build_pretrain(tfluid, ttransformer, opt)
    jp, tp = (jm, tm) if program == "main" else (js, ts)
    jops, tops = jp.global_block().ops, tp.global_block().ops
    assert [o.type for o in tops] == [o.type for o in jops]
    for jo, to in zip(jops, tops):
        assert to.inputs == jo.inputs, jo.type
        assert to.outputs == jo.outputs, jo.type
        assert to.attrs == jo.attrs, jo.type
    jvars, tvars = jp.global_block().vars, tp.global_block().vars
    assert list(tvars) == list(jvars)
    for name, jv in jvars.items():
        tv = tvars[name]
        assert tv.shape == jv.shape, name
        assert _canon_dtype(tv.dtype) == _canon_dtype(jv.dtype), name
        assert (tv.persistable, tv.is_data, tv.stop_gradient) == \
            (jv.persistable, jv.is_data, jv.stop_gradient), name
        assert type(tv).__name__ == type(jv).__name__, name


def test_train_program_op_types():
    tm, ts, _, params_grads = build_pretrain(tfluid, ttransformer)
    types = [o.type for o in tm.global_block().ops]
    assert len(types) == 214
    assert set(types) == (FWD_TYPES | {t + "_grad" for t in GRAD_TYPES}
                          | {"fill_constant", "sum", "adam"})
    assert types.count("adam") == len(params_grads) == 46
    assert {o.type for o in ts.global_block().ops} == {"fill_constant", "uniform_random"}
    # the tied word embedding gets two contributions, summed
    grads = {p.name: g.name for p, g in params_grads}
    assert grads["bert_word_emb"] == "bert_word_emb@GRAD@SUM"


# ---------------------------------------------------------------------------
# run parity
# ---------------------------------------------------------------------------
def _jax_start(opt, seed):
    jm, js, jouts, jpg = build_pretrain(jfluid, jtransformer, opt, seed)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(js)
    return jm, jouts, jpg, exe, scope


def _run_both(opt, seed=0, steps=3):
    """Both packages from the JAX package's initial state, ``steps`` steps
    on the same feeds.  Returns per-step totals, step-1 grads and the
    final state of both."""
    jm, jouts, jpg, jexe, jscope = _jax_start(opt, seed)
    tm, _, touts, tpg = build_pretrain(tfluid, ttransformer, opt, seed)
    names = _persistables(jm)
    assert names == _persistables(tm)
    texe = tfluid.Executor(tfluid.CPUPlace())
    tscope = tfluid.Scope()
    tfluid.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.get(n)) for n in names}, texe.device, program=tm)
    grad_names = [g.name for _, g in jpg]
    assert grad_names == [g.name for _, g in tpg]
    rng = np.random.RandomState(seed + 100)
    losses, grads = [], None
    for step in range(steps):
        feed = pretrain_feed(rng, 4)
        extra = grad_names if step == 0 else []
        with jfluid.scope_guard(jscope):
            jr = jexe.run(jm, feed=feed, fetch_list=jouts + extra)
        tr = texe.run(tm, feed=feed, fetch_list=[o.name for o in touts] + extra, scope=tscope)
        losses.append((float(np.asarray(jr[0])), float(tr[0])))
        if step == 0:
            grads = {n: (np.asarray(a), b) for n, a, b in zip(grad_names, jr[3:], tr[3:])}
    state = {n: (np.asarray(jscope.get(n)), tfluid.scope.to_numpy(tscope.get(n))) for n in names}
    return losses, grads, state, [p.name for p, _ in jpg]


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_run_parity_three_steps(opt):
    losses, grads, state, params = _run_both(opt)
    for j, t in losses:
        assert np.isfinite(t)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    for name, (j, t) in grads.items():
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-4, err_msg=name)
    tol = PARAM_TOL[opt]
    noise_elements = 0
    for name in params:
        j, t = state[name]
        diff = np.abs(t - j.reshape(t.shape))
        over = diff > tol
        if opt == "adam" and name.endswith("_att_k_b"):
            # zero true gradient: Adam's normalised update of rounding noise
            assert diff.max() <= 2 * LR["adam"] * len(losses), name
            noise_elements += int(over.sum())
            continue
        assert not over.any(), (name, diff.max())
    # optimizer state (moments, beta pows) follows the same updates
    for name, (j, t) in state.items():
        if name not in params:
            np.testing.assert_allclose(t.reshape(j.shape), j, atol=1e-5, rtol=1e-5, err_msg=name)
    if opt == "adam":
        print("Adam: %d *_att_k_b elements beyond atol %g" % (noise_elements, tol))
        assert noise_elements <= 2 * SMALL["d_model"]


def test_key_bias_gradient_is_rounding_noise():
    """The premise of the Adam exception above: the key biases' step-1
    gradients are tiny in both packages, next to every other parameter's."""
    _, grads, _, _ = _run_both("sgd", steps=1)
    for name, (j, t) in grads.items():
        scale = np.abs(j).max()
        if "_att_k_b@" in name:
            assert scale < 1e-6 and np.abs(t).max() < 1e-6, name
        else:
            assert scale > 1e-5, name


def test_state_carried_by_name():
    """Every persistable of the JAX package's startup, parameters and
    optimizer state alike, lands in the port's scope unchanged."""
    jm, _, _, _, jscope = _jax_start("adam", 3)
    tm, _, _, _ = build_pretrain(tfluid, ttransformer, "adam", 3)
    names = _persistables(jm)
    kinds = {n.rsplit("_", 1)[0].split("_")[-1] for n in names if n.endswith("_0")}
    assert {"moment1", "moment2", "acc", "rate"} <= kinds  # moments, beta pows, learning rate
    scope = tfluid.Scope()
    arrays = {n: np.asarray(jscope.get(n)) for n in names}
    tfluid.io.set_params_from_numpy(scope, arrays, "cpu", program=tm)
    assert sorted(scope.vars) == names
    for n in names:
        np.testing.assert_array_equal(scope.get(n).numpy(), arrays[n])
    with pytest.raises(ValueError, match="shape mismatch"):
        tfluid.io.set_params_from_numpy(
            scope, {"learning_rate_0": np.zeros(2, "float32")}, "cpu", program=tm)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------
def test_port_trains_from_its_own_startup():
    tm, ts, touts, _ = build_pretrain(tfluid, ttransformer, "adam", seed=9)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(ts, scope=scope)
    assert torch.equal(scope.get("learning_rate_0"), torch.tensor([1e-4]))
    feed = pretrain_feed(np.random.RandomState(5), 3)
    assert all(feed[k].dtype == np.int64 for k in FEEDS if k != "input_mask")
    losses = []
    before = scope.get("bert_enc_0_att_q_w").clone()
    for _ in range(6):
        total, mlm, acc = exe.run(tm, feed=feed, fetch_list=touts, scope=scope)
        assert total.shape == () and np.isfinite(total) and acc.shape == (1,)
        losses.append(float(total))
    assert losses[-1] < losses[0]
    assert not torch.equal(scope.get("bert_enc_0_att_q_w"), before)
    b1p = scope.get("bert_enc_0_att_q_w_beta1_pow_acc_0")
    np.testing.assert_allclose(float(b1p), 0.9 ** 7, rtol=1e-6)


def test_clip_and_regularizer_pass_through_or_refuse():
    """With no clip and no decay both hand the grads through unchanged;
    with them, the port appends the JAX package's ops (L2 decay's
    ``scale`` and ``sum``, a norm clip's ``clip_by_norm``), var for var."""
    import paddle_tpu.clip as jclip
    import paddle_tpu.regularizer as jreg
    from paddle_tpu_torch import clip, regularizer

    def build(fluid, clip_mod, reg_mod, configured):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [4])
            w = fluid.layers.create_parameter([4, 2], "float32", name="w")
            loss = fluid.layers.mean(fluid.layers.matmul(x, w))
            pg = fluid.backward.append_backward(loss)
            if not configured:
                return main, pg, (clip_mod.append_gradient_clip_ops(pg),
                                  reg_mod.append_regularization_ops(pg))
            w.gradient_clip_attr = clip_mod.GradientClipByNorm(1.0)
            out = clip_mod.append_gradient_clip_ops(pg)
            out = reg_mod.append_regularization_ops(out, reg_mod.L2Decay(1e-4))
        return main, pg, out

    _, pg, (clipped, decayed) = build(tfluid, clip, regularizer, False)
    assert clipped == pg and decayed == pg
    jm, _, jout = build(jfluid, jclip, jreg, True)
    tm, _, tout = build(tfluid, clip, regularizer, True)
    assert tm.to_json() == jm.to_json()
    assert [(p.name, g.name) for p, g in tout] == [(p.name, g.name) for p, g in jout]
    assert [op.type for op in tm.global_block().ops][-3:] == ["clip_by_norm", "scale", "sum"]