"""bf16 AMP in paddle_tpu_torch against paddle_tpu: the rewritten
program's desc, the ``amp_bf16`` pass, the ``cast`` and ``scale`` ops,
and three AMP training steps from the same state.

Small size: 2 layers, d_model 64, 4 heads, d_inner 128, seq 16, vocab
97, batch 4; inputs made from a seed with numpy.  Both packages build
``bert_pretrain(..., fused_attention=True, dropout_rate=0.0)`` and
minimize its total loss with
``contrib.mixed_precision.decorate(AdamOptimizer(1e-4))``, as the JAX
package's ``bench_bert.py`` does.

Tolerances, each with its reason:

* descs: identical JSON (ids are int32 in the JAX package, which runs
  with 64-bit types off; the port keeps int64, so the two names count as
  one);
* ``cast``: exact (a cast rounds to nearest even in both); its vjp
  exact too;
* ``scale``: fp32 at rtol 1e-6 (one multiply and one add); bf16 exact
  (both round scale and bias to bf16 first, then each of the two steps);
* the AMP losses: rtol 2e-3.  Every white op rounds its inputs and its
  output to bf16 (8 bits of mantissa, a relative step of 2**-8 = 3.9e-3)
  and the two frameworks sum the products and the softmax in different
  orders in fp32, so an activation may land one bf16 ulp apart; the loss
  averages those differences over 12 masked tokens and 4 sentences.
  The fp32 run of the same slice agrees to 1e-5
  (``tests/test_torch_train.py``); a gap above 2e-2 would be a fault.
* the step-1 gradients: max abs error at most 3e-2 of the gradient's
  largest magnitude.  A gradient passes through some twenty bf16
  roundings in two layers forward and back; at 2**-8 each, a random walk
  of them is about 1.7%.  The key-projection biases are left out: their
  true gradient is zero (a bias on the keys shifts every score of a
  query row alike, which the softmax cancels; ``tests/
  test_torch_train.py`` shows it), so both packages compute noise there.
* the master weights after 3 steps: mean abs difference 1e-5 a
  parameter (a tenth of lr), and max abs difference 2 * lr a step.
  Adam moves each element by about lr a step whatever the gradient's
  size, so an element whose gradient is near zero can move lr one way
  in one package and lr the other way in the other; the mean holds the
  bulk of the updates together.  The key-projection biases are held to
  the max alone.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.contrib import mixed_precision as jmp
from paddle_tpu.core import passes as jpasses
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.contrib import mixed_precision as tmp
from paddle_tpu_torch.core import passes as tpasses
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import transformer as ttransformer

SMALL = dict(vocab_size=97, d_model=64, n_layer=2, n_head=4, d_inner=128, max_pos=64,
             seq_len=16, dropout_rate=0.0, fused_attention=True)
BATCH = 4
LR = 1e-4
LOSS_RTOL = 2e-3
GRAD_REL = 3e-2
PARAM_MEAN_ATOL = 1e-5
CPU = torch.device("cpu")

PACKAGES = {"jax": (jfluid, jtransformer, jmp), "torch": (tfluid, ttransformer, tmp)}


def build_pretrain(pkg, amp=True, seed=0):
    """(main, startup, [total, mlm_loss, nsp_acc], params_grads) of the
    small BERT pretraining, AMP-decorated Adam unless ``amp`` is False."""
    fluid, transformer, mp = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    s = SMALL["seq_len"]
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ins = [fluid.layers.data(name, [w], dtype=dt) for name, w, dt in (
            ("src_ids", s, "int64"), ("sent_ids", s, "int64"), ("input_mask", s, "float32"),
            ("mask_pos", 1, "int64"), ("mask_label", 1, "int64"), ("nsp_label", 1, "int64"))]
        outs = transformer.bert_pretrain(*ins, **SMALL)
        opt = fluid.optimizer.AdamOptimizer(LR)
        if amp:
            opt = mp.decorate(opt)
        _, params_grads = opt.minimize(outs[0])
    return main, startup, list(outs), params_grads


def build_mlp(pkg, amp=True, seed=21):
    """An MLP of the port's own ops: fc with tanh, fc, softmax with cross
    entropy, mean (the JAX package's AMP test MLP, tests/
    test_amp_quant_inference.py, uses relu, softmax and cross_entropy,
    which the port does not have yet)."""
    fluid, _, mp = PACKAGES[pkg]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16])
        y = fluid.layers.data("y", [1], dtype="int64")
        h = fluid.layers.fc(x, 32, act="tanh")
        logits = fluid.layers.fc(h, 4)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(logits, y))
        opt = fluid.optimizer.AdamOptimizer(0.01)
        if amp:
            opt = mp.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def pretrain_feed(rng, rows=BATCH, masks=3):
    s, vocab = SMALL["seq_len"], SMALL["vocab_size"]
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


def _desc(program):
    """The Program JSON, with int32 read as int64."""
    d = json.loads(program.to_json())
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] == "int32":
                v["dtype"] = "int64"
    return d


# ---------------------------------------------------------------------------
# desc parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("program", ["main", "startup"])
@pytest.mark.parametrize("model", ["bert_pretrain", "mlp"])
def test_amp_desc_parity(model, program):
    build = build_pretrain if model == "bert_pretrain" else build_mlp
    jp, tp = build("jax")[:2], build("torch")[:2]
    idx = 0 if program == "main" else 1
    assert _desc(tp[idx]) == _desc(jp[idx])


def test_amp_rewrite_shape():
    """What the rewrite did to the port's BERT program: bf16 into every
    product and the attention (its Mask too), fp32 master weights and
    Adam state, fp32 layer-norm statistics, and fp32 into the losses."""
    main, _, outs, params_grads = build_pretrain("torch")
    block = main.global_block()
    dtype = {v.name: v.dtype for v in block.vars.values()}
    ops = block.ops
    types = [o.type for o in ops]
    assert types.count("fused_attention") == SMALL["n_layer"]
    for op in ops:
        if op.type in ("mul", "matmul", "fused_attention"):
            assert {dtype[n] for n in op.input_arg_names} == {"bfloat16"}, op
            assert {dtype[n] for n in op.output_arg_names} == {"bfloat16"}, op
        elif op.type == "layer_norm" and dtype[op.input("X")[0]] == "bfloat16":
            assert dtype[op.input("Scale")[0]] == dtype[op.input("Bias")[0]] == "float32"
            assert dtype[op.output("Mean")[0]] == dtype[op.output("Variance")[0]] == "float32"
        elif op.type in ("softmax_with_cross_entropy", "mean"):
            assert all(dtype[n] != "bfloat16" for n in op.input_arg_names), op
        elif op.type == "adam":
            assert {dtype[n] for n in op.input_arg_names} == {"float32"}, op
    for p, g in params_grads:
        assert dtype[p.name] == "float32" and dtype[g.name] == "float32", p.name
    casts = [o for o in ops if o.type == "cast"]
    assert {(o.attr("in_dtype"), o.attr("out_dtype")) for o in casts} == {
        ("float32", "bfloat16"), ("bfloat16", "float32")}
    assert dtype[outs[0].name] == "float32"


@pytest.mark.parametrize("model", ["bert_pretrain", "mlp"])
def test_amp_pass_matches_decorator_rewrite(model):
    """``apply_pass("amp_bf16")`` on the forward program gives the desc
    the decorator's rewrite gives, in the port and in the JAX package."""
    descs = {}
    for pkg, passes in (("torch", tpasses), ("jax", jpasses)):
        fluid, transformer, mp = PACKAGES[pkg]
        for how in ("pass", "rewrite"):
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup), fluid.unique_name.guard():
                if model == "mlp":
                    x = fluid.layers.data("x", [16])
                    y = fluid.layers.data("y", [1], dtype="int64")
                    h = fluid.layers.fc(x, 32, act="tanh")
                    fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
                        fluid.layers.fc(h, 4), y))
                else:
                    s = SMALL["seq_len"]
                    ins = [fluid.layers.data(n, [w], dtype=d) for n, w, d in (
                        ("src_ids", s, "int64"), ("sent_ids", s, "int64"),
                        ("input_mask", s, "float32"), ("mask_pos", 1, "int64"),
                        ("mask_label", 1, "int64"), ("nsp_label", 1, "int64"))]
                    transformer.bert_pretrain(*ins, **SMALL)
                v0 = main.version
                if how == "pass":
                    assert passes.apply_pass("amp_bf16", main) is main
                else:
                    mp.rewrite_program(main)
                assert main.version > v0
            descs[pkg, how] = _desc(main)
    assert descs["torch", "pass"] == descs["torch", "rewrite"]
    assert descs["torch", "pass"] == descs["jax", "pass"]
    assert descs["jax", "pass"] == descs["jax", "rewrite"]


def test_pass_registry():
    assert tpasses.list_passes() == ["amp_bf16", "prune_to_targets"]
    with pytest.raises(KeyError, match="not registered"):
        tpasses.get_pass("qat_quantize")
    main, _, outs, _ = build_pretrain("torch", amp=False)
    n_ops = len(main.global_block().ops)
    pruned = tpasses.apply_pass("prune_to_targets", main, feeds=["src_ids"],
                                targets=[outs[0].name])
    assert pruned is not main and len(main.global_block().ops) == n_ops
    assert not any(o.attr("op_role") in ("backward", "optimize")
                   for o in pruned.global_block().ops)
    # match_chain: every encoder layer's attention feeds a head merge
    chains = tpasses.match_chain(main.global_block(), ["fused_attention", "transpose2"])
    assert len(chains) == SMALL["n_layer"]
    pm = tpasses.PassManager().add("amp_bf16")
    v0 = main.version
    assert pm.apply(main) is main and main.version > v0


# ---------------------------------------------------------------------------
# cast and scale: op parity, forward and vjp
# ---------------------------------------------------------------------------
RNG = np.random.RandomState(5)
X = np.asarray(RNG.randn(6, 7) * 3, dtype="float32")
G = np.asarray(RNG.randn(6, 7), dtype="float32")


def _both(op_type, x, attrs, x_dtype, g):
    """Forward and vjp of ``op_type`` in both packages on ``x`` (cast to
    ``x_dtype``) with cotangent ``g``; each result as float64 numpy."""
    jx = jnp.asarray(x).astype(x_dtype)
    jout, jvjp = jax.vjp(lambda a: jreg.get_kernel(op_type)({"X": [a]}, dict(attrs))["Out"], jx)
    jg, = jvjp(jnp.asarray(g).astype(jout.dtype))
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype)).requires_grad_(True)
    tout = treg.get_kernel(op_type)({"X": [tx]}, dict(attrs), CPU)["Out"]
    tg, = torch.autograd.grad(tout, tx, torch.from_numpy(g).to(tout.dtype))
    assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
    assert tg.dtype == tx.dtype and str(jg.dtype) == x_dtype

    def f64(a):
        return np.asarray(a.astype(jnp.float32) if hasattr(a, "astype") and not
                          isinstance(a, torch.Tensor) else a.detach().float()).astype("float64")
    return (f64(jout), f64(tout)), (f64(jg), f64(tg))


@pytest.mark.parametrize("in_dtype,out_dtype", [("float32", "bfloat16"), ("bfloat16", "float32"),
                                                ("float32", "float32")])
def test_cast_op_parity(in_dtype, out_dtype):
    (jo, to), (jg, tg) = _both("cast", X, {"in_dtype": in_dtype, "out_dtype": out_dtype},
                               in_dtype, G)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tg, jg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_after_scale", [True, False])
def test_scale_op_parity(dtype, bias_after_scale):
    attrs = {"scale": 0.37, "bias": 1.25, "bias_after_scale": bias_after_scale}
    (jo, to), (jg, tg) = _both("scale", X, attrs, dtype, G)
    tol = dict(rtol=1e-6, atol=0) if dtype == "float32" else dict(rtol=0, atol=0)
    np.testing.assert_allclose(to, jo, **tol)
    np.testing.assert_allclose(tg, jg, **tol)


def test_fused_attention_takes_bf16_mask():
    """The rewrite casts every float input of a white op, ``fused_attention``'s
    padding Mask too: with bf16 Q, K, V the op gives the same bits with a
    bf16 Mask as with the fp32 one (0 and 1 are exact in bf16), and agrees
    with the JAX op on the same bf16 inputs within one bf16 ulp of the
    output (atol 2e-2 plus rtol 2**-7; both take scores and softmax in
    fp32, round the weights to bf16 and sum P V in another order)."""
    rng = np.random.RandomState(9)
    q, k, v = (np.asarray(rng.randn(3, 4, 16, 8), dtype="float32") for _ in range(3))
    mask = (np.arange(16)[None, :] < np.array([16, 9, 0])[:, None]).astype("float32")
    attrs = {"causal": False, "scale": 8 ** -0.5}
    bf = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in (("Q", q), ("K", k), ("V", v))}
    kern = treg.get_kernel("fused_attention")
    with_bf16 = kern({**{n: [t] for n, t in bf.items()},
                      "Mask": [torch.from_numpy(mask).to(torch.bfloat16)]}, attrs, CPU)["Out"]
    with_fp32 = kern({**{n: [t] for n, t in bf.items()}, "Mask": [torch.from_numpy(mask)]},
                     attrs, CPU)["Out"]
    assert with_bf16.dtype == torch.bfloat16 and torch.equal(with_bf16, with_fp32)
    jin = {n: [jnp.asarray(a).astype(jnp.bfloat16)] for n, a in (("Q", q), ("K", k), ("V", v))}
    jin["Mask"] = [jnp.asarray(mask).astype(jnp.bfloat16)]
    jout = np.asarray(jreg.get_kernel("fused_attention")(jin, dict(attrs))["Out"].astype(jnp.float32))
    np.testing.assert_allclose(with_bf16.float().numpy(), jout, atol=2e-2, rtol=2.0 ** -7)


def test_cast_and_scale_layers_desc_parity():
    descs = []
    for pkg in ("jax", "torch"):
        fluid = PACKAGES[pkg][0]
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data("x", [8])
            h = fluid.layers.cast(x, "bfloat16")
            h = fluid.layers.scale(h, scale=2.0, bias=0.5, bias_after_scale=False, act="tanh")
            fluid.layers.cast(h, "float32")
        descs.append(_desc(main))
    assert descs[0] == descs[1]
    types = [o["type"] for o in descs[1]["blocks"][0]["ops"]]
    assert types == ["cast", "scale", "tanh", "cast"]
    dts = {v["name"]: v["dtype"] for v in descs[1]["blocks"][0]["vars"]}
    assert [dts[n] for n in ("cast_0.tmp_0", "scale_0.tmp_0", "cast_1.tmp_0")] == \
        ["bfloat16", "bfloat16", "float32"]


def test_block_insert_prepend_remove_op():
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [8])
        y = tfluid.layers.scale(x, 3.0)
    block = main.global_block()
    c = block.create_var(name="xc", dtype="float32")
    op = block._insert_op(0, "cast", {"X": [x.name]}, {"Out": ["xc"]},
                          {"in_dtype": "float32", "out_dtype": "bfloat16"})
    assert block.ops[0] is op and c.dtype == "bfloat16" and c.shape == (-1, 8)
    first = block.prepend_op("scale", {"X": [x.name]}, {"Out": [y.name]}, {"scale": 1.0})
    assert [o.type for o in block.ops] == ["scale", "cast", "scale"] and block.ops[0] is first
    block._remove_op(0)
    assert [o.type for o in block.ops] == ["cast", "scale"]


# ---------------------------------------------------------------------------
# run parity: three AMP steps from the JAX package's initial state
# ---------------------------------------------------------------------------
def _persistables(program):
    return sorted({v.name for v in program.list_vars() if v.persistable and not v.is_data})


def test_amp_run_parity_three_steps():
    jm, js, jouts, jpg = build_pretrain("jax")
    tm, _, touts, tpg = build_pretrain("torch")
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jexe.run(js)
    names = _persistables(jm)
    assert names == _persistables(tm)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.io.set_params_from_numpy(
        tscope, {n: np.asarray(jscope.get(n)) for n in names}, texe.device, program=tm)
    grad_names = [g.name for _, g in tpg]
    assert grad_names == [g.name for _, g in jpg]
    rng = np.random.RandomState(7)
    losses = []
    for step in range(3):
        feed = pretrain_feed(rng)
        extra = grad_names if step == 0 else []
        with jfluid.scope_guard(jscope):
            jr = jexe.run(jm, feed=feed, fetch_list=[jouts[0]] + extra)
        tr = texe.run(tm, feed=feed, fetch_list=[touts[0].name] + extra, scope=tscope)
        losses.append((float(np.asarray(jr[0])), float(tr[0])))
        if step == 0:
            for name, j, t in zip(grad_names, jr[1:], tr[1:]):
                j = np.asarray(j).reshape(t.shape)
                assert t.dtype == np.float32, name  # fp32 gradients of fp32 master weights
                if "_att_k_b" not in name:
                    err = np.abs(t - j).max() / np.abs(j).max()
                    assert err <= GRAD_REL, (name, err)
    print("AMP losses (jax, torch):", losses)
    for jl, tl in losses:
        assert np.isfinite(tl)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    params = [p.name for p, _ in tpg]
    for n in names:
        t = tscope.get(n)
        assert t.dtype == torch.float32, n  # master weights and Adam state stay fp32
        if n not in params:
            continue
        diff = np.abs(t.numpy() - np.asarray(jscope.get(n)).reshape(tuple(t.shape)))
        assert diff.max() <= 2 * LR * len(losses), (n, diff.max())
        if "_att_k_b" not in n:
            assert diff.mean() <= PARAM_MEAN_ATOL, (n, diff.mean())
