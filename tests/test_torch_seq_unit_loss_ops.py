"""The sequence, RNN-unit and sampled-loss op types of paddle_tpu_torch
(``cos_sim``, ``sequence_conv``, ``row_conv``, ``im2sequence``,
``lstm_unit``, ``gru_unit``, ``hierarchical_sigmoid``, ``nce``,
``warpctc``, ``sequence_reshape``, ``sequence_scatter``, ``chunk_eval``)
against paddle_tpu's, forward and vjp (``torch_parity_util.op_parity``)
on numpy inputs made from a seed.

Tolerances: OP_TOL (rtol 1e-5, atol 1e-6) for fp32; ``warpctc`` at rtol
1e-4 (a recursion of T log-sum-exps, each rounded by either framework in
its own way), integers and counts exactly.  Lengths are ragged, with a
sequence of length 0 and one of the full T.

``nce`` draws its negatives from Philox (``ops/nn_ops.nce_negatives``),
whose bits cannot be jax.random's.  So its cost function
(``nce_cost``) is held to the JAX op given the negatives the JAX op
draws (the test makes the same ``jax.random`` calls), forward and vjp;
the port's sampler is held by determinism (the same labels give the
same negatives, other labels others) and by a chi-square test of its
draws against each sampler's distribution.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid  # noqa: F401  (registers the JAX ops)
import paddle_tpu_torch as tfluid  # noqa: F401
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import nn_ops as tnn
from torch_parity_util import op_parity

OP_TOL = dict(rtol=1e-5, atol=1e-6)
CTC_TOL = dict(rtol=1e-4, atol=1e-6)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype("float32")


def _cases():
    """name -> (op type, inputs, attrs, grad slots, tolerance)."""
    rng = np.random.RandomState(12)
    c = {}
    x, y = _f32(rng, 6, 8), _f32(rng, 6, 8)
    c["cos_sim"] = ("cos_sim", {"X": [x], "Y": [y]}, {}, ("X", "Y"), OP_TOL)
    c["cos_sim_broadcast_y"] = ("cos_sim", {"X": [x], "Y": [_f32(rng, 1, 8)]}, {}, ("X", "Y"),
                                OP_TOL)
    seq = _f32(rng, 4, 7, 5)
    lens = np.array([0, 7, 3, 5], "int32")
    for ctx, start in ((3, None), (4, -2), (2, 0), (5, 1)):
        attrs = {} if start is None else {"contextStart": start, "contextLength": ctx}
        w = _f32(rng, ctx * 5, 6, scale=0.3)
        c["sequence_conv_ctx%d" % ctx] = ("sequence_conv", {"X": [seq], "Filter": [w],
                                                            "SeqLen": [lens]},
                                          attrs, ("X", "Filter"), OP_TOL)
    c["sequence_conv_no_seqlen"] = ("sequence_conv", {"X": [seq], "Filter": [_f32(rng, 15, 6)]},
                                    {}, ("X", "Filter"), OP_TOL)
    filt = _f32(rng, 3, 5)
    c["row_conv"] = ("row_conv", {"X": [seq], "Filter": [filt], "SeqLen": [lens]}, {},
                     ("X", "Filter"), OP_TOL)
    c["row_conv_no_seqlen"] = ("row_conv", {"X": [seq], "Filter": [_f32(rng, 9, 5)]}, {},
                               ("X", "Filter"), OP_TOL)
    img = _f32(rng, 2, 3, 7, 9)
    c["im2sequence_2x3_stride_1x2"] = ("im2sequence", {"X": [img]},
                                       {"kernels": [2, 3], "strides": [1, 2]}, ("X",), OP_TOL)
    c["im2sequence_3x1_stride_2x3"] = ("im2sequence", {"X": [img]},
                                       {"kernels": [3, 1], "strides": [2, 3]}, ("X",), OP_TOL)
    c["lstm_unit"] = ("lstm_unit", {"X": [_f32(rng, 5, 24)], "C_prev": [_f32(rng, 5, 6)]},
                      {"forget_bias": 0.5}, ("X", "C_prev"), OP_TOL)
    gru = {"Input": [_f32(rng, 5, 18)], "HiddenPrev": [_f32(rng, 5, 6)],
           "Weight": [_f32(rng, 6, 18, scale=0.4)]}
    c["gru_unit"] = ("gru_unit", dict(gru, Bias=[_f32(rng, 1, 18)]), {},
                     ("Input", "HiddenPrev", "Weight", "Bias"), OP_TOL)
    c["gru_unit_no_bias"] = ("gru_unit", gru, {}, ("Input", "HiddenPrev", "Weight"), OP_TOL)
    hx = _f32(rng, 6, 8)
    for K in (10, 8, 2):
        lbl = rng.randint(0, K, (6, 1)).astype("int64")
        c["hsigmoid_default_k%d" % K] = (
            "hierarchical_sigmoid",
            {"X": [hx], "Label": [lbl], "W": [_f32(rng, K - 1, 8)], "Bias": [_f32(rng, K - 1)]},
            {"num_classes": K}, ("X", "W", "Bias"), OP_TOL)
    table = np.array([[0, 2, 5, -1], [0, 1, -1, -1], [0, 2, 6, 3], [0, 1, 4, -1],
                      [0, -1, -1, -1], [0, 2, 5, -1]], "int64")
    code = rng.randint(0, 2, table.shape).astype("int64")
    c["hsigmoid_custom_tree"] = (
        "hierarchical_sigmoid",
        {"X": [hx], "Label": [np.zeros((6, 1), "int64")], "W": [_f32(rng, 7, 8)],
         "Bias": [_f32(rng, 7)], "PathTable": [table], "PathCode": [code]},
        {"num_classes": 7, "is_custom": True}, ("X", "W", "Bias"), OP_TOL)
    c["hsigmoid_custom_tree_no_bias"] = (
        "hierarchical_sigmoid",
        {"X": [hx], "Label": [np.zeros((6, 1), "int64")], "W": [_f32(rng, 7, 8)],
         "PathTable": [table], "PathCode": [code]},
        {"num_classes": 7, "is_custom": True}, ("X", "W"), OP_TOL)
    logits = _f32(rng, 4, 12, 6)
    label = rng.randint(1, 6, (4, 4)).astype("int64")
    label[2] = [3, 3, 3, 3]  # needs 7 frames: infeasible in 5
    for norm in (False, True):
        c["warpctc_lengths_norm%d" % norm] = (
            "warpctc",
            {"Logits": [logits], "Label": [label],
             "LogitsLength": [np.array([12, 9, 5, 12], "int64")],
             "LabelLength": [np.array([4, 2, 4, 0], "int64")]},
            {"blank": 0, "norm_by_times": norm}, ("Logits",), CTC_TOL)
    c["warpctc_no_lengths"] = ("warpctc", {"Logits": [logits], "Label": [label]},
                               {"blank": 0}, ("Logits",), CTC_TOL)
    c["warpctc_blank_last"] = ("warpctc", {"Logits": [logits], "Label": [label - 1],
                                           "LabelLength": [np.array([1, 3, 2, 4], "int64")]},
                               {"blank": 5}, ("Logits",), CTC_TOL)
    c["sequence_reshape"] = ("sequence_reshape",
                             {"X": [_f32(rng, 3, 4, 6)], "SeqLen": [np.array([4, 2, 0], "int32")]},
                             {"new_dim": 8}, ("X",), OP_TOL)
    c["sequence_reshape_no_seqlen"] = ("sequence_reshape", {"X": [_f32(rng, 3, 4, 6)]},
                                       {"new_dim": 3}, ("X",), OP_TOL)
    ids = np.array([[1, 4, 4, 0, 9], [2, 2, 7, 3, 3], [5, 5, 5, 5, 5]], "int64")
    c["sequence_scatter"] = ("sequence_scatter",
                             {"X": [_f32(rng, 3, 10)], "Ids": [ids], "Updates": [_f32(rng, 3, 5)],
                              "SeqLen": [np.array([5, 2, 0], "int32")]},
                             {}, ("X", "Updates"), OP_TOL)
    c["sequence_scatter_no_seqlen"] = ("sequence_scatter",
                                       {"X": [_f32(rng, 3, 10)], "Ids": [ids],
                                        "Updates": [_f32(rng, 3, 5)]},
                                       {}, ("X", "Updates"), OP_TOL)
    n_types = 3
    for scheme, n_tag in (("IOB", 2), ("IOE", 2), ("IOBES", 4), ("plain", 1)):
        n_lbl = n_types * n_tag + 1  # the last id is O
        inf = rng.randint(0, n_lbl, (5, 9)).astype("int64")
        lab = inf.copy()
        flip = rng.rand(5, 9) < 0.3
        lab[flip] = rng.randint(0, n_lbl, flip.sum())
        sl = np.array([9, 0, 4, 7, 1], "int64")
        c["chunk_eval_" + scheme] = ("chunk_eval", {"Inference": [inf], "Label": [lab],
                                                    "SeqLength": [sl]},
                                     {"chunk_scheme": scheme, "num_chunk_types": n_types}, (), {})
        c["chunk_eval_%s_excluded_no_len" % scheme] = (
            "chunk_eval", {"Inference": [inf], "Label": [lab]},
            {"chunk_scheme": scheme, "num_chunk_types": n_types, "excluded_chunk_types": [1]},
            (), {})
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_jax_op(name):
    op_type, inputs, attrs, grads, tol = CASES[name]
    op_parity(op_type, inputs, attrs, grad_slots=grads, **tol)


def test_chunk_eval_counts_a_hand_case():
    """IOB with 2 types (B-0 I-0 B-1 I-1 O = 0 1 2 3 4): the inference has
    chunks [0,1] type 0, [3] type 1, [5,6] type 0; the label [0,1] type 0,
    [3,4] type 1, [5,6] type 0: 2 of 3 correct."""
    k = treg.get_kernel("chunk_eval")
    inf = torch.tensor([[0, 1, 4, 2, 4, 0, 1]])
    lab = torch.tensor([[0, 1, 4, 2, 3, 0, 1]])
    out = k({"Inference": [inf], "Label": [lab]}, {"chunk_scheme": "IOB", "num_chunk_types": 2},
            torch.device("cpu"))
    assert [int(out[s]) for s in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks")] == [
        3, 3, 2]
    np.testing.assert_allclose(float(out["F1-Score"]), 2 / 3, rtol=1e-6)


def test_new_op_types_are_registered():
    names = ("cos_sim", "sequence_conv", "row_conv", "im2sequence", "lstm_unit", "gru_unit",
             "hierarchical_sigmoid", "nce", "warpctc", "sequence_reshape", "sequence_scatter",
             "chunk_eval")
    for n in names:
        assert treg.has_op(n) and jreg.has_op(n), n
        assert not treg.get_op(n).random and not treg.get_op(n).host_read, n
    assert not treg.get_op("chunk_eval").differentiable
    assert treg.get_op("nce").no_grad_set == jreg.get_op("nce").no_grad_set


# ---------------------------------------------------------------------------
# nce: the cost against the JAX op given its negatives; the sampler alone
# ---------------------------------------------------------------------------
V, D, B, K_NEG = 50, 8, 6, 7


def _nce_inputs(rng, bias=True, weight=True):
    ins = {"Input": [_f32(rng, B, D)], "Label": [rng.randint(0, V, (B, 1)).astype("int64")],
           "Weight": [_f32(rng, V, D, scale=0.5)]}
    if bias:
        ins["Bias"] = [_f32(rng, V)]
    if weight:
        ins["SampleWeight"] = [rng.uniform(0.5, 2.0, (B, 1)).astype("float32")]
    return ins


def _custom_dist(rng):
    p = rng.uniform(0.1, 1.0, V).astype("float32") ** 3
    return (p / p.sum()).astype("float32")


def _jax_negatives(label, attrs):
    """The negatives the JAX op draws: its own jax.random calls."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.common import prng

    lbl = jnp.asarray(label.reshape(-1), jnp.int32)
    key = jax.random.fold_in(prng(int(attrs.get("seed", 0))), jnp.sum(lbl).astype(jnp.uint32))
    k, sampler = attrs["num_neg_samples"], attrs["sampler"]
    if sampler == "custom_dist":
        probs = jnp.asarray(attrs["custom_dist"], jnp.float32)
        cdf = jnp.cumsum(probs / jnp.sum(probs))
        neg = jnp.clip(jnp.searchsorted(cdf, jax.random.uniform(key, (k,))), 0, V - 1)
    elif sampler == "log_uniform":
        u = jax.random.uniform(key, (k,))
        neg = jnp.clip(jnp.exp(u * jnp.log(float(V + 1))).astype(jnp.int32) - 1, 0, V - 1)
    else:
        neg = jax.random.randint(key, (k,), 0, V)
    return np.asarray(neg).astype("int64")


NCE_CASES = {"uniform": ("uniform", True, True), "log_uniform": ("log_uniform", True, True),
             "custom_dist": ("custom_dist", True, True),
             "uniform_no_bias_no_weight": ("uniform", False, False),
             "log_uniform_seed": ("log_uniform", True, False)}


@pytest.mark.parametrize("name", sorted(NCE_CASES))
def test_nce_cost_matches_the_jax_op_given_its_negatives(name):
    import jax
    import jax.numpy as jnp

    sampler, bias, weight = NCE_CASES[name]
    rng = np.random.RandomState(31)
    ins = _nce_inputs(rng, bias, weight)
    attrs = {"num_neg_samples": K_NEG, "sampler": sampler, "seed": 77 if "seed" in name else 0}
    probs = None
    if sampler == "custom_dist":
        attrs["custom_dist"] = _custom_dist(rng)
        probs = torch.from_numpy(attrs["custom_dist"]) / torch.from_numpy(
            attrs["custom_dist"]).sum()
    neg = torch.from_numpy(_jax_negatives(ins["Label"][0], attrs))
    jk = jreg.get_kernel("nce")
    diff = [s for s in ("Input", "Weight", "Bias") if s in ins]

    def jf(*vals):
        j = {s: [jnp.asarray(v[0])] for s, v in ins.items()}
        for s, v in zip(diff, vals):
            j[s] = [v]
        return jk(j, attrs)["Cost"]

    jcost, vjp = jax.vjp(jf, *[jnp.asarray(ins[s][0]) for s in diff])
    cot = rng.randn(B, 1).astype("float32")
    jgrads = vjp(jnp.asarray(cot))
    leaves = {s: torch.from_numpy(ins[s][0]).requires_grad_(True) for s in diff}
    t = lambda s: (leaves[s] if s in leaves else  # noqa: E731
                   torch.from_numpy(ins[s][0]) if s in ins else None)
    cost = tnn.nce_cost(t("Input"), torch.from_numpy(ins["Label"][0]).reshape(-1), t("Weight"),
                        t("Bias"), t("SampleWeight"), neg, K_NEG, sampler, probs)
    np.testing.assert_allclose(cost.detach().numpy(), np.asarray(jcost), **OP_TOL)
    tgrads = torch.autograd.grad(cost, [leaves[s] for s in diff], torch.from_numpy(cot))
    for s, jg, tg in zip(diff, jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), err_msg=s, **OP_TOL)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform", "custom_dist"])
def test_nce_op_draws_the_same_negatives_for_the_same_labels(sampler):
    rng = np.random.RandomState(32)
    ins = _nce_inputs(rng)
    attrs = {"num_neg_samples": K_NEG, "sampler": sampler, "seed": 5}
    if sampler == "custom_dist":
        attrs["custom_dist"] = _custom_dist(rng)
    k = treg.get_kernel("nce")
    cpu = torch.device("cpu")
    tins = {s: [torch.from_numpy(v[0])] for s, v in ins.items()}
    a, b = (k(tins, attrs, cpu)["Cost"] for _ in range(2))
    assert torch.equal(a, b)
    label = tins["Label"][0].reshape(-1)
    probs = None
    if sampler == "custom_dist":  # normalised as the op does, in fp32
        probs = torch.from_numpy(attrs["custom_dist"])
        probs = probs / torch.sum(probs)
    neg = tnn.nce_negatives(label.sum(), 5, K_NEG, V, sampler, probs)
    assert neg.shape == (K_NEG,) and neg.dtype == torch.int64
    assert int(neg.min()) >= 0 and int(neg.max()) < V
    want = tnn.nce_cost(tins["Input"][0], label, tins["Weight"][0], tins["Bias"][0],
                        tins["SampleWeight"][0], neg, K_NEG, sampler, probs)
    torch.testing.assert_close(a, want, rtol=0, atol=0)
    # another batch of labels draws other negatives; so does another seed
    many = tnn.nce_negatives(torch.arange(400), 5, K_NEG, V, sampler, probs)
    assert len({tuple(r.tolist()) for r in many}) == 400
    assert not torch.equal(neg, tnn.nce_negatives(label.sum(), 6, K_NEG, V, sampler, probs))
    assert torch.equal(many[int(label.sum())], neg)


def _chi2_p(counts, p, min_expected=20.0):
    """Pearson's chi-square p-value, bins merged (in order) until each
    expects at least ``min_expected`` draws."""
    from scipy import stats

    n = counts.sum()
    obs, exp, o, e = [], [], 0.0, 0.0
    for c, q in zip(counts, p):
        o, e = o + c, e + n * q
        if e >= min_expected:
            obs.append(o), exp.append(e)
            o = e = 0.0
    if e:
        obs[-1] += o
        exp[-1] += e
    return float(stats.chisquare(obs, exp).pvalue)


def sampler_distribution(sampler, V, probs=None):
    c = np.arange(V, dtype=np.float64)
    if sampler == "uniform":
        return np.full(V, 1.0 / V)
    if sampler == "log_uniform":
        return np.log((c + 2) / (c + 1)) / np.log(V + 1)
    return np.asarray(probs, np.float64) / np.sum(probs)


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform", "custom_dist"])
def test_nce_sampler_draws_its_distribution(sampler):
    """20,000 batches' negatives (the keys 0 .. 19,999 of one seed), 10
    each, over 50 classes: a chi-square test against the sampler's
    distribution at p > 1e-3."""
    probs = _custom_dist(np.random.RandomState(33)) if sampler == "custom_dist" else None
    neg = tnn.nce_negatives(torch.arange(20000), 3, 10, V, sampler,
                            None if probs is None else torch.from_numpy(probs))
    counts = np.bincount(neg.reshape(-1).numpy(), minlength=V)
    assert counts.shape == (V,)
    assert _chi2_p(counts, sampler_distribution(sampler, V, probs)) > 1e-3
    # and is not some other distribution: uniform draws fail the Zipfian test
    if sampler == "log_uniform":
        flat = np.bincount(tnn.nce_negatives(torch.arange(20000), 3, 10, V).reshape(-1).numpy(),
                           minlength=V)
        assert _chi2_p(flat, sampler_distribution("log_uniform", V)) < 1e-6


def test_nce_negatives_keyed_by_the_label_sum_mod_2_32():
    a = tnn.nce_negatives(torch.tensor(7), 0, 9, 1000)
    b = tnn.nce_negatives(torch.tensor(7 + (1 << 32)), 0, 9, 1000)
    c = tnn.nce_negatives(torch.tensor(7), 12345, 9, 1000)  # seed 0 means 12345
    assert torch.equal(a, b) and torch.equal(a, c)
    assert math.isclose(float(tnn.nce_negatives(torch.arange(4000), 1, 4, 1 << 20).float().mean()),
                        (1 << 20) / 2, rel_tol=0.02)
