"""The sequence ops and layers of paddle_tpu_torch against paddle_tpu:
every op of the JAX package's ``ops/sequence_ops.py`` on the padded +
length encoding, at ragged lengths (full, short, 1 and 0 where the op
allows it).

Small sizes (batch 4, T 6, width 3, 5 tags); inputs from a numpy seed.
Each op's outputs against the JAX kernel within rtol 1e-5 / atol 1e-6
(integer outputs exactly), and the vjp of each differentiable op into
its float inputs against ``jax.vjp`` within rtol 1e-5 / atol 1e-5.

``beam_search`` is held on constructed ties (every candidate score
equal, and equal pairs across beams): ``jax.lax.top_k`` puts the lower
index first, and so must the port (``torch.topk`` leaves the order of
ties open).  The layers build the same Program JSON as the JAX
package's and run to the same fetches.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from torch_parity_util import assert_same_program, jax_startup_state, op_parity, run_jax, run_port

B, T, W, K = 4, 6, 3, 5
LENS = np.array([6, 3, 1, 0], "int32")
FWD = dict(rtol=1e-5, atol=1e-6)
VJP = dict(rtol=1e-5, atol=1e-5)


def _x(seed=0, *shape):
    return np.random.RandomState(seed).randn(*(shape or (B, T, W))).astype("float32")


def _ids(seed, shape, hi=7):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


def test_sequence_mask():
    for dt in ("int64", "float32"):
        op_parity("sequence_mask", {"X": [LENS]}, {"maxlen": T, "out_dtype": dt})


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"])
def test_sequence_pool(ptype):
    op_parity("sequence_pool", {"X": [_x(1)], "SeqLen": [LENS]}, {"pooltype": ptype},
              out_slots=["Out", "MaxIndex"], **FWD)
    op_parity("sequence_pool", {"X": [_x(1)], "SeqLen": [LENS]}, {"pooltype": ptype},
              out_slots=["Out"], grad_slots=("X",), **VJP)
    op_parity("sequence_pool", {"X": [_x(2)]}, {"pooltype": ptype}, out_slots=["Out"],
              grad_slots=("X",), **VJP)


@pytest.mark.parametrize("with_len", [True, False])
def test_sequence_softmax_and_reverse(with_len):
    ins2 = {"X": [_x(3, B, T)]}
    ins3 = {"X": [_x(4)]}
    if with_len:
        ins2["SeqLen"] = ins3["SeqLen"] = [LENS]
    op_parity("sequence_softmax", ins2, {}, grad_slots=("X",), **VJP)
    op_parity("sequence_reverse", ins3, {}, grad_slots=("X",), **VJP)


def test_expand_concat_and_the_pass_through_ops():
    op_parity("sequence_expand", {"X": [_x(5, B, W)], "Y": [_x(6)]}, {}, grad_slots=("X",), **VJP)
    op_parity("sequence_expand_as", {"X": [_x(5, B, W)], "Y": [_x(6)]}, {}, grad_slots=("X",),
              **VJP)
    op_parity("sequence_concat", {"X": [_x(7), _x(8, B, 2, W)]}, {}, grad_slots=("X",), **VJP)
    op_parity("sequence_pad", {"X": [_x(9)], "PadValue": [np.zeros(1, "float32")],
                               "SeqLen": [LENS]}, {}, **FWD)
    op_parity("sequence_pad", {"X": [_x(9)], "PadValue": [np.zeros(1, "float32")]}, {}, **FWD)
    op_parity("sequence_unpad", {"X": [_x(10)], "Length": [LENS]}, {}, grad_slots=("X",), **VJP)
    op_parity("sequence_slice", {"X": [_x(11)], "Offset": [np.zeros((B, 1), "int64")],
                                 "Length": [np.ones((B, 1), "int64")]}, {}, grad_slots=("X",), **VJP)


def test_sequence_erase_and_enumerate():
    ids = _ids(12, (B, T))
    for lens in ([LENS], None):
        ins = {"X": [ids]}
        if lens:
            ins["SeqLen"] = lens
        op_parity("sequence_erase", ins, {"tokens": [2, 5]})
        op_parity("sequence_enumerate", ins, {"win_size": 3, "pad_value": 0})
        op_parity("sequence_enumerate", ins, {"win_size": 2, "pad_value": 9})


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance(normalized):
    hyp, ref = _ids(13, (B, 5), 4), _ids(14, (B, 7), 4)
    op_parity("edit_distance", {"Hyps": [hyp], "Refs": [ref],
                                "HypsLength": [np.array([5, 2, 0, 4], "int64")],
                                "RefsLength": [np.array([7, 3, 2, 0], "int64")]},
              {"normalized": normalized}, **FWD)
    op_parity("edit_distance", {"Hyps": [hyp], "Refs": [ref]}, {"normalized": normalized}, **FWD)


@pytest.mark.parametrize("merge", [True, False])
def test_ctc_align(merge):
    ids = np.array([[0, 1, 1, 0, 2, 2], [3, 3, 3, 0, 0, 1], [0, 0, 0, 0, 0, 0], [1, 0, 1, 1, 2, 0]],
                   "int64")
    for lens in ([LENS], None):
        ins = {"Input": [ids]}
        if lens:
            ins["SeqLen"] = lens
        op_parity("ctc_align", ins, {"blank": 0, "merge_repeated": merge, "padding_num": -1})


def test_linear_chain_crf():
    rng = np.random.RandomState(15)
    em = rng.randn(B, T, K).astype("float32")
    tr = (0.5 * rng.randn(K + 2, K)).astype("float32")
    lbl = rng.randint(0, K, (B, T, 1)).astype("int64")
    for lens in ([np.array([6, 3, 1, 2], "int32")], None):
        ins = {"Emission": [em], "Transition": [tr], "Label": [lbl]}
        if lens:
            ins["SeqLen"] = lens
        op_parity("linear_chain_crf", ins, {}, **FWD)
        op_parity("linear_chain_crf", ins, {}, out_slots=["LogLikelihood"],
                  grad_slots=("Emission", "Transition"), **VJP)


def test_crf_decoding():
    rng = np.random.RandomState(16)
    em = rng.randn(B, T, K).astype("float32")
    tr = rng.randn(K + 2, K).astype("float32")
    lens = np.array([6, 3, 1, 2], "int32")
    path = op_parity("crf_decoding", {"Emission": [em], "Transition": [tr], "SeqLen": [lens]},
                     {})["ViterbiPath"].numpy()
    lbl = path.copy()
    lbl[0, 2] = (lbl[0, 2] + 1) % K
    op_parity("crf_decoding", {"Emission": [em], "Transition": [tr], "Label": [lbl[:, :, None]],
                               "SeqLen": [lens]}, {})
    op_parity("crf_decoding", {"Emission": [em], "Transition": [tr]}, {})


def test_rank_table_and_reorder():
    lens = np.array([2, 4, 4, 1, 4], "int32")
    out = op_parity("lod_rank_table", {"X": [lens]}, {})
    np.testing.assert_array_equal(out["Index"].numpy(), [1, 2, 4, 0, 3])  # stable descending
    op_parity("reorder_lod_tensor_by_rank", {"X": [_x(17, 5, T, W)],
                                             "RankTable": [out["Index"].numpy()]}, {},
              grad_slots=("X",), **VJP)


BEAM, C = 3, 4


def _beam_inputs(seed, ties=False):
    rng = np.random.RandomState(seed)
    BK = 2 * BEAM
    pre_ids = rng.randint(3, 9, (BK, 1)).astype("int64")
    pre_ids[1, 0] = 2  # a finished beam (end_id 2)
    pre_sc = np.round(rng.randn(BK, 1), 1).astype("float32")
    ids = rng.randint(0, 20, (BK, C)).astype("int64")
    sc = rng.uniform(0.05, 1.0, (BK, C)).astype("float32")
    if ties:
        pre_sc[:] = -1.0
        sc[:] = 0.25  # every candidate equal
        sc[4] = [0.5, 0.5, 0.1, 0.5]  # equal pairs across beams
        sc[5] = [0.1, 0.5, 0.5, 0.1]
    return {"pre_ids": [pre_ids], "pre_scores": [pre_sc], "ids": [ids], "scores": [sc]}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("accumulated", [False, True])
def test_beam_search(ties, accumulated):
    ins = _beam_inputs(18, ties)
    if accumulated:
        ins["scores"] = [ins["pre_scores"][0] + np.log(ins["scores"][0])]
    out = op_parity("beam_search", ins, {"beam_size": BEAM, "end_id": 2,
                                         "is_accumulated": accumulated}, **FWD)
    if ties:
        # source 0's lanes: beam 1 is finished (one candidate at its own
        # score -1); beams 0 and 2 offer 4 candidates each at -1 + log 0.25;
        # the top 3 are beam 1's, then beam 0's first two
        np.testing.assert_array_equal(out["parent_idx"].numpy()[:3], [1, 0, 0])


def test_beam_search_ties_pick_the_lower_index():
    """All candidates equal: the selections are the first K flat indices."""
    ins = _beam_inputs(19)
    ins["pre_ids"][0][:] = 5
    ins["pre_scores"][0][:] = 0.0
    ins["scores"][0][:] = 0.0
    out = op_parity("beam_search", ins, {"beam_size": BEAM, "end_id": 2}, **FWD)
    ids = ins["ids"][0].reshape(2, BEAM * C)
    np.testing.assert_array_equal(out["selected_ids"].numpy().reshape(2, BEAM), ids[:, :BEAM])
    np.testing.assert_array_equal(out["parent_idx"].numpy(), [0, 0, 0, 3, 3, 3])


def test_beam_search_decode():
    rng = np.random.RandomState(20)
    steps, BK = 5, 2 * BEAM
    ids = rng.randint(0, 9, (steps, BK, 1)).astype("int64")
    sc = np.cumsum(-rng.uniform(0, 1, (steps, BK, 1)), axis=0).astype("float32")
    sc[-1, 0:2] = sc[-1, 2]  # tied final scores keep lane order
    parents = np.stack([np.sort(rng.randint(0, BEAM, BK)) % BEAM + (np.arange(BK) // BEAM) * BEAM
                        for _ in range(steps)]).astype("int32")
    op_parity("beam_search_decode", {"Ids": [ids], "Scores": [sc], "Parents": [parents]},
              {"beam_size": BEAM, "end_id": 2}, **FWD)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------
def _layers_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [T, W], lod_level=1)
        sl = main.global_block().var("x_seq_len")
        ids = fluid.layers.data("ids", [T], dtype="int64")
        ref = fluid.layers.data("ref", [T], dtype="int64")
        em = fluid.layers.data("em", [T, K])
        lbl = fluid.layers.data("lbl", [T], dtype="int64")
        s2 = fluid.layers.data("s2", [T])
        outs = [
            fluid.layers.sequence_pool(x, "sum"),
            fluid.layers.sequence_first_step(x, seq_len=sl),
            fluid.layers.sequence_last_step(x, seq_len=sl),
            fluid.layers.sequence_softmax(s2, seq_len=sl),
            fluid.layers.sequence_expand(fluid.layers.sequence_pool(x, "max"), x),
            fluid.layers.sequence_expand_as(fluid.layers.sequence_pool(x, "average"), x),
            fluid.layers.sequence_reverse(x, seq_len=sl),
            fluid.layers.sequence_mask(sl, maxlen=T, dtype="float32"),
            fluid.layers.sequence_erase(ids, [1, 3], seq_len=sl)[0],
            fluid.layers.sequence_enumerate(ids, 2, seq_len=sl),
            fluid.layers.edit_distance(ids, ref, ignored_tokens=[0])[0],
            fluid.layers.ctc_greedy_decoder(em, blank=0, input_length=sl)[0],
            fluid.layers.linear_chain_crf(em, lbl, param_attr=fluid.ParamAttr(name="crfw"),
                                          seq_len=sl),
            fluid.layers.crf_decoding(em, fluid.ParamAttr(name="crfw"), seq_len=sl),
            fluid.layers.sequence_concat([x, x]),
            fluid.layers.sequence_pad(x, fluid.layers.fill_constant([1], "float32", 0.0),
                                      seq_len=sl)[1],
            fluid.layers.sequence_unpad(x, sl),
            fluid.layers.sequence_slice(x, sl, sl),
        ]
    return main, startup, [o.name for o in outs]


def test_layers_desc_and_run():
    jm, js, fetch = _layers_program(jfluid)
    tm, ts, _ = _layers_program(tfluid)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    rng = np.random.RandomState(21)
    feed = {"x": _x(22), "x_seq_len": np.array([6, 3, 1, 2], "int32"),
            "ids": _ids(23, (B, T), 5), "ref": _ids(24, (B, T), 5),
            "em": rng.randn(B, T, K).astype("float32"), "lbl": _ids(25, (B, T), K),
            "s2": rng.randn(B, T).astype("float32")}
    state = jax_startup_state(js, jm)
    (jo,), _ = run_jax(jm, state, feed, fetch)
    (to,), _ = run_port(tm, state, feed, fetch)
    for name, a, b in zip(fetch, jo, to):
        np.testing.assert_allclose(np.asarray(b, np.float64).reshape(a.shape),
                                   np.asarray(a, np.float64), err_msg=name, **FWD)
