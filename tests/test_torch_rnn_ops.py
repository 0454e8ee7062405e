"""The recurrent ops and layers of paddle_tpu_torch against paddle_tpu:
``dynamic_lstm`` (peepholes on and off, forward and reversed, with and
without H0/C0), ``dynamic_gru`` (forward and reversed, with H0) and
``dynamic_lstmp``, at ragged lengths (a full row, a short row, a row of
length 1 and one of length 0).

Small sizes (batch 4, T 6, hidden 5, projection 3); inputs from a numpy
seed.  Each op's outputs against the JAX kernel within rtol 1e-5 /
atol 1e-6, and its vjp into every float input against ``jax.vjp`` of the
JAX kernel within rtol 1e-4 / atol 1e-5 (the gradient sums over T steps).
The layers (``layers/rnn.py``, ``dynamic_lstmp``) build the same Program
JSON as the JAX package's, and a small sentence model over each trains 3
Adam steps from the JAX package's startup state to the same losses and
parameters (rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from torch_parity_util import assert_same_program, jax_startup_state, op_parity, run_jax, run_port

B, T, D, P = 4, 6, 5, 3
LENS = np.array([6, 3, 1, 0], "int32")
FWD = dict(rtol=1e-5, atol=1e-6)
VJP = dict(rtol=1e-4, atol=1e-5)


def _u(rng, *shape):
    return rng.uniform(-0.5, 0.5, shape).astype("float32")


@pytest.mark.parametrize("peep", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_dynamic_lstm(peep, reverse, init):
    rng = np.random.RandomState(int(peep) + 2 * int(reverse) + 4 * int(init))
    ins = {"Input": [_u(rng, B, T, 4 * D)], "Weight": [_u(rng, D, 4 * D)],
           "Bias": [_u(rng, 1, 7 * D if peep else 4 * D)], "SeqLen": [LENS]}
    if init:
        ins.update(H0=[_u(rng, B, D)], C0=[_u(rng, B, D)])
    attrs = {"use_peepholes": peep, "is_reverse": reverse, "gate_activation": "sigmoid",
             "cell_activation": "tanh", "candidate_activation": "tanh"}
    op_parity("dynamic_lstm", ins, attrs, **FWD)
    op_parity("dynamic_lstm", ins, attrs,
              grad_slots=[s for s in ("Input", "Weight", "Bias", "H0", "C0") if s in ins], **VJP)


def test_dynamic_lstm_without_lengths_or_bias():
    rng = np.random.RandomState(9)
    ins = {"Input": [_u(rng, B, T, 4 * D)], "Weight": [_u(rng, D, 4 * D)]}
    op_parity("dynamic_lstm", ins, {"use_peepholes": True},
              grad_slots=("Input", "Weight"), **VJP)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("init", [False, True])
def test_dynamic_gru(reverse, init):
    rng = np.random.RandomState(10 + int(reverse) + 2 * int(init))
    ins = {"Input": [_u(rng, B, T, 3 * D)], "Weight": [_u(rng, D, 3 * D)],
           "Bias": [_u(rng, 1, 3 * D)], "SeqLen": [LENS]}
    if init:
        ins["H0"] = [_u(rng, B, D)]
    attrs = {"is_reverse": reverse, "gate_activation": "sigmoid", "activation": "tanh"}
    op_parity("dynamic_gru", ins, attrs, **FWD)
    op_parity("dynamic_gru", ins, attrs,
              grad_slots=[s for s in ("Input", "Weight", "Bias", "H0") if s in ins], **VJP)


@pytest.mark.parametrize("peep", [True, False])
def test_dynamic_lstmp(peep):
    rng = np.random.RandomState(20 + int(peep))
    ins = {"Input": [_u(rng, B, T, 4 * D)], "Weight": [_u(rng, P, 4 * D)],
           "ProjWeight": [_u(rng, D, P)], "Bias": [_u(rng, 1, 7 * D if peep else 4 * D)],
           "SeqLen": [LENS]}
    attrs = {"use_peepholes": peep, "gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh", "proj_activation": "tanh"}
    op_parity("dynamic_lstmp", ins, attrs, **FWD)
    op_parity("dynamic_lstmp", ins, attrs, grad_slots=("Input", "Weight", "ProjWeight", "Bias"),
              **VJP)


# ---------------------------------------------------------------------------
# the layers: a sentence model over each recurrent layer
# ---------------------------------------------------------------------------
V, E = 40, 8


def _model(fluid, kind):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 31
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", [T], dtype="int64", lod_level=1)
        sl = main.global_block().var("ids_seq_len")
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        emb = fluid.layers.embedding(ids, size=[V, E])
        if kind == "lstm":
            proj = fluid.layers.fc(emb, 4 * D, num_flatten_dims=2)
            h, _ = fluid.layers.dynamic_lstm(proj, size=4 * D, seq_len=sl)
            hb, _ = fluid.layers.dynamic_lstm(proj, size=4 * D, seq_len=sl, is_reverse=True,
                                              use_peepholes=False)
            h = fluid.layers.concat([fluid.layers.sequence_last_step(h, seq_len=sl),
                                     fluid.layers.sequence_first_step(hb, seq_len=sl)], axis=1)
        elif kind == "gru":
            proj = fluid.layers.fc(emb, 3 * D, num_flatten_dims=2, bias_attr=False)
            h = fluid.layers.sequence_pool(fluid.layers.dynamic_gru(proj, size=D, seq_len=sl),
                                           "max", seq_len=sl)
        else:
            proj = fluid.layers.fc(emb, 4 * D, num_flatten_dims=2, bias_attr=False)
            h, _ = fluid.layers.dynamic_lstmp(proj, size=4 * D, proj_size=P, seq_len=sl)
            h = fluid.layers.sequence_pool(h, "average", seq_len=sl)
        pred = fluid.layers.fc(h, 2, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, lbl))
        fluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("kind", ["lstm", "gru", "lstmp"])
def test_layers_desc_and_training(kind):
    jm, js, jl = _model(jfluid, kind)
    tm, ts, tl = _model(tfluid, kind)
    assert_same_program(jm, tm)
    assert_same_program(js, ts)
    rng = np.random.RandomState(5)
    feed = {"ids": rng.randint(0, V, (B, T)).astype("int64"), "ids_seq_len": np.array([6, 3, 1, 4], "int32"),
            "lbl": rng.randint(0, 2, (B, 1)).astype("int64")}
    state = jax_startup_state(js, jm)
    jout, jscope = run_jax(jm, state, feed, [jl.name], steps=3)
    tout, tscope = run_port(tm, state, feed, [tl.name], steps=3)
    np.testing.assert_allclose([float(o[0]) for o in tout], [float(o[0]) for o in jout], **VJP)
    for p in jm.all_parameters():
        np.testing.assert_allclose(tscope.get(p.name).numpy(), np.asarray(jscope.get(p.name)),
                                   err_msg=p.name, **VJP)
