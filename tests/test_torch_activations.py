"""Activation sharding in paddle_tpu_torch against the JAX package.

The port's ``sharding.activations.ActivationConstrainer`` and the JAX
package's, built from the same ``transformer_lm_rules("sp")`` over an sp
axis of 4 (the JAX one on its 8-device virtual CPU mesh), are handed the
same intermediates, names and shapes of the fused LM's:

* they resolve the same names to a constraint, on the same dim (the port
  keeps this rank's window of it, the JAX package places the value), skip
  the same names: no rule, a spec of higher rank than the value, and a
  sequence the axis does not divide (``_shard_factor``);
* their reports and ``stats()`` agree key for key and byte for byte, and
  each resolves a (name, shape) once (the memo), however often it sees it;
* the port's windows: a value already cut is recognised from the program's
  var shapes and kept, its bytes reported at the global shape; an op that
  does not work position by position gets its windows gathered; a whole
  operand of an elementwise op meeting a window is cut to it;
* ``tools.check_partition_rules``'s sp pass: a traced sp build dispatches
  every fused attention op to the ring.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu.parallel import mesh as jmesh
from paddle_tpu.sharding import layouts as jlayouts
from paddle_tpu.sharding.activations import ActivationConstrainer as JConstrainer
from paddle_tpu_torch import framework, models
from paddle_tpu_torch.sharding import activations
from paddle_tpu_torch.sharding import layouts as tlayouts

SP = 4
# (name, global shape) as the fused LM (seq 32, d_model 16, 4 heads) makes them
VALUES = [
    ("lm_dec_0_att_fused_0.tmp_0", (2, 4, 32, 4)),   # the attention output: dim 2
    ("fc_3.tmp_1", (2, 32, 16)),                      # the fc chain: dim 1
    ("layer_norm_1.tmp_0", (2, 32, 16)),
    ("layer_norm_1.tmp_1", (2, 32)),
    ("elementwise_add_0.tmp_0", (2, 32, 16)),
    ("embedding_1.tmp_0", (1, 32, 16)),               # the position table
    ("fc_4.tmp_1", (2, 30, 16)),                      # 30 positions: not divisible, skipped
    ("lm_dec_1_att_fused_0.tmp_0", (2, 4, 30, 4)),
    ("embedding_0.tmp_0", (32,)),                     # spec of higher rank: skipped
    ("range_0.tmp_0", (32,)),                         # no rule
    ("transpose2_3.tmp_0", (2, 32, 4, 4)),            # no rule: follows its producer
]


def _counting(rules, calls):
    real = rules.activation_spec_for

    def spec_for(name, shape=None):
        calls.append((name, tuple(shape)))
        return real(name, shape=shape)
    rules.activation_spec_for = spec_for
    return rules


def _jax_side(calls):
    import jax.numpy as jnp

    mesh = jmesh.make_mesh({"sp": SP})
    c = JConstrainer(_counting(jlayouts.transformer_lm_rules("sp"), calls), mesh, {"sp": SP})
    c.begin_trace()
    dims = {}
    for _ in range(2):
        for name, shape in VALUES:
            c.constrain(name, jnp.zeros(shape, jnp.float32))
    for name, shape in VALUES:
        hit = c._memo[(name, shape)]
        dims[(name, shape)] = None if hit is None else [
            d for d, e in enumerate(tuple(hit[0].spec)) if e is not None]
    c.end_trace()
    return c, dims


@pytest.mark.parametrize("rank", [0, 3])
def test_resolution_report_and_memo_match_the_jax_constrainer(rank):
    jcalls, tcalls = [], []
    jc, jdims = _jax_side(jcalls)
    tc = activations.ActivationConstrainer(
        _counting(tlayouts.transformer_lm_rules("sp"), tcalls), None, {"sp": SP},
        coords={"sp": rank})
    tc.begin_trace()
    for _ in range(2):
        for name, shape in VALUES:
            full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
            got = tc.constrain(name, full)
            dims = jdims[(name, shape)]
            if dims is None:
                assert got is full, name
                continue
            assert dims == [tc._memo[(name, shape)][0]], name
            d = dims[0]
            assert got.shape[d] * SP == shape[d], name
            chunk = shape[d] // SP
            assert torch.equal(got, full.narrow(d, rank * chunk, chunk)), name
    tc.end_trace()
    assert tc.report == jc.report
    assert tc.stats() == jc.stats()
    st = tc.stats()
    assert st["n_constrained"] == 6
    assert st["activation_bytes_per_device"] * SP == st["activation_bytes_unsharded"]
    # each (name, shape) resolved once, by both, in the same order
    assert tcalls == jcalls == [(n, s) for n, s in VALUES]


def _lm_block():
    prog, startup = framework.Program(), framework.Program()
    with framework.program_guard(prog, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("src_ids", [32], dtype="int64")
        models.transformer_lm(ids, None, vocab_size=64, d_model=16, n_layer=1, n_head=4,
                              d_inner=32, seq_len=32, max_pos=64, fused_attention=True)
    return prog.global_block()


class _Op:
    def __init__(self, type_, inputs, attrs=None):
        self.type, self.inputs, self.attrs = type_, inputs, attrs or {}


def test_windows_are_read_from_the_program_and_kept():
    block = _lm_block()
    tc = activations.ActivationConstrainer(tlayouts.transformer_lm_rules("sp"), None,
                                           {"sp": SP}, coords={"sp": 1}, block=block)
    full = torch.randn(2, 32, 16)
    win = full[:, 8:16]
    assert tc.window_dim("fc_0.tmp_1", full.shape) is None
    assert tc.window_dim("fc_0.tmp_1", win.shape) == 1
    assert tc.window_dim("reshape2_1.tmp_0", (2, 8, 4, 4)) == 1
    assert tc.window_dim("transpose2_0.tmp_0", (2, 4, 8, 4)) == 2
    tc.begin_trace()
    assert tc.constrain("fc_0.tmp_1", win) is win  # a window already: kept
    assert torch.equal(tc.constrain("fc_1.tmp_1", full), win)  # cut to rank 1's window
    tc.end_trace()
    assert tc.report["fc_0.tmp_1"] == (2 * 32 * 16 * 4, 2 * 8 * 16 * 4)


def test_ops_get_windows_gathered_or_cut_as_they_need():
    block = _lm_block()
    tc = activations.ActivationConstrainer(tlayouts.transformer_lm_rules("sp"), None,
                                           {"sp": SP}, coords={"sp": 2}, block=block)
    win = torch.randn(2, 8, 16)
    # an op that mixes positions: its window comes back whole (rank-order
    # concatenation; shape-only without a mesh)
    ins = tc.prepare_inputs(_Op("reduce_sum", {"X": ["fc_0.tmp_1"]}), {"X": [win]})
    assert ins["X"][0].shape == (2, 32, 16) and tc.input_window("X") is None
    # a position-wise op runs on the window; a whole operand along the
    # window's dim (the position table) is cut to the window
    pos = torch.arange(32 * 16, dtype=torch.float32).reshape(1, 32, 16)
    op = _Op("elementwise_add", {"X": ["embedding_0.tmp_0"], "Y": ["embedding_1.tmp_0"]},
             {"axis": -1})
    ins = tc.prepare_inputs(op, {"X": [win], "Y": [pos]})
    assert ins["X"][0] is win and torch.equal(ins["Y"][0], pos[:, 16:24])
    assert tc.input_window("X") == 1 and tc.input_window("Y") is None
    # a reshape that copies the leading dims keeps the window; one that
    # names the sequence length does not
    keep = _Op("reshape2", {"X": ["fc_0.tmp_1"]}, {"shape": [0, 0, 4, 4]})
    assert tc.prepare_inputs(keep, {"X": [win]})["X"][0] is win
    fixed = _Op("reshape2", {"X": ["fc_0.tmp_1"]}, {"shape": [2, 32, 4, 4]})
    assert tc.prepare_inputs(fixed, {"X": [win]})["X"][0].shape == (2, 32, 16)


def test_check_partition_rules_sp_pass_dispatches_to_the_ring():
    from paddle_tpu_torch.tools import check_partition_rules as cpr

    assert cpr.check_sp() == []
    block = _lm_block()
    prog = block.program
    assert cpr._sp_ring_calls(prog, tlayouts.transformer_lm_rules("sp")) == 1
    # a sequence the axis does not divide takes the gathered path
    assert cpr._sp_ring_calls(prog, tlayouts.transformer_lm_rules("sp"), n_sp=3) == 0
