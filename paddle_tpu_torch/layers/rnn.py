"""Recurrent layers: dynamic_lstm / dynamic_gru, as the JAX package's
``layers/rnn.py`` builds them.

Reference: python/paddle/fluid/layers/nn.py dynamic_lstm:519,
dynamic_gru, lstm (cudnn_lstm).  LoD ragged inputs become padded+length
pairs (layers/io.py data(lod_level=1)); the kernels mask padding so
numerics match the reference's ragged batching.
"""
from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["dynamic_lstm", "dynamic_gru"]


def _seq_len_of(helper, input, seq_len):
    if seq_len is not None:
        return seq_len
    blk = input.block
    cand = input.name + "_seq_len"
    if blk.has_var(cand):
        return blk.var(cand)
    return None


def dynamic_lstm(
    input,
    size,
    h_0=None,
    c_0=None,
    param_attr=None,
    bias_attr=None,
    use_peepholes=True,
    is_reverse=False,
    gate_activation="sigmoid",
    cell_activation="tanh",
    candidate_activation="tanh",
    dtype="float32",
    name=None,
    seq_len=None,
):
    """reference: layers/nn.py:519.  ``input`` [B, T, 4*size//4] must be
    pre-projected to 4 gates (same contract as the reference).  Returns
    (hidden [B,T,D], cell [B,T,D])."""
    helper = LayerHelper("dynamic_lstm", param_attr=param_attr, bias_attr=bias_attr, name=name)
    D = size // 4
    w = helper.create_parameter(param_attr, shape=[D, 4 * D], dtype=dtype)
    bias_size = 4 * D + (3 * D if use_peepholes else 0)
    b = helper.create_parameter(bias_attr, shape=[1, bias_size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    sl = _seq_len_of(helper, input, seq_len)
    if sl is not None:
        inputs["SeqLen"] = [sl]
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="dynamic_lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden, cell


def dynamic_gru(
    input,
    size,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    gate_activation="sigmoid",
    candidate_activation="tanh",
    h_0=None,
    dtype="float32",
    name=None,
    seq_len=None,
):
    """reference: layers/nn.py dynamic_gru.  ``input`` [B, T, 3*size]
    pre-projected; returns hidden [B, T, size]."""
    helper = LayerHelper("dynamic_gru", param_attr=param_attr, bias_attr=bias_attr, name=name)
    w = helper.create_parameter(param_attr, shape=[size, 3 * size], dtype=dtype)
    b = helper.create_parameter(bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [w], "Bias": [b]}
    sl = _seq_len_of(helper, input, seq_len)
    if sl is not None:
        inputs["SeqLen"] = [sl]
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="dynamic_gru",
        inputs=inputs,
        outputs={"Hidden": [hidden]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    return hidden
