"""Recurrent ops: dynamic_lstm / dynamic_gru / dynamic_lstmp over
padded+length batches.

PyTorch port of the JAX package's ``ops/rnn_ops.py`` (reference:
paddle/fluid/operators/lstm_op.cc + math/lstm_compute, gate order i, c,
f, o as lstm_op.cc documents it: W_x arranged {W_ix, W_cx, W_fx, W_ox};
gru_op.cc + math/gru_compute: update u, reset r, candidate c;
lstmp_op.cc).  The JAX package scans the time axis with ``lax.scan``;
here each op is a Python loop of T steps over [B, ...] tensors: one
hidden-to-gates GEMM and a few elementwise kernels a step.  Padding
steps (``t >= SeqLen``) hold the state and emit zeros (the LSTM and GRU)
or the held state (the LSTMP), as the JAX kernels do, with the mask on
the device.  Differentiable through the generic vjp grad kernel.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.common import maybe, one

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
}


def _lens(inputs, x):
    seq_len = maybe(inputs, "SeqLen")
    if seq_len is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32, device=x.device)
    return seq_len.reshape(-1)


def _gate_bias(bias, D4, use_peepholes, x):
    """(gate bias [1, 4D], peephole weights (w_ic, w_fc, w_oc) or None)."""
    if bias is None:
        return torch.zeros((1, D4), dtype=x.dtype, device=x.device), None
    b_gate = bias[..., :D4].reshape(1, D4)
    if not (use_peepholes and bias.shape[-1] > D4):
        return b_gate, None
    peep = bias[..., D4:].reshape(-1)
    D = D4 // 4
    return b_gate, (peep[:D], peep[D: 2 * D], peep[2 * D:])


@register_op("dynamic_lstm", no_grad_set={"SeqLen"})
def dynamic_lstm(inputs, attrs, device):
    """Input [B, T, 4D] (pre-projected, as the reference requires),
    Weight [D, 4D] hidden-to-gates, Bias [1, 4D] (+[1, 3D] peephole tail
    when use_peepholes).  Outputs Hidden [B, T, D], Cell [B, T, D]."""
    x = one(inputs, "Input")
    w = one(inputs, "Weight")
    B, T, D4 = x.shape
    D = D4 // 4
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    b_gate, peep = _gate_bias(maybe(inputs, "Bias"), D4, attrs.get("use_peepholes", True), x)
    h0, c0 = maybe(inputs, "H0"), maybe(inputs, "C0")
    h = h0 if h0 is not None else x.new_zeros((B, D))
    c = c0 if c0 is not None else x.new_zeros((B, D))
    lens = _lens(inputs, x)
    hs, cs = [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        gates = x[:, t] + h @ w + b_gate
        gi, gc, gf, go = gates.split(D, dim=-1)  # reference order i, c, f, o
        if peep is not None:
            gi = gi + c * peep[0]
            gf = gf + c * peep[1]
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if peep is not None:
            go = go + c_new * peep[2]
        h_new = gate_act(go) * cell_act(c_new)
        valid = (lens > t)[:, None]  # padding: hold the state, zero the output
        hs[t] = h_new * valid.to(x.dtype)
        cs[t] = c_new * valid.to(x.dtype)
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
    return {"Hidden": torch.stack(hs, dim=1), "Cell": torch.stack(cs, dim=1)}


@register_op("dynamic_gru", no_grad_set={"SeqLen"})
def dynamic_gru(inputs, attrs, device):
    """Input [B, T, 3D] pre-projected, Weight [D, 3D] ({W_u, W_r} first
    2D, W_c last D), Bias [1, 3D].  Output Hidden [B, T, D]."""
    x = one(inputs, "Input")
    w = one(inputs, "Weight")
    bias = maybe(inputs, "Bias")
    B, T, D3 = x.shape
    D = D3 // 3
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    b = bias.reshape(1, D3) if bias is not None else x.new_zeros((1, D3))
    w_gate, w_cand = w[:, : 2 * D], w[:, 2 * D:]
    h0 = maybe(inputs, "H0")
    h = h0 if h0 is not None else x.new_zeros((B, D))
    lens = _lens(inputs, x)
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        xg = x[:, t] + b
        u, r = gate_act(xg[..., : 2 * D] + h @ w_gate).split(D, dim=-1)
        cand = cand_act(xg[..., 2 * D:] + (r * h) @ w_cand)
        h_new = u * h + (1.0 - u) * cand  # reference gru_compute
        valid = (lens > t)[:, None]
        hs[t] = h_new * valid.to(x.dtype)
        h = torch.where(valid, h_new, h)
    return {"Hidden": torch.stack(hs, dim=1)}


@register_op("dynamic_lstmp", no_grad_set={"SeqLen"})
def dynamic_lstmp(inputs, attrs, device):
    """LSTM with recurrent projection — Input [B, T, 4D] pre-projected,
    Weight [P, 4D] projection-to-gates, ProjWeight [D, P]; the recurrent
    state is the P-dim projection.  Outputs Projection [B, T, P], Cell
    [B, T, D]; a padding step repeats the held state."""
    x = one(inputs, "Input")
    w = one(inputs, "Weight")
    w_proj = one(inputs, "ProjWeight")
    B, T, D4 = x.shape
    D, P = D4 // 4, w_proj.shape[1]
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACTS[attrs.get("proj_activation", "tanh")]
    b_gate, peep = _gate_bias(maybe(inputs, "Bias"), D4, attrs.get("use_peepholes", True), x)
    lens = _lens(inputs, x)
    r, c = x.new_zeros((B, P)), x.new_zeros((B, D))
    rs, cs = [], []
    for t in range(T):
        gates = x[:, t] + r @ w + b_gate
        gi, gc, gf, go = gates.split(D, dim=-1)
        if peep is not None:
            gi = gi + c * peep[0]
            gf = gf + c * peep[1]
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if peep is not None:
            go = go + c_new * peep[2]
        r_new = proj_act((gate_act(go) * cell_act(c_new)) @ w_proj)
        active = (lens > t)[:, None]
        r = torch.where(active, r_new, r)
        c = torch.where(active, c_new, c)
        rs.append(r)
        cs.append(c)
    return {"Projection": torch.stack(rs, dim=1), "Cell": torch.stack(cs, dim=1)}
