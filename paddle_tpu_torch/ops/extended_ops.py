"""Extended ops: the part of the JAX package's ``ops/extended_ops.py``
ported so far.

* ``sampling_id`` (reference: sampling_id_op.cc).  The JAX package
  registers it twice, in ``ops/tensor_ops.py`` and here; this module is
  imported last, so this registration is the one it keeps, and the
  port's is this one.
* ``load`` (reference: load_op.cc), which ``layers.load`` appends.
* ``cos_sim``, ``sequence_reshape``, ``sequence_scatter`` and
  ``chunk_eval``, which the sequence models and the book programs use.
* The alias lines at the end of the JAX file: names the reference
  registers for ops that another type computes.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.registry import _REGISTRY, register_op
from paddle_tpu_torch.ops.common import generator, maybe, one


@register_op("sampling_id", differentiable=False, random=True)
def sampling_id(inputs, attrs, device):
    """One id per row of the probabilities X [B, C], drawn from that row's
    distribution (the Gumbel-max draw ``jax.random.categorical`` makes,
    from a generator seeded with ``seed``, 7919 where that is 0); int64."""
    x = one(inputs, "X")
    if x.device.type == "meta":  # shape inference: no generator there
        return {"Out": torch.empty(x.shape[:1], dtype=torch.int64, device=x.device)}
    u = torch.rand(tuple(x.shape), generator=generator(int(attrs.get("seed", 0)) or 7919, x.device),
                   dtype=torch.float32, device=x.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    logits = torch.log(torch.clamp(x.to(torch.float32), min=1e-30))
    return {"Out": torch.argmax(logits - torch.log(-torch.log(u)), dim=1)}


def _load_array(path):
    try:
        return np.load(path, mmap_mode="r")
    except FileNotFoundError:
        return np.load(path + ".npy", mmap_mode="r")


@register_op("load", differentiable=False, host_read=True)
def load_op(inputs, attrs, device):
    """The array a ``save_vars`` file holds (``file_path``, or with
    ``.npy`` added), on ``device``; float64 comes back as float32, as
    the JAX package's arrays do.  The file is read on the host at every
    run (and its header when the op is appended, for the output's
    shape), so a plan holding the op stays on the interpreter."""
    arr = _load_array(attrs["file_path"])
    dt = core_types.torch_dtype(core_types.canonical_dtype(
        "float32" if arr.dtype == np.float64 else str(arr.dtype)))
    if device.type == "meta":
        return {"Out": torch.empty(arr.shape, dtype=dt, device=device)}
    return {"Out": torch.from_numpy(np.array(arr)).to(device=device, dtype=dt)}


@register_op("cos_sim")
def cos_sim(inputs, attrs, device):
    """reference: cos_sim_op.h: the cosine of each row of X [B, D] with Y's
    (Y may be [1, D], broadcast over X's rows); XNorm and YNorm [., 1]."""
    x, y = one(inputs, "X"), one(inputs, "Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    return {"Out": out, "XNorm": xn, "YNorm": yn}


@register_op("sequence_reshape", no_grad_set={"SeqLen"})
def sequence_reshape(inputs, attrs, device):
    """reference: sequence_ops/sequence_reshape_op.cc: each row's features
    re-chunked to ``new_dim``, [B, T, D] -> [B, T·D / new_dim, new_dim];
    the lengths scale by D / new_dim (OutSeqLen)."""
    x = one(inputs, "X")
    seq_len = maybe(inputs, "SeqLen")
    new_dim = int(attrs["new_dim"])
    B, T, D = x.shape
    res = {"Out": x.reshape(B, T * D // new_dim, new_dim)}
    if seq_len is not None:
        res["OutSeqLen"] = (seq_len * D) // new_dim
    return res


@register_op("sequence_scatter", no_grad_set={"Ids", "SeqLen"})
def sequence_scatter(inputs, attrs, device):
    """reference: sequence_ops/sequence_scatter_op.cc: per row b,
    out[b, ids[b, t]] += updates[b, t] over the valid t (X [B, D], Ids and
    Updates [B, T]); repeated ids add up."""
    x, ids, upd = one(inputs, "X"), one(inputs, "Ids").long(), one(inputs, "Updates")
    seq_len = maybe(inputs, "SeqLen")
    B, T = ids.shape
    if seq_len is not None:
        valid = torch.arange(T, device=x.device)[None, :] < seq_len.reshape(-1, 1)
        upd = upd * valid.to(upd.dtype)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, T)
    return {"Out": torch.index_put(x, (rows.reshape(-1), ids.reshape(-1)), upd.reshape(-1),
                                   accumulate=True)}


# chunk_eval's tag of each scheme: (tags a type, begin, inside, end, single); -1 absent
_CHUNK_TAGS = {"IOB": (2, 0, 1, -1, -1), "IOE": (2, -1, 0, 1, -1), "IOBES": (4, 0, 1, 2, 3),
               "plain": (1, -1, -1, -1, -1)}


@register_op("chunk_eval", differentiable=False)
def chunk_eval(inputs, attrs, device):
    """reference: chunk_eval_op.h: chunk precision, recall and F1 of a
    tagging (IOB, IOE, IOBES or plain) on padded [B, T] Inference and
    Label, with SeqLength.  As the JAX op: a chunk begins and ends where a
    pure function of the (previous, current) or (current, next) tag and
    type says so, each begin's end is the first end at or after it (a
    reverse cumulative min), and a predicted chunk is correct where a
    label chunk has the same begin, type and end.  The counts are int64
    [1]; nothing is read on the host."""
    scheme = attrs.get("chunk_scheme", "IOB")
    if scheme not in _CHUNK_TAGS:
        raise ValueError("chunk_eval: unknown chunk_scheme %r" % scheme)
    n_tag, t_beg, t_in, t_end, t_single = _CHUNK_TAGS[scheme]
    num_types = int(attrs["num_chunk_types"])
    excluded = list(attrs.get("excluded_chunk_types", []) or [])
    inference, label = one(inputs, "Inference"), one(inputs, "Label")
    seq_len = maybe(inputs, "SeqLength")
    inf = inference.reshape(inference.shape[0], -1).long()
    lab = label.reshape(label.shape[0], -1).long()
    B, T = lab.shape
    dev = lab.device
    idx = torch.arange(T, device=dev)[None, :]
    valid = (idx < seq_len.reshape(-1, 1) if seq_len is not None
             else torch.ones_like(lab, dtype=torch.bool))
    other = num_types

    def col(v):
        return torch.full((B, 1), v, dtype=torch.long, device=dev)

    def segments(tags):
        # positions past the sequence are O: chunks close at its end
        typ = torch.where(valid, tags // n_tag, other)
        tag = torch.where(valid, tags % n_tag, 0)
        non_o = typ != other
        ptyp, ptag = torch.cat([col(other), typ[:, :-1]], 1), torch.cat([col(-2), tag[:, :-1]], 1)
        begin = non_o & ((ptyp == other) | (typ != ptyp) | (tag == t_beg)
                         | ((tag == t_in) & ((ptag == t_end) | (ptag == t_single)))
                         | ((tag == t_end) & ((ptag == t_end) | (ptag == t_single)))
                         | (tag == t_single))
        ntyp, ntag = torch.cat([typ[:, 1:], col(other)], 1), torch.cat([tag[:, 1:], col(-2)], 1)
        end = non_o & ((ntyp == other) | (ntyp != typ)
                       | ((tag == t_beg) & ((ntag == t_beg) | (ntag == t_single)))
                       | ((tag == t_in) & ((ntag == t_beg) | (ntag == t_single)))
                       | (tag == t_end) | (tag == t_single))
        ends_at = torch.where(end, idx, T + 1)
        e = torch.cummin(ends_at.flip(1), dim=1).values.flip(1)
        for t in excluded:
            begin = begin & (typ != t)
        return begin, typ, e

    beg_o, typ_o, e_o = segments(inf)
    beg_l, typ_l, e_l = segments(lab)
    n_infer, n_label = beg_o.sum(), beg_l.sum()
    n_correct = (beg_o & beg_l & (typ_o == typ_l) & (e_o == e_l)).sum()
    nf = lambda v: v.float()  # noqa: E731
    precision = torch.where(n_infer > 0, nf(n_correct) / torch.clamp(nf(n_infer), min=1), 0.0)
    recall = torch.where(n_label > 0, nf(n_correct) / torch.clamp(nf(n_label), min=1), 0.0)
    f1 = torch.where(n_correct > 0,
                     2 * precision * recall / torch.clamp(precision + recall, min=1e-38), 0.0)
    return {"Precision": precision.reshape(1), "Recall": recall.reshape(1),
            "F1-Score": f1.reshape(1), "NumInferChunks": n_infer.reshape(1),
            "NumLabelChunks": n_label.reshape(1), "NumCorrectChunks": n_correct.reshape(1)}


def _alias(new, old):
    if old in _REGISTRY and new not in _REGISTRY:
        _REGISTRY[new] = _REGISTRY[old]


_alias("squeeze", "squeeze2")
_alias("unsqueeze", "unsqueeze2")
_alias("flatten", "flatten2")
_alias("fill_zeros_like2", "fill_zeros_like")
_alias("lstm", "dynamic_lstm")
_alias("lstmp", "dynamic_lstmp")
_alias("gru", "dynamic_gru")
_alias("fill", "fill_constant")
_alias("depthwise_conv2d_transpose", "conv2d_transpose")
