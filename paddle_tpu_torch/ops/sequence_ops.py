"""Sequence ops over the padded+length encoding of LoDTensor.

PyTorch port of the JAX package's ``ops/sequence_ops.py``.  The
reference packs variable-length sequences as concatenated rows with LoD
offsets (paddle/fluid/framework/lod_tensor.h:110,229); the encoding here
is the JAX package's: a dense padded batch [batch, max_len, ...] plus a
companion length vector (``layers.data(lod_level=1)`` creates the
pair).  Every op consumes (X, SeqLen) and masks padding, the math the
reference's operators/sequence_ops/ kernels compute over ragged rows.

Recurrences over time (``edit_distance``'s DP rows, the CRF's forward
and Viterbi passes) are Python loops of tensor ops; nothing reads a
value on the host, so a plan holding these ops is captured.  Where the
JAX package breaks ties by index (``lax.top_k``, a stable ``argsort``,
``argmax``) the port does the same: ``ops/common.top_k`` and
``torch.sort(stable=True)``.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops import common
from paddle_tpu_torch.ops.common import maybe, one


def _steps(T, device):
    return torch.arange(T, device=device)


def _mask(x, seq_len):
    """[B, T, 1...] boolean validity mask from lengths [B]."""
    m = _steps(x.shape[1], x.device)[None, :] < seq_len.reshape(-1, 1)
    return m.reshape(m.shape + (1,) * (x.dim() - 2))


def _lengths(seq_len, x, dtype=torch.int32):
    """[B] lengths, or the full time dim where there is no SeqLen."""
    if seq_len is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=dtype, device=x.device)
    return seq_len.reshape(-1)


@register_op("sequence_mask", differentiable=False)
def sequence_mask(inputs, attrs, device):
    x = one(inputs, "X")  # lengths
    maxlen = attrs.get("maxlen", -1)
    if maxlen < 0:
        raise ValueError("sequence_mask needs a static maxlen attr")
    out = _steps(maxlen, x.device)[None, :] < x.reshape(-1, 1)
    return {"Y": out.to(core_types.torch_dtype(attrs.get("out_dtype", "int64")))}


@register_op("sequence_pool", no_grad_set={"SeqLen"})
def sequence_pool(inputs, attrs, device):
    """reference: operators/sequence_ops/sequence_pool_op.cc (SUM /
    AVERAGE / SQRT / MAX / LAST / FIRST pooling over each sequence)."""
    x = one(inputs, "X")  # [B, T, D]
    seq_len = _lengths(maybe(inputs, "SeqLen"), x)
    ptype = attrs.get("pooltype", "SUM").upper()
    m = _mask(x, seq_len).to(x.dtype)
    lens = seq_len.to(x.dtype).clamp(min=1).reshape((-1,) + (1,) * (x.dim() - 2))
    if ptype == "SUM":
        out = (x * m).sum(1)
    elif ptype == "AVERAGE":
        out = (x * m).sum(1) / lens
    elif ptype == "SQRT":
        out = (x * m).sum(1) / lens.sqrt()
    elif ptype == "MAX":
        out = torch.where(m > 0, x, torch.finfo(x.dtype).min).amax(1)
    elif ptype == "LAST":
        idx = (seq_len - 1).clamp(min=0).long()
        out = x[torch.arange(x.shape[0], device=x.device), idx]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError("unknown pooltype %s" % ptype)
    return {"Out": out, "MaxIndex": torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)}


@register_op("sequence_softmax", no_grad_set={"SeqLen"})
def sequence_softmax(inputs, attrs, device):
    x = one(inputs, "X")  # [B, T]
    seq_len = maybe(inputs, "SeqLen")
    if seq_len is None:
        return {"Out": torch.softmax(x, dim=1)}
    m = _steps(x.shape[1], x.device)[None, :] < seq_len.reshape(-1, 1)
    xm = torch.where(m, x, torch.finfo(x.dtype).min)
    e = torch.where(m, torch.exp(xm - xm.amax(1, keepdim=True)), 0.0)
    return {"Out": e / e.sum(1, keepdim=True).clamp(min=1e-9)}


def _broadcast_rows(x, T):
    return x.unsqueeze(1).expand((x.shape[0], T) + tuple(x.shape[1:]))


@register_op("sequence_expand", no_grad_set={"Y", "SeqLen"})
def sequence_expand(inputs, attrs, device):
    """X [B, D] repeated along Y's time dim: [B, T, D]."""
    return {"Out": _broadcast_rows(one(inputs, "X"), one(inputs, "Y").shape[1])}


@register_op("sequence_expand_as", no_grad_set={"Y", "SeqLen"})
def sequence_expand_as(inputs, attrs, device):
    """Each row of X to Y's time dim (reference: sequence_expand_as_op.cc
    on the padded encoding: broadcast rows)."""
    return {"Out": _broadcast_rows(one(inputs, "X"), one(inputs, "Y").shape[1])}


def _gather_time(x, idx):
    """x [B, T, ...] at idx [B, T'] along the time dim."""
    idx = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    return x.gather(1, idx.expand(tuple(idx.shape[:2]) + tuple(x.shape[2:])))


@register_op("sequence_reverse", no_grad_set={"SeqLen"})
def sequence_reverse(inputs, attrs, device):
    x = one(inputs, "X")  # [B, T, D]
    seq_len = maybe(inputs, "SeqLen")
    if seq_len is None:
        return {"Y": x.flip(1)}
    idx = _steps(x.shape[1], x.device)[None, :]
    lens = seq_len.reshape(-1, 1)
    return {"Y": _gather_time(x, torch.where(idx < lens, lens - 1 - idx, idx))}


@register_op("sequence_concat", no_grad_set={"SeqLen"})
def sequence_concat(inputs, attrs, device):
    return {"Out": torch.cat(list(inputs["X"]), dim=1)}


@register_op("sequence_pad", no_grad_set={"PadValue", "SeqLen"})
def sequence_pad(inputs, attrs, device):
    """Identity on the padded encoding; Length = the lengths."""
    x = one(inputs, "X")
    return {"Out": x, "Length": _lengths(maybe(inputs, "SeqLen"), x, torch.int64).long()}


@register_op("sequence_unpad", no_grad_set={"Length"})
def sequence_unpad(inputs, attrs, device):
    return {"Out": one(inputs, "X")}


@register_op("sequence_slice", no_grad_set={"Offset", "Length"})
def sequence_slice(inputs, attrs, device):
    # the padded view passes X through, as the JAX package's op does
    return {"Out": one(inputs, "X")}


@register_op("sequence_erase", no_grad_set={"SeqLen"}, differentiable=False)
def sequence_erase(inputs, attrs, device):
    """Remove listed tokens and repack left (reference:
    sequence_erase_op.cc).  X [B, T] ids; Out [B, T] packed and
    zero-padded, OutSeqLen [B]."""
    x = one(inputs, "X")
    seq_len = maybe(inputs, "SeqLen")
    T = x.shape[1]
    t_idx = _steps(T, x.device)[None, :]
    keep = t_idx < (seq_len.reshape(-1, 1) if seq_len is not None else T)
    for tok in attrs.get("tokens", []):
        keep = keep & (x != tok)
    order = torch.sort(torch.where(keep, t_idx, T + t_idx), dim=1).indices
    new_len = keep.sum(1)
    packed = torch.where(t_idx < new_len[:, None], x.gather(1, order), 0)
    return {"Out": packed, "OutSeqLen": new_len.to(torch.int32)}


@register_op("sequence_enumerate", no_grad_set={"SeqLen"}, differentiable=False)
def sequence_enumerate(inputs, attrs, device):
    """Sliding windows of ids (reference: sequence_enumerate_op.cc): X
    [B, T] -> Out [B, T, win_size], positions past the end pad_value."""
    x = one(inputs, "X")
    seq_len = maybe(inputs, "SeqLen")
    pad = attrs.get("pad_value", 0)
    B, T = x.shape
    length = seq_len.reshape(-1, 1) if seq_len is not None else T
    t_idx = _steps(T, x.device)[None, :]
    cols = []
    for j in range(int(attrs.get("win_size", 2))):
        shifted = torch.cat([x, torch.full((B, j), pad, dtype=x.dtype, device=x.device)], 1)[:, j: j + T]
        cols.append(torch.where(t_idx + j < length, shifted, pad))
    return {"Out": torch.stack(cols, dim=-1)}


@register_op("edit_distance", differentiable=False,
             no_grad_set={"Hyps", "Refs", "HypsLength", "RefsLength"})
def edit_distance(inputs, attrs, device):
    """Batched Levenshtein distance (reference: edit_distance_op.h, the
    O(Th*Tr) DP per pair): one DP row a hypothesis position; the
    within-row recurrence ``x[j] = min(c[j], x[j-1]+1)`` is
    ``j + cummin(c[j]-j)``, as the JAX package computes it."""
    hyp = one(inputs, "Hyps")  # [B, Th] ids
    ref = one(inputs, "Refs")  # [B, Tr] ids
    B, Th = hyp.shape
    Tr = ref.shape[1]
    hlen = _lengths(maybe(inputs, "HypsLength"), hyp).long()
    rlen = _lengths(maybe(inputs, "RefsLength"), ref).long()
    jcol = torch.arange(Tr + 1, dtype=torch.float32, device=hyp.device)
    row = jcol.expand(B, Tr + 1)
    rows = [row]
    for i in range(Th):
        cost = (hyp[:, i: i + 1] != ref).to(torch.float32)
        c = torch.cat([row[:, :1] + 1.0, torch.minimum(row[:, :-1] + cost, row[:, 1:] + 1.0)], 1)
        row = jcol + torch.cummin(c - jcol, dim=1).values
        rows.append(row)
    dist = torch.stack(rows)[hlen, torch.arange(B, device=hyp.device), rlen]
    if attrs.get("normalized", True):
        dist = dist / rlen.to(torch.float32).clamp(min=1.0)
    return {"Out": dist.reshape(B, 1),
            "SequenceNum": torch.full((), B, dtype=torch.int64, device=hyp.device)}


@register_op("ctc_align", differentiable=False, no_grad_set={"Input", "SeqLen"})
def ctc_align(inputs, attrs, device):
    """CTC best-path alignment (reference: ctc_align_op.h): merge repeated
    tokens, drop blanks, left-pack the kept tokens (a stable sort on the
    drop mask) and fill with ``padding_num``; OutputLength [B]."""
    x = one(inputs, "Input")  # [B, T] ids
    seq_len = maybe(inputs, "SeqLen")
    B, T = x.shape
    t_idx = _steps(T, x.device)[None, :]
    keep = (x != int(attrs.get("blank", 0))) & (t_idx < _lengths(seq_len, x).reshape(-1, 1))
    if attrs.get("merge_repeated", True):
        prev = torch.cat([torch.full((B, 1), -1, dtype=x.dtype, device=x.device), x[:, :-1]], 1)
        keep = keep & (x != prev)
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True).indices
    count = keep.to(torch.int32).sum(1, dtype=torch.int32)
    out = torch.where(t_idx < count[:, None], x.gather(1, order), int(attrs.get("padding_num", 0)))
    return {"Output": out, "OutputLength": count}


@register_op("linear_chain_crf", no_grad_set={"Label", "SeqLen"})
def linear_chain_crf(inputs, attrs, device):
    """Linear-chain CRF negative log-likelihood (reference:
    linear_chain_crf_op.h).  Transition rows: 0 start, 1 end, 2.. tag to
    tag.  The log-space alpha recursion runs over the padded time axis,
    padding steps carrying alpha through; LogLikelihood [B, 1] is the
    cost -(score(label) - log Z).  Alpha, EmissionExps and
    TransitionExps are emitted as the JAX package emits them."""
    emission = one(inputs, "Emission")  # [B, T, K]
    transition = one(inputs, "Transition")  # [K+2, K]
    label = one(inputs, "Label")
    if label.dim() == 3:
        label = label.squeeze(-1)
    B, T, K = emission.shape
    length = _lengths(maybe(inputs, "SeqLen"), emission)
    w_start, w_end, w = transition[0], transition[1], transition[2:]
    a = w_start[None, :] + emission[:, 0, :]
    alphas = [a]
    for t in range(1, T):
        a_new = torch.logsumexp(a[:, :, None] + w[None, :, :], dim=1) + emission[:, t]
        a = torch.where((length > t)[:, None], a_new, a)
        alphas.append(a)
    log_z = torch.logsumexp(a + w_end[None, :], dim=1)
    lbl = label.long()
    t_mask = (_steps(T, emission.device)[None, :] < length.reshape(-1, 1)).to(emission.dtype)
    em_score = (emission.gather(2, lbl[:, :, None]).squeeze(-1) * t_mask).sum(1)
    trans_score = (w[lbl[:, :-1], lbl[:, 1:]] * t_mask[:, 1:]).sum(1)
    l_last = lbl.gather(1, (length.long() - 1).clamp(min=0)[:, None]).squeeze(1)
    score = em_score + trans_score + w_start[lbl[:, 0]] + w_end[l_last]
    nll = torch.where(length > 0, log_z - score, 0.0)
    return {
        "LogLikelihood": nll.reshape(B, 1),
        "Alpha": torch.stack(alphas, dim=1),
        "EmissionExps": torch.exp(emission - emission.amax(2, keepdim=True)),
        "TransitionExps": torch.exp(transition),
    }


@register_op("crf_decoding", differentiable=False,
             no_grad_set={"Emission", "Transition", "Label", "SeqLen"})
def crf_decoding(inputs, attrs, device):
    """Viterbi decode for the linear-chain CRF (reference:
    crf_decoding_op.h): best scores and backpointers forward, then the
    backtrack.  With Label, the 0/1 per-position correctness instead of
    the path.  Positions past a sequence's length are 0."""
    emission = one(inputs, "Emission")  # [B, T, K]
    transition = one(inputs, "Transition")
    label = maybe(inputs, "Label")
    B, T, K = emission.shape
    length = _lengths(maybe(inputs, "SeqLen"), emission)
    w_start, w_end, w = transition[0], transition[1], transition[2:]
    tags = torch.arange(K, device=emission.device)[None, :]
    d = w_start[None, :] + emission[:, 0, :]
    bps = []
    for t in range(1, T):
        cand = d[:, :, None] + w[None, :, :]  # [B, K_from, K_to]
        active = (length > t)[:, None]
        bps.append(torch.where(active, cand.argmax(1), tags))
        d = torch.where(active, cand.amax(1) + emission[:, t], d)
    tag = (d + w_end[None, :]).argmax(1)
    path = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = tag
        tag = bps[t - 1].gather(1, tag[:, None]).squeeze(1)
    path[0] = tag
    t_mask = _steps(T, emission.device)[None, :] < length.reshape(-1, 1)
    path = torch.where(t_mask, torch.stack(path, dim=1), 0).long()
    if label is not None:
        lbl = label.squeeze(-1) if label.dim() == 3 else label
        path = (path == lbl.long()).long() * t_mask
    return {"ViterbiPath": path}


@register_op("lod_rank_table", differentiable=False, no_grad_set={"X"})
def lod_rank_table(inputs, attrs, device):
    """Rank table over sequence lengths (reference: lod_rank_table.cc):
    the original positions sorted by length descending, ties in original
    order, and the sorted lengths."""
    lengths = one(inputs, "X").reshape(-1).to(torch.int32)
    order = torch.sort(-lengths, stable=True).indices
    return {"Index": order.to(torch.int32), "Length": lengths[order]}


@register_op("reorder_lod_tensor_by_rank", no_grad_set={"RankTable"})
def reorder_lod_tensor_by_rank(inputs, attrs, device):
    """X's batch rows in rank-table order (reference:
    reorder_lod_tensor_by_rank_op.cc); the vjp scatters back."""
    return {"Out": one(inputs, "X")[one(inputs, "RankTable").reshape(-1).long()]}


@register_op("beam_search", differentiable=False,
             no_grad_set={"pre_ids", "pre_scores", "ids", "scores"})
def beam_search(inputs, attrs, device):
    """Per-step beam selection (reference: beam_search_op.cc), in the JAX
    package's static-shape form: every source keeps ``beam_size`` lanes;
    a beam that has emitted ``end_id`` offers one candidate (end_id, its
    own score) and its others at -1e9.

    pre_ids [B*K, 1], pre_scores [B*K, 1], ids [B*K, C] candidate tokens,
    scores [B*K, C] accumulated candidate scores (``is_accumulated=False``:
    probabilities, accumulated here as pre + log(score)).  Outputs
    selected_ids [B*K, 1], selected_scores [B*K, 1], parent_idx [B*K]
    int32 (the global row of each selection's source beam).  The top K
    of a source are ``jax.lax.top_k``'s: the lower index first on ties."""
    pre_ids = one(inputs, "pre_ids").reshape(-1)
    pre_sc = one(inputs, "pre_scores").reshape(-1)
    cand_ids = one(inputs, "ids")
    cand_sc = one(inputs, "scores")
    K, end_id = int(attrs["beam_size"]), int(attrs["end_id"])
    BK, C = cand_sc.shape
    B = BK // K
    if not bool(attrs.get("is_accumulated", True)):
        cand_sc = pre_sc[:, None] + torch.log(cand_sc.clamp(min=1e-30))
    fin = (pre_ids.to(torch.int32) == end_id)[:, None]
    slot0 = (torch.arange(C, device=cand_sc.device) == 0)[None, :]
    neg = torch.full((), -1e9, dtype=cand_sc.dtype, device=cand_sc.device)
    cand_sc = torch.where(fin, torch.where(slot0, pre_sc[:, None], neg), cand_sc)
    cand_ids = torch.where(fin, end_id, cand_ids.to(torch.int32))
    top_sc, top_ix = common.top_k(cand_sc.reshape(B, K * C), K)
    parent_idx = (torch.arange(B, device=cand_sc.device) * K)[:, None] + top_ix // C
    sel_ids = cand_ids.reshape(B, K * C).gather(1, top_ix)
    return {
        "selected_ids": sel_ids.reshape(-1, 1).long(),
        "selected_scores": top_sc.reshape(-1, 1),
        "parent_idx": parent_idx.reshape(-1).to(torch.int32),
    }


@register_op("beam_search_decode", differentiable=False,
             no_grad_set={"Ids", "Scores", "Parents"})
def beam_search_decode(inputs, attrs, device):
    """Backtrack beam-search arrays into full sequences (reference:
    beam_search_decode_op.cc).  Ids/Scores [T, B*K, 1] and Parents
    [T, B*K] (step 0's parents unused) -> SentenceIds [B, K, T] and
    SentenceScores [B, K], lanes sorted best first (a stable sort, as
    the JAX package's ``argsort(..., stable=True)``)."""
    ids = one(inputs, "Ids")
    scores = one(inputs, "Scores")
    parents = one(inputs, "Parents")
    K = int(attrs["beam_size"])
    T, BK = ids.shape[0], ids.shape[1]
    B = BK // K
    cur = torch.arange(BK, device=ids.device)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(ids[t].reshape(-1)[cur])
        if t > 0:
            cur = parents[t].reshape(-1)[cur].long()
    sent = torch.stack(toks[::-1], dim=-1).reshape(B, K, T).long()
    final_sc = scores[T - 1].reshape(B, K)
    order = torch.sort(-final_sc, dim=1, stable=True).indices
    return {"SentenceIds": sent.gather(1, order[:, :, None].expand(B, K, T)),
            "SentenceScores": final_sc.gather(1, order)}
