"""The part of the extended layer surface the seq2seq slice uses
(reference: python/paddle/fluid/layers/nn.py tail): the padded-encoding
sequence layers ``sequence_concat``, ``sequence_pad``,
``sequence_unpad`` and ``sequence_slice``, the per-step ``beam_search``
and ``beam_search_decode`` of a While decode loop, and
``dynamic_lstmp``, as the JAX package's ``layers/extended.py`` builds
them.  The rest of that file is still to port (ROADMAP A11).
"""
from __future__ import annotations

from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_concat", "sequence_pad", "sequence_unpad", "sequence_slice", "beam_search",
           "beam_search_decode", "dynamic_lstmp"]


def sequence_concat(input, name=None):
    """reference: layers/sequence_concat — concat along time."""
    helper = LayerHelper("sequence_concat")
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": list(input)},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_pad(x, pad_value, maxlen=None, seq_len=None, name=None):
    """reference: layers/nn.py sequence_pad — identity on the padded
    encoding; returns (x, lengths)."""
    helper = LayerHelper("sequence_pad")
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64")
    ins = {"X": [x], "PadValue": [pad_value]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_pad", inputs=ins,
                     outputs={"Out": [out], "Length": [length]}, attrs={})
    return out, length


def sequence_unpad(x, length, name=None):
    """reference: layers/nn.py sequence_unpad — identity view on the
    padded encoding (lengths travel alongside)."""
    helper = LayerHelper("sequence_unpad")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x], "Length": [length]},
                     outputs={"Out": [out]}, attrs={})
    return out


def sequence_slice(input, offset, length, name=None):
    """reference: layers/nn.py sequence_slice."""
    helper = LayerHelper("sequence_slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]}, attrs={})
    return out



# -- decode / eval wrappers ------------------------------------------------
def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, is_accumulated=True, name=None, return_parent_idx=False):
    """Per-step beam selection inside a While decode loop (reference:
    layers/nn.py beam_search:4406, beam_search_op.cc).  Static-shape
    mapping: every source keeps a fixed beam_size lane width and finished
    beams persist via end_id masking (see the op docstring); seed the
    first step by feeding lane 0 score 0 and the other lanes -1e9.  The
    whole-search alternative is paddle_tpu_torch.decoding.beam_search."""
    helper = LayerHelper("beam_search")
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_sc = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "ids": [ids], "scores": [scores]},
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_sc],
                 "parent_idx": [parent]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": int(level), "is_accumulated": bool(is_accumulated)},
    )
    if return_parent_idx:
        return sel_ids, sel_sc, parent
    return sel_ids, sel_sc


def beam_search_decode(ids, scores, beam_size, end_id, name=None,
                       parents=None):
    """Backtrack the per-step arrays into full sequences (reference:
    layers/nn.py beam_search_decode, beam_search_decode_op.cc).

    ``ids``/``scores`` are the stacked tensor-arrays [T, B*K, 1] the
    decode loop array_write'd; ``parents`` [T, B*K] is the matching array
    of beam_search parent_idx writes — the static encoding's replacement
    for the reference's LoD-encoded parentage (pass it; only a loop that
    never reorders beams could omit it).  Returns SentenceIds [B, K, T]
    and SentenceScores [B, K], best-first."""
    if parents is None:
        raise ValueError(
            "beam_search_decode on the static encoding needs the parents "
            "array (array_write each step's beam_search parent_idx)"
        )
    helper = LayerHelper("beam_search_decode")
    sent = helper.create_variable_for_type_inference("int64")
    sc = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores], "Parents": [parents]},
        outputs={"SentenceIds": [sent], "SentenceScores": [sc]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id)},
    )
    return sent, sc



def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, seq_len=None):
    """reference: layers/nn.py dynamic_lstmp — LSTM with recurrent
    projection; input must be pre-projected to [B, T, 4*hidden]
    (size = 4*hidden)."""
    helper = LayerHelper("dynamic_lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    hidden = size // 4
    w = helper.create_parameter(param_attr, shape=[proj_size, size], dtype=dtype)
    w_proj = helper.create_parameter(param_attr, shape=[hidden, proj_size],
                                     dtype=dtype)
    bias_w = 7 * hidden if use_peepholes else 4 * hidden
    b = helper.create_parameter(bias_attr, shape=[1, bias_w], dtype=dtype,
                                is_bias=True)
    proj = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    ins = {"Input": [input], "Weight": [w], "ProjWeight": [w_proj], "Bias": [b]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(
        type="dynamic_lstmp", inputs=ins,
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation},
    )
    return proj, cell

