"""The ported part of the extended layer surface (reference:
python/paddle/fluid/layers/nn.py tail), as the JAX package's
``layers/extended.py`` builds it: the padded-encoding sequence layers
(``sequence_concat``, ``sequence_pad``, ``sequence_unpad``,
``sequence_slice``, ``sequence_reshape``, ``sequence_scatter``), the
per-step ``beam_search`` and ``beam_search_decode`` of a While decode
loop, ``dynamic_lstmp`` and ``lstm``, ``cos_sim`` and ``chunk_eval``, and
the names that wrap op types ported with other layers or compose ported
layers (the reductions, elementwise and logical tails, the random
wrappers, ``sum``, ``rank``, ``size``, ``eye``, ``linspace``,
``dice_loss``, ``npair_loss``, ``image_resize_short``, the step counter,
the SelectedRows and LoD shims).  The rest of that file is still to port
(ROADMAP A11).
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch import framework
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["sequence_concat", "sequence_pad", "sequence_unpad", "sequence_slice", "beam_search",
           "beam_search_decode", "dynamic_lstmp", "cos_sim", "dice_loss", "npair_loss",
           "sampling_id", "sequence_reshape", "sequence_scatter", "gaussian_random",
           "gaussian_random_batch_size_like", "uniform_random_batch_size_like", "sum", "rank",
           "size", "reduce_all", "reduce_any", "elementwise_mod", "elementwise_floordiv",
           "logical_xor", "image_resize_short", "autoincreased_step_counter",
           "get_tensor_from_selected_rows", "merge_selected_rows", "lod_reset", "lod_append",
           "chunk_eval", "lstm", "eye", "linspace", "tensor_array_to_tensor", "is_empty"]


def _simple(op_type, ins, attrs=None, outs=("Out",), dtype=None):
    helper = LayerHelper(op_type)
    first = next((vs[0] for vs in ins.values() if vs), None)
    out_vars = {slot: helper.create_variable_for_type_inference(
        dtype or getattr(first, "dtype", "float32")) for slot in outs}
    helper.append_op(type=op_type, inputs={k: list(vs) for k, vs in ins.items()},
                     outputs={k: [v] for k, v in out_vars.items()}, attrs=attrs or {})
    return [out_vars[s] for s in outs]


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


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers,
         dropout_prob=0.0, is_bidirec=False, is_test=False, name=None,
         default_initializer=None, seed=-1):
    """reference: layers/nn.py lstm (the cudnn multi-layer LSTM) — built
    as stacked fc->dynamic_lstm layers (+ reversed pass concat when
    bidirectional)."""
    from paddle_tpu_torch.layers import nn, rnn as lrnn, tensor as ltensor

    h = input
    last_h_list, last_c_list = [], []
    for _ in range(num_layers):
        proj = nn.fc(h, hidden_size * 4, num_flatten_dims=2, bias_attr=False)
        fwd, fwd_c = lrnn.dynamic_lstm(proj, hidden_size * 4, use_peepholes=False)
        if is_bidirec:
            projb = nn.fc(h, hidden_size * 4, num_flatten_dims=2, bias_attr=False)
            bwd, bwd_c = lrnn.dynamic_lstm(projb, hidden_size * 4,
                                           use_peepholes=False, is_reverse=True)
            h = ltensor.concat([fwd, bwd], axis=2)
            last_c_list += [nn.sequence_last_step(fwd_c),
                            nn.sequence_last_step(bwd_c)]
        else:
            h = fwd
            last_c_list.append(nn.sequence_last_step(fwd_c))
        if dropout_prob and not is_test:
            h = nn.dropout(h, dropout_prob)
        last_h_list.append(nn.sequence_last_step(h))
    last_hidden = ltensor.stack(last_h_list, axis=0)
    last_cell = ltensor.stack(last_c_list, axis=0)
    return h, last_hidden, last_cell


# -- losses / metrics ------------------------------------------------------
def cos_sim(X, Y):
    """reference: layers/nn.py cos_sim."""
    return _simple("cos_sim", {"X": [X], "Y": [Y]}, outs=("Out", "XNorm", "YNorm"))[0]


def dice_loss(input, label, epsilon=1e-5):
    """reference: layers/nn.py dice_loss — composition over existing ops."""
    from paddle_tpu_torch.layers import tensor as ltensor

    label = ltensor.cast(label, input.dtype)
    inter = ltensor.reduce_sum(input * label)
    union = ltensor.reduce_sum(input) + ltensor.reduce_sum(label)
    return 1.0 - (2.0 * inter + epsilon) / (union + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """reference: layers/nn.py npair_loss — cross-entropy over the
    anchor@positive^T similarity matrix with equal-label soft targets,
    plus L2 on the embeddings."""
    from paddle_tpu_torch.layers import nn, tensor as ltensor

    sim = nn.matmul(anchor, positive, transpose_y=True)  # [B, B]
    lab_col = ltensor.cast(ltensor.reshape(labels, shape=[-1, 1]), "float32")
    helper = LayerHelper("npair_equal")
    eqv = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="equal",
                     inputs={"X": [lab_col], "Y": [ltensor.transpose(lab_col, [1, 0])]},
                     outputs={"Out": [eqv]}, attrs={})
    tgt = ltensor.cast(eqv, "float32")
    tgt = tgt / ltensor.reduce_sum(tgt, dim=1, keep_dim=True)
    xent = nn.softmax_with_cross_entropy(sim, tgt, soft_label=True)
    l2 = ltensor.reduce_mean(
        ltensor.reduce_sum(anchor * anchor, dim=1)
        + ltensor.reduce_sum(positive * positive, dim=1)
    )
    return ltensor.reduce_mean(xent) + l2 * l2_reg


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """reference: layers/nn.py chunk_eval (chunk_eval_op.h) — in-graph
    chunk-level precision/recall/F1 on padded [B, T] predictions+labels
    (+ optional per-row seq_length).  Returns the reference's 6-tuple
    (precision, recall, f1, num_infer, num_label, num_correct)."""
    helper = LayerHelper("chunk_eval")
    outs = {n: helper.create_variable_for_type_inference("float32" if i < 3 else "int64")
            for i, n in enumerate(["Precision", "Recall", "F1-Score", "NumInferChunks",
                                   "NumLabelChunks", "NumCorrectChunks"])}
    ins = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        ins["SeqLength"] = [seq_length]
    helper.append_op(
        type="chunk_eval", inputs=ins,
        outputs={k: [v] for k, v in outs.items()},
        attrs={"chunk_scheme": chunk_scheme, "num_chunk_types": int(num_chunk_types),
               "excluded_chunk_types": list(excluded_chunk_types or [])},
    )
    return (outs["Precision"], outs["Recall"], outs["F1-Score"], outs["NumInferChunks"],
            outs["NumLabelChunks"], outs["NumCorrectChunks"])


# -- sequence extensions ---------------------------------------------------
def sequence_reshape(input, new_dim, seq_len=None):
    """reference: layers/nn.py sequence_reshape; with ``seq_len``, returns
    (out, the new lengths)."""
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    ins, outs, new_len = {"X": [input]}, {"Out": [out]}, None
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
        new_len = helper.create_variable_for_type_inference("int32")
        outs["OutSeqLen"] = [new_len]
    helper.append_op(type="sequence_reshape", inputs=ins, outputs=outs,
                     attrs={"new_dim": int(new_dim)})
    return (out, new_len) if seq_len is not None else out


def sequence_scatter(input, index, updates, seq_len=None, name=None):
    """reference: layers/nn.py sequence_scatter."""
    helper = LayerHelper("sequence_scatter")
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input], "Ids": [index], "Updates": [updates]}
    if seq_len is not None:
        ins["SeqLen"] = [seq_len]
    helper.append_op(type="sequence_scatter", inputs=ins, outputs={"Out": [out]}, attrs={})
    return out


# -- random / misc wrappers over ported kernels -----------------------------
def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    """reference: layers/nn.py sampling_id."""
    return _simple("sampling_id", {"X": [x]}, {"seed": int(seed)}, dtype="int64")[0]


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """reference: layers/ops.py gaussian_random."""
    prog = framework.default_main_program()
    return _simple(
        "gaussian_random", {"ShapeLike": []},
        {"shape": [int(s) for s in shape], "mean": float(mean), "std": float(std),
         "seed": int(seed) or prog.next_seed(), "dtype": dtype},
        dtype=dtype)[0]


def gaussian_random_batch_size_like(input, shape, mean=0.0, std=1.0,
                                    input_dim_idx=0, output_dim_idx=0,
                                    seed=0, dtype="float32"):
    """reference: layers/nn.py gaussian_random_batch_size_like."""
    prog = framework.default_main_program()
    return _simple(
        "gaussian_random", {"ShapeLike": [input]},
        {"shape": [int(s) for s in shape], "mean": float(mean), "std": float(std),
         "seed": int(seed) or prog.next_seed(), "dtype": dtype,
         "input_dim_idx": int(input_dim_idx), "output_dim_idx": int(output_dim_idx)},
        dtype=dtype)[0]


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    """reference: layers/nn.py uniform_random_batch_size_like."""
    prog = framework.default_main_program()
    return _simple(
        "uniform_random", {"ShapeLike": [input]},
        {"shape": [int(s) for s in shape], "min": float(min), "max": float(max),
         "seed": int(seed) or prog.next_seed(), "dtype": dtype,
         "input_dim_idx": int(input_dim_idx), "output_dim_idx": int(output_dim_idx)},
        dtype=dtype)[0]


def sum(x):
    """reference: layers/tensor.py sum (elementwise accumulate)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return _simple("sum", {"X": list(xs)})[0]


def rank(input):
    """reference: layers/nn.py rank — static ndim as a constant."""
    from paddle_tpu_torch.layers import tensor as ltensor

    return ltensor.fill_constant([1], "int32", len(input.shape))


def size(input):
    """reference: layers/nn.py size — element count (static dims only)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    n = 1
    for s in input.shape:
        n *= int(s)
    if n < 0:
        raise ValueError("size() needs a fully static shape, got %s" % (input.shape,))
    return ltensor.fill_constant([1], "int64", n)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    """reference: layers/nn.py reduce_all."""
    return _simple("reduce_all", {"X": [input]},
                   {"dim": dim if dim is None or isinstance(dim, list) else [dim],
                    "keep_dim": keep_dim, "reduce_all": dim is None}, dtype="bool")[0]


def reduce_any(input, dim=None, keep_dim=False, name=None):
    """reference: layers/nn.py reduce_any."""
    return _simple("reduce_any", {"X": [input]},
                   {"dim": dim if dim is None or isinstance(dim, list) else [dim],
                    "keep_dim": keep_dim, "reduce_all": dim is None}, dtype="bool")[0]


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    """reference: layers/nn.py elementwise_mod."""
    return _simple("elementwise_mod", {"X": [x], "Y": [y]}, {"axis": axis})[0]


def elementwise_floordiv(x, y, axis=-1, act=None, name=None):
    """reference: layers/nn.py elementwise_floordiv."""
    return _simple("elementwise_floordiv", {"X": [x], "Y": [y]}, {"axis": axis})[0]


def logical_xor(x, y, out=None, name=None):
    """reference: layers/nn.py logical_xor."""
    return _simple("logical_xor", {"X": [x], "Y": [y]}, dtype="bool")[0]


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """reference: layers/nn.py image_resize_short — resize so the short
    side hits out_short_len."""
    from paddle_tpu_torch.layers import nn

    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    oh = int(round(h * out_short_len / short))
    ow = int(round(w * out_short_len / short))
    return nn.image_resize(input, out_shape=[oh, ow], resample=resample)


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """reference: layers/nn.py autoincreased_step_counter — persistable
    int64 counter bumped by ``step`` each execution."""
    from paddle_tpu_torch import initializer

    helper = LayerHelper("global_step_counter")
    block = helper.main_program.global_block()
    name = counter_name or "@STEP_COUNTER@"
    counter = block.vars.get(name)
    if counter is None:
        counter = block.create_var(name=name, shape=[1], dtype="int64",
                                   persistable=True, stop_gradient=True)
        helper.set_variable_initializer(counter, initializer.Constant(float(begin - step)))
    helper.append_op(type="scale", inputs={"X": [counter]}, outputs={"Out": [counter]},
                     attrs={"scale": 1.0, "bias": float(step)})
    return counter


# -- the SelectedRows and LoD shims ----------------------------------------
def get_tensor_from_selected_rows(x, name=None):
    """reference: layers/nn.py get_tensor_from_selected_rows.  Sparse row
    gradients go through the parameter server's push; a dense var passes
    through unchanged."""
    return x


def merge_selected_rows(x, name=None):
    """reference: layers/nn.py merge_selected_rows — duplicate rows merge
    in the parameter server's push; identity for a dense var."""
    return x


def lod_reset(x, y=None, target_lod=None):
    """reference: layers/nn.py lod_reset.  Lengths travel as a companion
    var, so this returns (x, the new lengths var) for the sequence ops
    downstream; x itself is unchanged."""
    from paddle_tpu_torch.layers import tensor as ltensor

    if y is not None:
        return x, y
    if target_lod is None:
        raise ValueError("lod_reset needs y or target_lod")
    lengths = ([int(b) - int(a) for a, b in zip(target_lod, target_lod[1:])]
               if len(target_lod) and target_lod[0] == 0 else [int(t) for t in target_lod])
    return x, ltensor.assign(np.asarray(lengths, "int32"))


def lod_append(x, level):
    """reference: layers/nn.py lod_append — returns (x, the inner-length
    var of a new nested level)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    return x, ltensor.assign(np.asarray(level, "int32"))


# -- tensor-namespace tail (reference: layers/tensor.py) -------------------
def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    """reference: layers/tensor.py eye."""
    from paddle_tpu_torch.layers import tensor as ltensor

    num_columns = num_columns or num_rows
    e = np.eye(int(num_rows), int(num_columns)).astype(dtype)
    if batch_shape:
        e = np.broadcast_to(e, list(batch_shape) + list(e.shape)).copy()
    return ltensor.assign(e)


def linspace(start, stop, num, dtype="float32"):
    """reference: layers/tensor.py linspace, as a constant."""
    from paddle_tpu_torch.layers import tensor as ltensor

    return ltensor.assign(np.linspace(float(start), float(stop), int(num), dtype=dtype))


def tensor_array_to_tensor(input, axis=1, name=None):
    """reference: layers/tensor.py tensor_array_to_tensor — concat the
    (static pre-sized) array along axis; returns (out, sizes)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    vals = input if isinstance(input, (list, tuple)) else list(input)
    out = ltensor.concat(list(vals), axis=axis)
    sizes = ltensor.assign(np.asarray([int(v.shape[axis]) for v in vals], "int32"))
    return out, sizes


def is_empty(x, cond=None):
    """reference: layers/control_flow.py is_empty — static emptiness
    (shapes are known when the program is built)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    n = 1
    for s in x.shape:
        n *= int(s)
    return ltensor.assign(np.asarray([n == 0]))
