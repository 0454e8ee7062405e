"""BERT-style encoder and pretraining heads, as the JAX package's
``models/transformer.py`` builds them.

The port carries the fused build of the encoder: the fused attention
op (padding as ``mask``, causality as ``causal``) with dropout off, for
serving (``bert_encoder``) and for pretraining (``bert_pretrain``).
The unfused attention path (matmul + softmax + an ``attn_bias``) and
dropout use ops that come with the training slice of the port; asking
for them raises here instead of building a program the executor cannot
run.  Parameter names (``<name>_enc_<i>_...``) match the JAX package's,
so weights saved by either package load in the other.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.layer_helper import LayerHelper
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["multi_head_attention", "encoder_layer", "positionwise_ffn", "bert_encoder",
           "bert_pretrain"]


def _fc3(x, size, name, num_flatten_dims=2, act=None):
    return layers.fc(
        x,
        size=size,
        num_flatten_dims=num_flatten_dims,
        param_attr=ParamAttr(name=name + "_w"),
        bias_attr=ParamAttr(name=name + "_b"),
        act=act,
    )


def _no_dropout(dropout_rate):
    if dropout_rate:
        raise NotImplementedError(
            "dropout is not ported yet; build with dropout_rate=0 (the "
            "inference configs) and fused attention")


def multi_head_attention(q_in, kv_in, d_model: int, n_head: int, dropout_rate: float = 0.1,
                         attn_bias=None, is_test: bool = False, name: str = "att",
                         fused: bool = False, mask=None, causal: bool = False):
    """Multi-head attention over [N, S, d_model] through the
    ``fused_attention`` op: q/k/v projections, a head split to
    [N, H, S, D], the op, the head merge and the output projection."""
    if not fused or attn_bias is not None:
        raise NotImplementedError(
            "only the fused attention path (mask=/causal=) is ported yet")
    _no_dropout(dropout_rate)
    d_head = d_model // n_head
    q = _fc3(q_in, d_model, name + "_q")
    k = _fc3(kv_in, d_model, name + "_k")
    v = _fc3(kv_in, d_model, name + "_v")

    def split_heads(x):
        # [N, S, d_model] -> [N, H, S, D]
        x = layers.reshape(x, shape=[0, 0, n_head, d_head])
        return layers.transpose(x, perm=[0, 2, 1, 3])

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    helper = LayerHelper(name + "_fused")
    ctx = helper.create_variable_for_type_inference(q.dtype)
    ins = {"Q": [q], "K": [k], "V": [v]}
    if mask is not None:
        ins["Mask"] = [mask]
    helper.append_op(
        type="fused_attention", inputs=ins, outputs={"Out": [ctx]},
        attrs={"causal": bool(causal), "scale": 1.0 / float(np.sqrt(d_head))},
    )
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    ctx = layers.reshape(ctx, shape=[0, 0, d_model])
    return _fc3(ctx, d_model, name + "_out")


def positionwise_ffn(x, d_model, d_inner, name, act="gelu", is_test=False, dropout_rate=0.1):
    _no_dropout(dropout_rate)
    hidden = _fc3(x, d_inner, name + "_fc0", act=act)
    return _fc3(hidden, d_model, name + "_fc1")


def encoder_layer(x, d_model, n_head, d_inner, attn_bias=None, dropout_rate: float = 0.1,
                  is_test: bool = False, name: str = "enc_0", fused: bool = False,
                  mask=None, causal: bool = False):
    """Post-LN transformer block (attention + FFN, residuals)."""
    att = multi_head_attention(
        x, x, d_model, n_head, dropout_rate, attn_bias, is_test,
        name=name + "_att", fused=fused, mask=mask, causal=causal,
    )
    x = layers.layer_norm(
        x + att,
        begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_ln1_scale"),
        bias_attr=ParamAttr(name=name + "_ln1_bias"),
    )
    ffn = positionwise_ffn(x, d_model, d_inner, name + "_ffn", is_test=is_test, dropout_rate=dropout_rate)
    return layers.layer_norm(
        x + ffn,
        begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_ln2_scale"),
        bias_attr=ParamAttr(name=name + "_ln2_bias"),
    )


def _embeddings(ids, vocab_size, d_model, max_pos, seq_len, name, extra_ids=None, extra_vocab=0):
    emb = layers.embedding(ids, size=[vocab_size, d_model], param_attr=ParamAttr(name=name + "_word_emb"))
    pos = layers.range(0, seq_len, 1, "int64")
    pos = layers.reshape(pos, shape=[1, seq_len])
    pos_emb = layers.embedding(pos, size=[max_pos, d_model], param_attr=ParamAttr(name=name + "_pos_emb"))
    out = emb + pos_emb
    if extra_ids is not None:
        out = out + layers.embedding(
            extra_ids, size=[extra_vocab, d_model], param_attr=ParamAttr(name=name + "_sent_emb"))
    return out


def bert_encoder(src_ids, input_mask=None, sent_ids=None, vocab_size: int = 30522,
                 d_model: int = 768, n_layer: int = 12, n_head: int = 12, d_inner: int = 3072,
                 max_pos: int = 512, seq_len: int = 128, dropout_rate: float = 0.1,
                 is_test: bool = False, name: str = "bert", fused_attention: bool = False):
    """BERT-base encoder; returns the [N, S, d_model] sequence output.

    ``input_mask``: float [N, S] (1 = token, 0 = pad), the ``Mask``
    input of every layer's fused attention op."""
    if not fused_attention:
        raise NotImplementedError("only the fused attention build of bert_encoder is ported yet")
    _no_dropout(dropout_rate)
    x = _embeddings(src_ids, vocab_size, d_model, max_pos, seq_len, name, sent_ids, 2)
    x = layers.layer_norm(
        x,
        begin_norm_axis=2,
        param_attr=ParamAttr(name=name + "_emb_ln_scale"),
        bias_attr=ParamAttr(name=name + "_emb_ln_bias"),
    )
    for i in range(n_layer):
        x = encoder_layer(
            x, d_model, n_head, d_inner, None, dropout_rate, is_test,
            name="%s_enc_%d" % (name, i), fused=True, mask=input_mask,
        )
    return x


def bert_pretrain(
    src_ids,
    sent_ids,
    input_mask,
    mask_pos,
    mask_labels,
    nsp_labels,
    vocab_size: int = 30522,
    d_model: int = 768,
    n_layer: int = 12,
    n_head: int = 12,
    d_inner: int = 3072,
    max_pos: int = 512,
    seq_len: int = 128,
    dropout_rate: float = 0.1,
    is_test: bool = False,
    name: str = "bert",
    fused_attention: bool = False,
):
    """BERT pretraining objective: masked-LM + next-sentence prediction
    (the original BERT recipe's heads over ``bert_encoder``).

    src_ids/sent_ids: int64 [N, S]; input_mask: float [N, S];
    mask_pos: int64 [N*M, 1] FLATTENED positions into [N*S];
    mask_labels: int64 [N*M, 1]; nsp_labels: int64 [N, 1].
    Returns (total_loss, mlm_loss, nsp_acc).
    """
    enc = bert_encoder(
        src_ids, input_mask, sent_ids, vocab_size, d_model, n_layer, n_head,
        d_inner, max_pos, seq_len, dropout_rate, is_test, name,
        fused_attention=fused_attention,
    )  # [N, S, D]

    # ---- masked LM head over gathered positions
    flat = layers.reshape(enc, shape=[-1, d_model])          # [N*S, D]
    picked = layers.gather(flat, layers.reshape(mask_pos, shape=[-1]))  # [N*M, D]
    trans = _fc3(picked, d_model, name + "_mlm_trans", num_flatten_dims=1, act="gelu")
    trans = layers.layer_norm(
        trans, begin_norm_axis=1,
        param_attr=ParamAttr(name=name + "_mlm_ln_scale"),
        bias_attr=ParamAttr(name=name + "_mlm_ln_bias"),
    )
    # output projection TIED to the word embedding (original BERT recipe)
    word_emb = enc.block.program.global_block().var(name + "_word_emb")
    mlm_logits = layers.matmul(trans, word_emb, transpose_y=True)  # [N*M, V]
    mlm_bias = layers.create_parameter([vocab_size], "float32",
                                       name=name + "_mlm_out_b", is_bias=True)
    mlm_logits = mlm_logits + mlm_bias
    mlm_loss = layers.mean(layers.softmax_with_cross_entropy(mlm_logits, mask_labels))

    # ---- next-sentence head on the [CLS] (first) token
    first = layers.slice(enc, axes=[1], starts=[0], ends=[1])   # [N, 1, D]
    pooled = _fc3(layers.reshape(first, shape=[-1, d_model]), d_model,
                  name + "_pool", num_flatten_dims=1, act="tanh")
    nsp_logits = _fc3(pooled, 2, name + "_nsp", num_flatten_dims=1)
    nsp_loss = layers.mean(layers.softmax_with_cross_entropy(nsp_logits, nsp_labels))
    nsp_acc = layers.accuracy(nsp_logits, nsp_labels)

    total = mlm_loss + nsp_loss
    return total, mlm_loss, nsp_acc
