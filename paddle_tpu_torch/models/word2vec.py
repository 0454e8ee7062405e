"""word2vec (skip-gram-ish N-gram LM) — reference book test:
python/paddle/fluid/tests/book/test_word2vec.py.
"""
from __future__ import annotations

from paddle_tpu_torch import layers
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["word2vec_ngram"]


def word2vec_ngram(word_ids, next_word, dict_size: int, embed_size: int = 32, hidden_size: int = 256):
    """N-gram next-word predictor; ``word_ids`` is a list of int64 [N, 1]
    context-word vars sharing one embedding table.  Returns (avg_loss,
    prediction)."""
    embeds = [
        layers.embedding(
            w,
            size=[dict_size, embed_size],
            param_attr=ParamAttr(name="shared_w"),
        )
        for w in word_ids
    ]
    concat = layers.concat(embeds, axis=-1)
    hidden = layers.fc(concat, size=hidden_size, act="sigmoid")
    prediction = layers.fc(hidden, size=dict_size, act="softmax")
    loss = layers.cross_entropy(prediction, next_word)
    return layers.mean(loss), prediction
