"""IMDB sentiment readers (reference: python/paddle/dataset/imdb.py).

Samples: (word-id int64 sequence of variable length, label int64 {0,1}).
Synthetic: two token distributions (positive/negative vocab halves bias)
— learnable by bag-of-embeddings models; sequences are variable length to
exercise the padded+length LoD path.
"""
from __future__ import annotations

import numpy as np

VOCAB_SIZE = 5147  # reference's imdb.word_dict() size ballpark


def word_dict():
    return {i: i for i in range(VOCAB_SIZE)}


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            label = int(rng.randint(0, 2))
            length = int(rng.randint(8, 64))
            half = VOCAB_SIZE // 2
            bias_lo = 0 if label == 0 else half
            ids = np.where(
                rng.uniform(size=length) < 0.7,
                rng.randint(bias_lo, bias_lo + half, length),
                rng.randint(0, VOCAB_SIZE, length),
            ).astype("int64")
            yield ids, label

    return reader


def train(word_idx=None, size: int = 1024):
    return _reader(size, seed=0)


def test(word_idx=None, size: int = 256):
    return _reader(size, seed=1)
