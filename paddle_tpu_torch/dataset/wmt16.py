"""WMT16 en-de NMT readers (reference: python/paddle/dataset/wmt16.py).

Samples: (src ids int64 seq, trg ids int64 seq, trg_next ids int64 seq)
with <s>=0, <e>=1, <unk>=2 conventions like the reference.  Synthetic:
target is a deterministic per-token mapping of the source (learnable by
a seq2seq model — the copy-task family used in tests/book NMT).
"""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "validation", "get_dict"]

BOS, EOS, UNK = 0, 1, 2


def get_dict(lang: str, dict_size: int = 10000, reverse: bool = False):
    d = {i: i for i in range(dict_size)}
    return d


def _reader(n, seed, src_dict_size, trg_dict_size):
    def reader():
        rng = np.random.RandomState(seed)
        lo = 3
        for _ in range(n):
            length = int(rng.randint(4, 16))
            src = rng.randint(lo, src_dict_size, length).astype("int64")
            # deterministic token mapping -> learnable translation
            trg_body = ((src * 7 + 13) % (trg_dict_size - lo) + lo).astype("int64")
            trg = np.concatenate([[BOS], trg_body]).astype("int64")
            trg_next = np.concatenate([trg_body, [EOS]]).astype("int64")
            yield src, trg, trg_next

    return reader


def train(src_dict_size=10000, trg_dict_size=10000, src_lang="en", size=2048):
    return _reader(size, 0, src_dict_size, trg_dict_size)


def test(src_dict_size=10000, trg_dict_size=10000, src_lang="en", size=256):
    return _reader(size, 1, src_dict_size, trg_dict_size)


def validation(src_dict_size=10000, trg_dict_size=10000, src_lang="en", size=256):
    return _reader(size, 2, src_dict_size, trg_dict_size)
