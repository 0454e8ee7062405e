"""Oxford-102 flowers readers (reference: python/paddle/dataset/flowers.py).

Samples: (image float32 [3, 224, 224] normalized, label int64 [0, 102)).
Synthetic: class-conditioned color/texture statistics (learnable by a
small CNN).
"""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "valid"]

N_CLASSES = 102


def _reader(n, seed, use_xmap=True):
    def reader():
        rng = np.random.RandomState(seed)
        means = np.random.RandomState(77).uniform(-0.8, 0.8, (N_CLASSES, 3))
        for _ in range(n):
            label = int(rng.randint(0, N_CLASSES))
            img = rng.normal(0.0, 0.3, (3, 224, 224)).astype("float32")
            img += means[label][:, None, None]
            yield img.astype("float32"), label

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True, size: int = 512):
    return _reader(size, 0)


def test(mapper=None, buffered_size=1024, use_xmap=True, size: int = 128):
    return _reader(size, 1)


def valid(mapper=None, buffered_size=1024, use_xmap=True, size: int = 128):
    return _reader(size, 2)
