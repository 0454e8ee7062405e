"""UCI housing readers (reference: python/paddle/dataset/uci_housing.py).

Samples: (features float32[13], price float32[1]).  Synthetic mode: a
fixed random linear model + noise, so fit-a-line style tests converge.
"""
from __future__ import annotations

import numpy as np


def _make(n, seed):
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(7).uniform(-1, 1, (13, 1)).astype("float32")
    x = rng.uniform(-1, 1, (n, 13)).astype("float32")
    y = x @ w + rng.normal(0, 0.1, (n, 1)).astype("float32")
    return x, y.astype("float32")


def _reader(n, seed):
    def reader():
        x, y = _make(n, seed)
        for i in range(n):
            yield x[i], y[i]

    return reader


def train(size: int = 404):
    return _reader(size, seed=0)


def test(size: int = 102):
    return _reader(size, seed=1)
