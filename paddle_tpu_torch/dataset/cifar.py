"""CIFAR readers (reference: python/paddle/dataset/cifar.py).

Samples: (image float32[3072] in [0,1], label int64).  Synthetic:
class-conditional colored-noise blobs.
"""
from __future__ import annotations

import numpy as np


def _synthetic(n, classes, seed):
    rng = np.random.RandomState(seed)
    centers = np.random.RandomState(99).uniform(0.2, 0.8, (classes, 3072)).astype("float32")
    labels = rng.randint(0, classes, n).astype("int64")
    imgs = centers[labels] + rng.normal(0, 0.15, (n, 3072)).astype("float32")
    return np.clip(imgs, 0, 1).astype("float32"), labels


def _reader(n, classes, seed):
    def reader():
        imgs, labels = _synthetic(n, classes, seed)
        for i in range(n):
            yield imgs[i], int(labels[i])

    return reader


def train10(size: int = 1024):
    return _reader(size, 10, seed=0)


def test10(size: int = 256):
    return _reader(size, 10, seed=1)


def train100(size: int = 1024):
    return _reader(size, 100, seed=0)


def test100(size: int = 256):
    return _reader(size, 100, seed=1)
