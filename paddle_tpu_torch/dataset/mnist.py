"""MNIST readers (reference: python/paddle/dataset/mnist.py).

Samples: (image float32[784] in [-1,1], label int64 scalar).
Synthetic mode: class-conditional Gaussian blobs — linearly separable
enough that LeNet/MLP book tests show decreasing loss and >chance
accuracy, deterministic per (split, seed).
"""
from __future__ import annotations

import os

import numpy as np

TRAIN_SIZE = 60000
TEST_SIZE = 10000


def _load_real(split):
    home = os.environ.get("PADDLE_TPU_DATA_HOME")
    if not home:
        return None
    path = os.path.join(home, "mnist", split + ".npz")
    if not os.path.exists(path):
        return None
    d = np.load(path)
    return d["images"], d["labels"]


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    centers = np.random.RandomState(1234).uniform(-0.6, 0.6, (10, 784)).astype("float32")
    labels = rng.randint(0, 10, n).astype("int64")
    imgs = centers[labels] + rng.normal(0, 0.35, (n, 784)).astype("float32")
    return np.clip(imgs, -1, 1).astype("float32"), labels


def _reader(split, n, seed):
    def reader():
        real = _load_real(split)
        if real is not None:
            imgs, labels = real
        else:
            imgs, labels = _synthetic(n, seed)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])

    return reader


def train(size: int = 2048):
    return _reader("train", min(size, TRAIN_SIZE), seed=0)


def test(size: int = 512):
    return _reader("test", min(size, TEST_SIZE), seed=1)
