"""PASCAL VOC2012 segmentation readers (reference:
python/paddle/dataset/voc2012.py).

Samples: (image float32 [3, H, W], segmentation mask int32 [H, W] with
class ids 0..20 and 255=ignore).  Synthetic: rectangular object blobs on
background — enough structure for a tiny FCN to overfit.
"""
from __future__ import annotations

import numpy as np

__all__ = ["train", "test", "val"]

N_CLASSES = 21
_H = _W = 96


def _reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            img = rng.normal(0, 0.25, (3, _H, _W)).astype("float32")
            mask = np.zeros((_H, _W), np.int32)
            for _obj in range(int(rng.randint(1, 4))):
                cls = int(rng.randint(1, N_CLASSES))
                y0, x0 = rng.randint(0, _H - 16), rng.randint(0, _W - 16)
                hh, ww = rng.randint(8, 16), rng.randint(8, 16)
                mask[y0 : y0 + hh, x0 : x0 + ww] = cls
                img[:, y0 : y0 + hh, x0 : x0 + ww] += cls / N_CLASSES - 0.5
            yield img, mask

    return reader


def train(size: int = 256):
    return _reader(size, 0)


def test(size: int = 64):
    return _reader(size, 1)


def val(size: int = 64):
    return _reader(size, 2)
