"""WMT14 fr-en readers (reference: python/paddle/dataset/wmt14.py) —
same sample contract as wmt16 ((src, trg, trg_next) id sequences)."""
from __future__ import annotations

from paddle_tpu_torch.dataset import wmt16 as _w16

__all__ = ["train", "test"]


def train(dict_size=30000, size=2048):
    return _w16._reader(size, 10, dict_size, dict_size)


def test(dict_size=30000, size=256):
    return _w16._reader(size, 11, dict_size, dict_size)
