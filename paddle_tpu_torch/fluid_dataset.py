"""Dataset pipeline for the trainer runtime (CTR-style slot data).

The port's own copy of the JAX package's ``fluid_dataset.py``
(reference: python/paddle/fluid/dataset.py (DatasetFactory:21,
InMemoryDataset:269, QueueDataset:575) over the C++ MultiSlot data feed,
paddle/fluid/framework/data_feed.cc, data_set.cc).  The parse hot loop
runs in C++ (``paddle_tpu_torch/native/`` multislot_parse); a slot of a
``lod_level`` var becomes the padded + length encoding, a dense slot a
``[batch, -1]`` array in its var's numpy dtype (``core/types.py``).

Usage (reference style):

    dataset = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    dataset.set_use_var([ids_var, label_var])
    dataset.set_batch_size(32)
    dataset.set_filelist(["part-0", "part-1"])
    dataset.load_into_memory()
    dataset.global_shuffle()
    exe.train_from_dataset(program, dataset, fetch_list=[loss])
"""
from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from paddle_tpu_torch import native
from paddle_tpu_torch.core import types as core_types

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


class DatasetFactory:
    """reference: dataset.py:21."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        if datafeed_class == "InMemoryDataset":
            return InMemoryDataset()
        if datafeed_class == "QueueDataset":
            return QueueDataset()
        raise ValueError("unknown dataset class %r" % datafeed_class)


class DatasetBase:
    def __init__(self):
        self._batch_size = 1
        self._use_vars = []
        self._filelist: List[str] = []
        self._thread_num = 1
        self._pipe_command = "cat"
        self._hdfs_config = None

    # --- reference config surface ---
    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_use_var(self, var_list: Sequence):
        self._use_vars = list(var_list)

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)

    def set_thread(self, thread_num: int):
        self._thread_num = thread_num

    def set_pipe_command(self, pipe_command: str):
        self._pipe_command = pipe_command  # preprocessing pipes are N/A here

    def set_hdfs_config(self, fs_name, fs_ugi):
        self._hdfs_config = (fs_name, fs_ugi)

    # --- parsing ---
    def _parse_file(self, path: str):
        """One file -> per-slot (values, counts) via the native parser."""
        with open(path, "rb") as f:
            text = f.read()
        n_lines, slots = native.parse_multislot(text, len(self._use_vars))
        return n_lines, slots

    def _batches_from(self, lines) -> Iterator[Dict[str, np.ndarray]]:
        """lines: list of per-line samples [(slot values list) per slot]."""
        bs = self._batch_size
        for start in range(0, len(lines) - len(lines) % bs, bs):
            chunk = lines[start : start + bs]
            feed = {}
            for si, var in enumerate(self._use_vars):
                dtype = core_types.np_dtype(var.dtype)
                rows = [ln[si] for ln in chunk]
                lens = np.array([len(r) for r in rows], np.int32)
                width = int(lens.max()) if len(lens) else 0
                if getattr(var, "lod_level", 0) and var.lod_level > 0:
                    padded = np.zeros((bs, width), dtype)
                    for i, r in enumerate(rows):
                        padded[i, : len(r)] = np.asarray(r, dtype)
                    feed[var.name] = padded
                    feed[var.name + "_seq_len"] = lens
                else:
                    feed[var.name] = np.asarray(rows, dtype).reshape(bs, -1)
            yield feed

    @staticmethod
    def _to_lines(n_lines, slots):
        lines = []
        offs = [0] * len(slots)
        for i in range(n_lines):
            row = []
            for si, (values, counts) in enumerate(slots):
                n = int(counts[i])
                row.append(values[offs[si] : offs[si] + n])
                offs[si] += n
            lines.append(row)
        return lines


class InMemoryDataset(DatasetBase):
    """reference: dataset.py:269."""

    def __init__(self):
        super().__init__()
        self._lines = []

    def load_into_memory(self):
        self._lines = []
        for path in self._filelist:
            n, slots = self._parse_file(path)
            self._lines.extend(self._to_lines(n, slots))

    def local_shuffle(self, seed: Optional[int] = None):
        random.Random(seed).shuffle(self._lines)

    def global_shuffle(self, fleet=None, seed: Optional[int] = None):
        """With a fleet handle the reference shuffles across trainers; here
        files are sharded per worker, so a local shuffle of this worker's
        lines is the equivalent step."""
        self.local_shuffle(seed)

    def release_memory(self):
        self._lines = []

    def get_memory_data_size(self, fleet=None):
        return len(self._lines)

    def __iter__(self):
        return self._batches_from(self._lines)


class QueueDataset(DatasetBase):
    """reference: dataset.py:575 — streaming, file at a time."""

    def __iter__(self):
        for path in self._filelist:
            n, slots = self._parse_file(path)
            yield from self._batches_from(self._to_lines(n, slots))
