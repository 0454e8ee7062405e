"""DataFeeder: sample lists -> feed dicts.

Port of the JAX package's ``data_feeder.py`` (reference:
python/paddle/fluid/data_feeder.py, which converts reader output tuples
into LoDTensor feed dicts).  It produces numpy batches: dense vars are
stacked (and reshaped to the declared shape where the sample is flat);
a ragged var (``lod_level`` > 0) is padded to its longest sample with a
companion ``<name>_seq_len`` int32 vector, the padded + length encoding
of the JAX package's sequence ops.

A dense batch whose rank differs from the var's is reshaped to the
var's shape with its -1 dim inferred, and one that does not fit raises,
as the reference's ``DataToLoDTensorConverter.done`` does.  (The JAX
package sets -1 to the number of samples and leaves a batch that does
not fit unreshaped.)  So a sample may carry several rows of a var
declared ``[-1, 1]``, as BERT's masked positions are: 32 samples of
``[19, 1]`` feed ``[608, 1]``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from paddle_tpu_torch.core import types as core_types

__all__ = ["DataFeeder"]


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars = list(feed_list)
        self.place = place

    def feed(self, iterable) -> dict:
        """iterable: list of sample tuples, one entry per feed var."""
        cols = list(zip(*iterable))
        if len(cols) != len(self.feed_vars):
            raise ValueError("sample width %d != #feed vars %d" % (len(cols), len(self.feed_vars)))
        out = {}
        for var, col in zip(self.feed_vars, cols):
            dtype = core_types.np_dtype(var.dtype)
            arrs = [np.asarray(c) for c in col]
            if var.lod_level and var.lod_level > 0:
                # ragged: pad to max length, emit companion length vector
                lens = np.array([a.shape[0] for a in arrs], dtype="int32")
                maxlen = int(lens.max()) if len(lens) else 0
                trailing = arrs[0].shape[1:] if arrs else ()
                padded = np.zeros((len(arrs), maxlen) + tuple(trailing), dtype=dtype)
                for i, a in enumerate(arrs):
                    padded[i, : a.shape[0]] = a
                out[var.name] = padded
                out[var.name + "_seq_len"] = lens
            else:
                batch = np.stack(arrs).astype(dtype)
                want = var.shape
                if (want is not None and len(batch.shape) != len(want)
                        and sum(s < 0 for s in want) <= 1):
                    try:
                        batch = batch.reshape(want)
                    except ValueError:
                        raise ValueError(
                            "feed var %r is declared %s; its batch of %s does not fit"
                            % (var.name, list(want), list(batch.shape))) from None
                out[var.name] = batch
        return out
