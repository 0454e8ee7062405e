"""Batch-dim shape bucketing (own copy of the JAX package's ``serving/bucketing.py``).

The coalesced batch is padded up to a fixed ladder of sizes
(1/2/4/.../max by default), so the set of batch shapes the predictor
sees is closed and finite and ``warmup()`` can run every one of them
before traffic arrives.  On the JAX package each new shape is an XLA
compile; here it is the first launch of each kernel at that shape.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BucketPolicy"]


class BucketPolicy:
    """Pads the batch dim up to a fixed ladder of sizes.

    ``ladder`` defaults to the powers of two up to ``max_batch_size``,
    with ``max_batch_size`` itself appended when it is not a power of
    two — e.g. max 12 -> (1, 2, 4, 8, 12).
    """

    def __init__(self, max_batch_size: int, ladder: Optional[Sequence[int]] = None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1, got %r" % max_batch_size)
        if ladder is None:
            ladder = []
            b = 1
            while b < max_batch_size:
                ladder.append(b)
                b *= 2
            ladder.append(max_batch_size)
        ladder = sorted(set(int(b) for b in ladder))
        if not ladder or ladder[0] < 1:
            raise ValueError("bucket ladder must be positive, got %r" % (ladder,))
        if ladder[-1] != max_batch_size:
            raise ValueError(
                "bucket ladder %r must top out at max_batch_size=%d"
                % (ladder, max_batch_size))
        self.max_batch_size = int(max_batch_size)
        self.ladder: List[int] = ladder

    def bucket_for(self, n: int) -> int:
        """Smallest ladder rung >= n."""
        if not 0 < n <= self.max_batch_size:
            raise ValueError(
                "batch of %d rows does not fit the ladder (max %d)"
                % (n, self.max_batch_size))
        for b in self.ladder:
            if b >= n:
                return b
        raise AssertionError("unreachable: ladder tops at max_batch_size")

    def pad_feed(self, feed: Dict[str, np.ndarray], bucket: int) -> Dict[str, np.ndarray]:
        """Pad every feed array's leading dim up to ``bucket`` by
        repeating the last real row — a REAL row, so padding can never
        introduce out-of-range values (e.g. embedding ids) that a
        zeros-pad could; padded rows are computed and discarded
        (AnalysisPredictor.run_padded slices them off)."""
        out = {}
        for name, arr in feed.items():
            arr = np.asarray(arr)
            n = arr.shape[0]
            if n > bucket:
                raise ValueError(
                    "feed %r has %d rows > bucket %d" % (name, n, bucket))
            if n < bucket:
                pad = np.repeat(arr[-1:], bucket - n, axis=0)
                arr = np.concatenate([arr, pad], axis=0)
            out[name] = arr
        return out
