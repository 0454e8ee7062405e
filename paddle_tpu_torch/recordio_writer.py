"""recordio_writer shim (reference: python/paddle/fluid/recordio_writer.py
— convert_reader_to_recordio_file over the C++ RecordIOWriter).  The
native chunked/CRC writer lives in native/ (recordio.cc); records are the
serialized per-sample feature lists the MultiSlot DataFeed parses."""
from __future__ import annotations

import contextlib

import numpy as np

from paddle_tpu_torch import native

__all__ = ["convert_reader_to_recordio_file", "convert_reader_to_recordio_files"]


def _serialize_sample(sample) -> bytes:
    parts = []
    for slot in sample:
        arr = np.asarray(slot)
        flat = " ".join(str(v) for v in arr.reshape(-1).tolist())
        parts.append("%d %s" % (arr.size, flat))
    return (" ".join(parts)).encode()


def convert_reader_to_recordio_file(filename, reader_creator, compressor=None,
                                    max_num_records=1000, feed_order=None,
                                    feeder=None):
    """Write every sample from ``reader_creator()`` into one recordio
    file; returns the record count."""
    writer = native.RecordIOWriter(filename)
    n = 0
    for sample in reader_creator():
        writer.write(_serialize_sample(sample))
        n += 1
    writer.close()
    return n


def convert_reader_to_recordio_files(filename, batch_per_file, reader_creator,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None, feeder=None):
    """Shard the reader across multiple recordio files."""
    counts = []
    writer = None
    idx = 0
    n_in_file = 0
    for sample in reader_creator():
        if writer is None:
            writer = native.RecordIOWriter("%s-%05d" % (filename, idx))
        writer.write(_serialize_sample(sample))
        n_in_file += 1
        if n_in_file >= batch_per_file:
            writer.close()
            counts.append(n_in_file)
            writer, n_in_file, idx = None, 0, idx + 1
    if writer is not None:
        writer.close()
        counts.append(n_in_file)
    return counts
