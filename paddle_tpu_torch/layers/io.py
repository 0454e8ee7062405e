"""Input layers (reference: python/paddle/fluid/layers/io.py, data:41):
``data``, the reader layers over the port's ``reader.py`` (an iterable
``PyReader`` and the decorator forms), and ``load``.  The reference's
file-reader op family (``read_file``, ``open_files``,
``random_data_generator``, ``Preprocessor``) raises, as in the JAX
package: readers feed the step from the host."""
from __future__ import annotations

from paddle_tpu_torch import framework
from paddle_tpu_torch.core import types as core_types

__all__ = ["data", "py_reader", "create_py_reader_by_data", "batch", "shuffle", "double_buffer",
           "load", "read_file", "open_files", "random_data_generator", "Preprocessor"]


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True, stop_gradient=True, **kwargs):
    """Declare an input variable (reference: layers/io.py:41).
    ``append_batch_size`` prepends -1.  A ragged input (``lod_level > 0``)
    is padded, with a companion ``<name>_seq_len`` int32 var of its
    lengths (what ``DataFeeder`` feeds), and for nested levels
    ``<name>_inner_len`` (level 1) and ``<name>_inner_len_<k>`` of shape
    [B, S1..Sk], as in the JAX package."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = framework.default_main_program().current_block()
    var = block.create_var(
        name=name,
        shape=shape,
        dtype=core_types.canonical_dtype(dtype),
        stop_gradient=stop_gradient,
        is_data=True,
        lod_level=lod_level,
    )
    if lod_level > 0:
        block.create_var(name=name + "_seq_len", shape=[-1], dtype="int32",
                         stop_gradient=True, is_data=True)
    for level in range(1, lod_level):
        suffix = "_inner_len" if level == 1 else "_inner_len_%d" % level
        block.create_var(name=name + suffix, shape=[-1] * (level + 1), dtype="int32",
                         stop_gradient=True, is_data=True)
    return var


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None, use_double_buffer=True):
    """reference: layers/io.py py_reader.  An iterable ``PyReader`` with no
    feed vars, as the JAX package returns: decorate it with a batch
    generator of feed dicts."""
    from paddle_tpu_torch import reader as reader_mod

    return reader_mod.PyReader(feed_list=None, capacity=capacity,
                               use_double_buffer=use_double_buffer, iterable=True)


def create_py_reader_by_data(capacity, feed_list, name=None, use_double_buffer=True):
    """reference: layers/io.py create_py_reader_by_data: an iterable
    ``PyReader`` over ``feed_list``."""
    from paddle_tpu_torch import reader as reader_mod

    return reader_mod.PyReader(feed_list=feed_list, capacity=capacity,
                               use_double_buffer=use_double_buffer, iterable=True)


def batch(reader, batch_size, drop_last=False):
    from paddle_tpu_torch import reader as reader_mod

    return reader_mod.batch(reader, batch_size, drop_last)


def shuffle(reader, buffer_size):
    from paddle_tpu_torch import reader as reader_mod

    return reader_mod.shuffle(reader, buffer_size)


def double_buffer(reader, place=None, name=None):
    """The reader itself: ``PyReader(use_double_buffer=True)`` stages the
    batches on the card ahead of the step."""
    return reader


def load(out, file_path, load_as_fp16=None):
    """reference: layers/io.py load: a ``load`` op that fills ``out`` from
    a ``save_vars`` file."""
    from paddle_tpu_torch.layer_helper import LayerHelper

    LayerHelper("load").append_op(type="load", inputs={}, outputs={"Out": [out]},
                                  attrs={"file_path": file_path})
    return out


def read_file(reader):
    raise NotImplementedError(
        "read_file: use paddle_tpu_torch.reader readers or DatasetFactory "
        "(the input path is host-side, reader.py)")


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=None, buffer_size=None,
               pass_num=1, is_test=None):
    raise NotImplementedError(
        "open_files: use DatasetFactory (fluid_dataset.py) or the paddle_tpu_torch.reader "
        "file readers")


def random_data_generator(low, high, shapes, lod_levels, for_parallel=True):
    raise NotImplementedError(
        "random_data_generator: feed numpy batches or use "
        "layers.uniform_random_batch_size_like inside the program")


class Preprocessor:
    """reference: layers/io.py Preprocessor: preprocess in the host reader
    (reader.py) instead."""

    def __init__(self, reader, name=None):
        raise NotImplementedError(
            "Preprocessor: preprocess in the host reader (reader.py)")
