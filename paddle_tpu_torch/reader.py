"""Input pipeline: PyReader and the composable reader decorators.

Port of the JAX package's ``reader.py`` (reference:
python/paddle/fluid/reader.py:47, PyReader over a blocking queue and the
reader/double_buffer prefetch; python/paddle/reader/decorator.py, the
decorators).

``device_buffered`` is the double buffer: a bounded producer thread
(``_Prefetcher``) stages each batch on the card ahead of the step that
reads it.  The thread copies the batch from pinned host memory with
``non_blocking=True`` on a CUDA stream of its own and records an event;
when the consumer takes the batch, its current stream waits on that
event and each tensor is ``record_stream``-ed on it, so the allocator
keeps the memory until the consumer's work is done.  The executor takes
such tensors as feeds where they lie (no trip through the host).

``device="auto"`` means ``cuda:0`` and raises when there is no card;
host staging happens only when the caller asks for it (``device=None``
or ``"cpu"``).  The sharded mode (``compiled=``: each replica's slice in
its own memory) comes with ROADMAP A10 part 4 (the sharded prefetch).
"""
from __future__ import annotations

import itertools
import queue
import random
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import framework
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.data_feeder import DataFeeder
from paddle_tpu_torch.monitor import registry as _mon_registry

# pipeline health counters: a consumer stall means the training loop
# outran the input pipeline (the batch was not staged when asked for);
# a producer stall is backpressure (the pipeline outran the consumer,
# the healthy direction)
_MON_CONSUMER_STALLS = _mon_registry.REGISTRY.counter(
    "reader_consumer_stalls_total",
    "consumer blocked on an empty prefetch queue (pipeline starved)")
_MON_CONSUMER_STALL_S = _mon_registry.REGISTRY.counter(
    "reader_consumer_stall_seconds_total",
    "seconds the consumer spent waiting on an empty prefetch queue")
_MON_PRODUCER_STALLS = _mon_registry.REGISTRY.counter(
    "reader_producer_stalls_total",
    "producer blocked on a full prefetch queue (backpressure)")
_MON_PRODUCER_STALL_S = _mon_registry.REGISTRY.counter(
    "reader_producer_stall_seconds_total",
    "seconds the producer spent waiting on a full prefetch queue")

__all__ = [
    "PyReader",
    "DataLoader",
    "shuffle",
    "batch",
    "buffered",
    "device_buffered",
    "map_readers",
    "chain",
    "compose",
    "ComposeNotAligned",
    "firstn",
    "cache",
    "xmap_readers",
    "Fake",
    "PipeReader",
]


# ---------------------------------------------------------------------------
# Bounded background prefetch with clean shutdown
# ---------------------------------------------------------------------------
_END = object()  # producer-done sentinel

# how often a blocked producer re-checks the stop flag; bounds both the
# shutdown latency and the cost of a consumer that vanished without close()
_STOP_POLL_S = 0.05


class _Prefetcher:
    """One producer thread filling a bounded queue, one consumer.

    The producer thread terminates in every exit mode: source exhausted
    (sentinel), producer exception (re-raised in the consumer), or
    consumer gone (``close()`` sets the stop flag; a blocked ``put``
    polls it).  ``transform`` runs in the producer thread: this is where
    ``device_buffered`` stages batches on the card, overlapping the copy
    with the consumer's compute."""

    def __init__(self, source, size: int, transform: Optional[Callable] = None,
                 name: str = "ptpu-prefetch"):
        self._source = source
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(size)))
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._finished = False
        self._thread = threading.Thread(target=self._fill, name=name, daemon=True)
        self._thread.start()

    # --- producer side ---
    def _put(self, item) -> bool:
        """Enqueue; returns False when the consumer closed us."""
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            pass
        _MON_PRODUCER_STALLS.inc()
        t0 = time.perf_counter()
        try:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=_STOP_POLL_S)
                    return True
                except queue.Full:
                    continue
            return False
        finally:
            _MON_PRODUCER_STALL_S.inc(time.perf_counter() - t0)

    def _fill(self) -> None:
        try:
            src = self._source() if callable(self._source) else self._source
            for item in src:
                if _faults.active is not None:  # disarmed: one is-None gate
                    # prefetch-thread death: the injected error rides the
                    # existing producer-exception channel — surfaced
                    # TYPED in the consumer, thread terminates cleanly
                    _faults.active.faultpoint("reader.prefetch")
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return  # closed by the consumer
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            self._exc = e
        finally:
            if not self._stop.is_set():
                self._put(_END)

    # --- consumer side ---
    def __iter__(self):
        return self

    # hot-path: begin prefetch_next (consumer pop — the batch must already be staged)
    def __next__(self):
        if self._finished:
            raise StopIteration
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            _MON_CONSUMER_STALLS.inc()
            t0 = time.perf_counter()
            item = self._q.get()  # the producer's finally guarantees _END
            _MON_CONSUMER_STALL_S.inc(time.perf_counter() - t0)
        if item is _END:
            self._finished = True
            self._thread.join(timeout=5.0)
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item
    # hot-path: end prefetch_next

    def close(self) -> None:
        """Stop the producer and release its thread.  Idempotent; safe
        to call with items still queued (they are dropped)."""
        self._finished = True
        self._stop.set()
        # drain so a producer blocked in put() frees immediately rather
        # than waiting out a poll interval
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


# ---------------------------------------------------------------------------
# Reader decorators (reference: python/paddle/reader/decorator.py)
# ---------------------------------------------------------------------------
def shuffle(reader, buf_size: int, seed: Optional[int] = None):
    def reader_():
        rng = random.Random(seed)
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        rng.shuffle(buf)
        yield from buf

    return reader_


def batch(reader, batch_size: int, drop_last: bool = False):
    def reader_():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return reader_


def buffered(reader, size: int):
    """Prefetch into a bounded queue on a background thread.  The
    producer terminates when the consumer stops early (see _Prefetcher)."""

    def reader_():
        p = _Prefetcher(reader, size)
        try:
            yield from p
        finally:
            p.close()

    return reader_


def _stack_group(group):
    """Assemble one per_step_feed chunk: stack a group of batches on a
    new leading ``steps`` axis.  Supports dict batches (name -> array),
    sequence batches (positional arrays), and bare arrays."""
    first = group[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(b[k]) for b in group]) for k in first}
    if isinstance(first, (list, tuple)):
        return [np.stack([np.asarray(b[i]) for b in group]) for i in range(len(first))]
    return np.stack([np.asarray(b) for b in group])


def _tree_map(item, fn):
    """``fn`` over every array of a dict, sequence or bare batch."""
    if isinstance(item, dict):
        return {k: fn(v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return [fn(v) for v in item]
    return fn(item)


def _leaves(item):
    if isinstance(item, dict):
        return list(item.values())
    if isinstance(item, (list, tuple)):
        return list(item)
    return [item]


def _staging_device(device) -> Optional[torch.device]:
    """Where ``device_buffered`` stages: a CUDA device, or None for host
    staging (``None``, ``"cpu"``, ``CPUPlace()``).  ``"auto"`` is
    ``cuda:0``, and like every CUDA choice raises without such a card."""
    if device is None:
        return None
    if device == "auto":
        place = framework.CUDAPlace(0)
    elif isinstance(device, framework.Place):
        place = device
    else:
        dev = torch.device(device)
        if dev.type == "cpu":
            return None
        if dev.type != "cuda":
            raise ValueError("device_buffered stages on a CUDA device or the host, not %s" % dev)
        place = framework.CUDAPlace(dev.index or 0)
    dev = framework.device_of(place)
    return dev if dev.type == "cuda" else None


class _CudaStager:
    """Stages host batches on one card from the producer thread: each
    array is pinned and copied with ``non_blocking=True`` on a stream of
    the stager's own, and an event marks the copy's end.  ``ready`` (on
    the consumer's thread) makes the consumer's current stream wait on
    that event and records the tensors on it.  A dict batch's entries
    named in ``host_names`` stay as they came."""

    def __init__(self, device: torch.device, host_names=()):
        self.device = device
        self._host = frozenset(host_names)
        self._stream: Optional[torch.cuda.Stream] = None

    def _put(self, a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def __call__(self, item):
        if self._stream is None:  # first batch, on the producer thread
            torch.cuda.set_device(self.device)
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            if isinstance(item, dict):
                staged = {k: v if k in self._host else self._put(v) for k, v in item.items()}
            else:
                staged = _tree_map(item, self._put)
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def ready(self, staged_event):
        staged, event = staged_event
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in _leaves(staged):
            if isinstance(t, torch.Tensor) and t.device == self.device:
                t.record_stream(stream)
        return staged


def device_buffered(reader, size: int = 2, device="auto", steps: Optional[int] = None,
                    drop_last: bool = True, compiled=None,
                    feed_names: Optional[Sequence[str]] = None,
                    host_names: Sequence[str] = ()):
    """Device-side prefetch: a bounded background thread that stages
    batches on the card ahead of the consumer, so feeds arrive as CUDA
    tensors and ``Executor.run`` takes them where they lie (the
    reference's reader/double_buffer, operators/reader/buffered_reader.cc).

    ``reader``: a reader callable or an iterable of batches (dicts,
    sequences, or bare arrays).  ``device="auto"`` (default) is
    ``cuda:0`` and raises without a card; pass a device or place to pin,
    or ``None``/``"cpu"`` to prefetch host-side (batches stay numpy).
    ``steps=N`` assembles per_step_feed chunks: N consecutive batches
    stacked on a new leading axis, matching ``Executor.run(steps=N,
    per_step_feed=True)``; a ragged tail of fewer than N batches is
    dropped unless ``drop_last=False``.  ``compiled`` (the sharded mode)
    raises until the multi-device slice; ``feed_names`` belongs to it.
    ``host_names``: names in a dict batch that stay on the host, as they
    came (the ids a distributed table expands on the host every batch).

    Stalls count into the registry's reader counters; the producer
    thread shuts down when the consumer exits early (break/exception).
    """
    if compiled is not None:
        raise NotImplementedError(
            "device_buffered(compiled=...) stages each replica's slice on its own device; "
            "the sharded prefetch (ROADMAP A10 part 4) is not ported to paddle_tpu_torch yet")
    dev = _staging_device(device)

    def reader_():
        def source():
            it = iter(reader() if callable(reader) else reader)
            if steps is None:
                yield from it
                return
            while True:
                group = list(itertools.islice(it, int(steps)))
                if len(group) < int(steps):
                    if group and not drop_last:
                        yield group
                    return
                yield group

        stager = _CudaStager(dev, host_names) if dev is not None else None

        def stage(item):
            if steps is not None:
                item = _stack_group(item)
            return stager(item) if stager is not None else item

        p = _Prefetcher(source, size, transform=stage, name="ptpu-prefetch-device")
        try:
            for item in p:
                yield stager.ready(item) if stager is not None else item
        finally:
            p.close()

    return reader_


def map_readers(func: Callable, *readers):
    def reader_():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return reader_


def chain(*readers):
    def reader_():
        for r in readers:
            yield from r()

    return reader_


class ComposeNotAligned(ValueError):
    """reference: reader/decorator.py:145 — raised by ``compose`` when
    ``check_alignment=True`` and the input readers have unequal length."""


def compose(*readers, check_alignment: bool = True):
    def reader_():
        iters = [r() for r in readers]
        sentinel = object()
        for items in itertools.zip_longest(*iters, fillvalue=sentinel):
            if any(it is sentinel for it in items):
                if check_alignment and not all(it is sentinel for it in items):
                    raise ComposeNotAligned("outputs of readers are not aligned")
                return
            out = []
            for it in items:
                out.extend(it if isinstance(it, tuple) else (it,))
            yield tuple(out)

    return reader_


class Fake:
    """reference: reader/decorator.py:531 — cache the first sample and
    replay it ``data_num`` times (pipeline speed testing)."""

    def __init__(self):
        self.data = None

    def __call__(self, reader, data_num):
        def fake_reader():
            if self.data is None:
                # a bare next() raising StopIteration inside a generator
                # would become PEP 479's RuntimeError
                first = list(itertools.islice(iter(reader()), 1))
                if not first:
                    raise ValueError("Fake: the wrapped reader yielded no data")
                self.data = first[0]
            for _ in range(data_num):
                yield self.data

        return fake_reader


class PipeReader:
    """reference: reader/decorator.py:460 — stream data from a shell
    command's stdout, optionally gzip (multi-member streams supported),
    yielding lines via ``get_line``.  A command that exits nonzero
    raises instead of ending the stream silently (a truncated dataset
    must not look like EOF)."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import subprocess
        import zlib

        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type == "gzip":
            self._zlib = zlib
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        elif file_type != "plain":
            raise TypeError("file_type %s is not allowed" % file_type)
        self.file_type = file_type
        self.bufsize = bufsize
        self.process = subprocess.Popen(command.split(" "), bufsize=bufsize,
                                        stdout=subprocess.PIPE)

    def _decompress(self, buff: bytes) -> bytes:
        # concatenated gzip members (cat a.gz b.gz): each decompressobj
        # stops at its member's end, so chain through unused_data
        out = self.dec.decompress(buff)
        while self.dec.eof and self.dec.unused_data:
            tail = self.dec.unused_data
            self.dec = self._zlib.decompressobj(32 + self._zlib.MAX_WBITS)
            out += self.dec.decompress(tail)
        return out

    def get_line(self, cut_lines=True, line_break="\n"):
        import codecs

        # incremental decode: a multi-byte UTF-8 char split across a
        # bufsize boundary must not raise mid-stream
        decoder = codecs.getincrementaldecoder("utf-8")()
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                break
            raw = self._decompress(buff) if self.file_type == "gzip" else buff
            text = decoder.decode(raw)
            if not cut_lines:
                if text:
                    yield text
                continue
            parts = (remained + text).split(line_break)
            remained = parts.pop()
            yield from parts
        remained += decoder.decode(b"", final=True)
        if remained:
            yield remained
        rc = self.process.wait()
        if rc != 0:
            raise RuntimeError(
                "PipeReader command exited with status %d — the stream may be truncated" % rc)


def firstn(reader, n: int):
    def reader_():
        return itertools.islice(reader(), n)

    return reader_


def cache(reader):
    data: List[Any] = []
    loaded = [False]

    def reader_():
        if not loaded[0]:
            data.extend(reader())
            loaded[0] = True
        return iter(data)

    return reader_


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """reference: python/paddle/reader/decorator.py xmap_readers — map
    ``mapper`` over reader samples with a pool of worker threads;
    ``order=True`` keeps the reader's order."""

    def decorated():
        in_q: queue.Queue = queue.Queue(buffer_size)
        out_q: queue.Queue = queue.Queue(buffer_size)
        end = object()

        def feed():
            for i, sample in enumerate(reader()):
                in_q.put((i, sample))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, sample = item
                out_q.put((i, mapper(sample)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()
        done, pending, next_i = 0, {}, 0
        while done < process_num:
            item = out_q.get()
            if item is end:
                done += 1
                continue
            if not order:
                yield item[1]
                continue
            pending[item[0]] = item[1]
            while next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
        for i in sorted(pending):
            yield pending[i]

    return decorated


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """reference: decorator.py multiprocess_reader: the samples of several
    readers, interleaved as they come.  Each reader runs in a worker
    thread, as in the JAX package (sample making is numpy and file work,
    and a fork would copy the CUDA context)."""

    def decorated():
        out_q: "queue.Queue" = queue.Queue(queue_size)

        def work(r):
            for sample in r():
                out_q.put(sample)
            out_q.put(_END)

        for r in readers:
            threading.Thread(target=work, args=(r,), daemon=True).start()
        done = 0
        while done < len(readers):
            item = out_q.get()
            if item is _END:
                done += 1
            else:
                yield item

    return decorated


# ---------------------------------------------------------------------------
# PyReader
# ---------------------------------------------------------------------------
def _places_device(places):
    """The staging device of a PyReader's ``places``: ``None`` is
    ``"auto"`` (``cuda:0``); a place, or a list of places on one device,
    is that device."""
    if places is None:
        return "auto"
    ps = list(places) if isinstance(places, (list, tuple)) else [places]
    if not ps or not all(isinstance(p, framework.Place) for p in ps):
        raise NotImplementedError(
            "PyReader places=%r: staging for a compiled or sharded program belongs to the "
            "sharded prefetch (ROADMAP A10 part 4), which is not ported yet" % (places,))
    if len({str(p.device()) for p in ps}) > 1:
        raise NotImplementedError(
            "PyReader over %d devices belongs to the sharded prefetch of paddle_tpu_torch "
            "(ROADMAP A10 part 4), which is not ported yet" % len(ps))
    return ps[0]


class PyReader:
    """Iterable data pipeline bound to feed vars (reference: reader.py:47).

    ``for data in reader():`` yields feed dicts (lists with
    ``return_list``).  With ``use_double_buffer`` the batches are staged
    on the card by ``device_buffered`` ahead of the step; the device
    comes from ``places`` (default ``cuda:0``; ``CPUPlace()`` keeps
    them on the host).  A sample list goes through ``DataFeeder``, as
    the reference's PyReader does, so a ragged var also yields its
    ``<name>_seq_len``.
    """

    def __init__(
        self,
        feed_list: Optional[Sequence] = None,
        capacity: int = 4,
        use_double_buffer: bool = True,
        iterable: bool = True,
        return_list: bool = False,
    ):
        self._feed_vars = list(feed_list or [])
        self._capacity = max(2, int(capacity))
        self._use_double_buffer = use_double_buffer
        self._iterable = iterable
        self._return_list = return_list
        self._generator: Optional[Callable] = None
        self._places = None

    # --- decoration (reference API) ---
    def decorate_sample_list_generator(self, generator, places=None):
        """generator yields lists of sample tuples (one list = one batch)."""
        feeder = DataFeeder(self._feed_vars)

        def batch_gen():
            for samples in generator():
                yield feeder.feed(samples)

        self._generator = batch_gen
        self._places = places
        return self

    def decorate_batch_generator(self, generator, places=None):
        """generator yields ready batches: dicts, or tuples/lists of
        arrays in feed-var order."""

        def batch_gen():
            for arrays in generator():
                if not isinstance(arrays, dict):
                    arrays = dict(zip((v.name for v in self._feed_vars), arrays))
                yield {v.name: self._cast(np.asarray(arrays[v.name]), v) for v in self._feed_vars}

        self._generator = batch_gen
        self._places = places
        return self

    decorate_tensor_provider = decorate_batch_generator  # legacy alias

    @staticmethod
    def _cast(arr: np.ndarray, var) -> np.ndarray:
        want = core_types.np_dtype(var.dtype)
        return arr.astype(want) if arr.dtype != want else arr

    # --- iteration ---
    def __call__(self):
        return self._iter()

    def __iter__(self):
        return self._iter()

    def _iter(self):
        if self._generator is None:
            raise RuntimeError("PyReader is not decorated with a generator")
        names = [v.name for v in self._feed_vars]
        src = (device_buffered(self._generator, self._capacity,
                               device=_places_device(self._places))()
               if self._use_double_buffer else self._generator())
        try:
            for feed in src:
                yield [feed[n] for n in names] if self._return_list else feed
        finally:
            src.close()  # an abandoned epoch stops the prefetch thread now

    # --- legacy non-iterable surface ---
    def start(self):
        self._started_iter = self._iter()

    def reset(self):
        self._started_iter = None

    def next(self):
        return next(self._started_iter)


class DataLoader:
    """fluid.io.DataLoader.from_generator: a PyReader."""

    @staticmethod
    def from_generator(feed_list=None, capacity=4, use_double_buffer=True, iterable=True,
                       return_list=False):
        return PyReader(feed_list, capacity, use_double_buffer, iterable, return_list)
