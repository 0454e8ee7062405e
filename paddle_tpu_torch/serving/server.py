"""InferenceServer: a dynamic-batching front end over AnalysisPredictor.

Port of the JAX package's ``serving/server.py`` with one replica: a
bounded request queue + ``DynamicBatcher`` in front of one predictor,
and a ``BucketPolicy`` that pads every coalesced batch onto a fixed
ladder of batch sizes.  One worker thread owns the batcher and the
predictor.  It double-buffers: batch N+1 is merged, padded and
dispatched (its kernels queued on the device) before batch N's outputs
are waited for, and N's copy to the host is queued right behind N's
kernels, so the host work of one batch overlaps the device work of
the other.

Lifecycle: construct (the worker starts) -> ``warmup()`` -> ``submit()``
/ ``Client`` traffic -> ``stop(drain=True)`` for a graceful drain.
Replicas, the ladder autotuner, the admin HTTP surface, precision
variants, metrics export and fault injection come with later slices of
the port.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch.scope import to_numpy
from paddle_tpu_torch.serving.admission import PRIORITY_NORMAL
from paddle_tpu_torch.serving.batching import DynamicBatcher, ServingRequest
from paddle_tpu_torch.serving.bucketing import BucketPolicy
from paddle_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
)

__all__ = ["InferenceServer"]

_COUNTERS = ("requests", "batches", "rows", "padded_rows", "warmup_runs",
             "shed", "expired", "failed")


class InferenceServer:
    """Wraps a predictor exposing ``run_padded`` / ``input_specs`` /
    ``get_input_names`` (AnalysisPredictor) behind a batched, bucketed,
    deadline-aware ``submit()``.

    ``input_specs`` (``{name: (per_row_shape, dtype)}``) defaults to the
    predictor's program-derived specs; pass it explicitly when a feed
    var has dynamic non-batch dims.
    """

    def __init__(
        self,
        predictor,
        max_batch_size: int = 32,
        batch_timeout_ms: float = 5.0,
        queue_capacity: int = 256,
        bucket_ladder: Optional[Sequence[int]] = None,
        input_specs: Optional[Dict[str, Tuple[tuple, Any]]] = None,
        name: str = "server",
        target_queue_wait_ms: float = 50.0,
        class_weights="default",
    ):
        self.name = name
        self._predictor = predictor
        self._device: Optional[torch.device] = getattr(predictor, "device", None)
        self._policy = BucketPolicy(max_batch_size, bucket_ladder)
        self._batcher = DynamicBatcher(
            max_batch_size, batch_timeout_ms, queue_capacity,
            target_wait_ms=target_queue_wait_ms, class_weights=class_weights)
        self._batcher.on_shed = self._on_queue_shed
        self._batcher.on_expired = self._on_expired
        self._specs = dict(input_specs) if input_specs else predictor.input_specs()
        self._feed_names = list(predictor.get_input_names())
        self._predictor_lock = threading.Lock()  # warmup vs worker
        self._counts_lock = threading.Lock()
        self._counts = {k: 0 for k in _COUNTERS}
        self._stop = threading.Event()
        self._closed = False  # admission gate (set before _stop on shutdown)
        self._warmed = False
        self._worker = threading.Thread(
            target=self._worker_loop, name="serving-%s" % name, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    @property
    def bucket_ladder(self) -> List[int]:
        return list(self._policy.ladder)

    @property
    def max_batch_size(self) -> int:
        return self._policy.max_batch_size

    def _count(self, key: str, n: int = 1) -> None:
        with self._counts_lock:
            self._counts[key] += n

    def metrics(self) -> Dict[str, object]:
        """Counters (requests, batches, rows, padded_rows, warmup_runs,
        shed, expired, failed) plus the queue depth, admit limit and
        bucket ladder.  ``batches + warmup_runs`` is the number of
        predictor dispatches."""
        with self._counts_lock:
            snap: Dict[str, object] = dict(self._counts)
        snap["queue_depth"] = self._batcher.qsize()
        snap["admit_limit"] = self._batcher.queue.limit
        snap["bucket_ladder"] = self.bucket_ladder
        snap["warmed_up"] = self._warmed
        return snap

    # ------------------------------------------------------------------
    def warmup(self) -> int:
        """Run every bucket rung once on zero feeds (always in range for
        int id feeds), so no shape the ladder can produce meets the
        device for the first time under traffic.  Returns the number of
        rungs run."""
        for bucket in self._policy.ladder:
            feed = {
                name: np.zeros((bucket,) + tuple(shape), dtype)
                for name, (shape, dtype) in self._specs.items()
            }
            with self._predictor_lock:
                self._predictor.run_padded(feed, n_valid=bucket)
            self._count("warmup_runs")
        self._warmed = True
        return len(self._policy.ladder)

    # ------------------------------------------------------------------
    def submit(self, feed, timeout_ms: Optional[float] = None,
               priority: int = PRIORITY_NORMAL) -> ServingRequest:
        """Enqueue one request; returns its future (ServingRequest).

        ``feed``: dict (or positional sequence) of arrays whose shared
        leading dim is the request's row count (1..max_batch_size).
        Raises ServerOverloaded (with a ``retry_after_ms`` hint) when
        shed, ServerClosed after stop(), and DeadlineExceeded at once
        for a ``timeout_ms`` that is already <= 0.
        """
        if self._closed:
            raise ServerClosed("server %r is stopped" % self.name)
        if timeout_ms is not None and float(timeout_ms) <= 0:
            self._count("expired")
            raise DeadlineExceeded(
                "deadline exhausted before admission (%.1f ms)" % float(timeout_ms))
        feed, n_rows = self._normalize_feed(feed)
        deadline = (time.monotonic() + float(timeout_ms) / 1e3
                    if timeout_ms is not None else None)
        req = ServingRequest(feed, n_rows, deadline, priority=priority)
        try:
            self._batcher.offer(req)
        except ServerOverloaded:
            self._count("shed")
            raise
        self._count("requests")
        # close the submit-vs-stop race: if stop() won between the
        # admission check and the offer, nothing will serve this queue
        if self._stop.is_set() and not self._worker.is_alive():
            self._fail_stragglers()
            if req.done():
                raise ServerClosed("server %r is stopped" % self.name)
        return req

    def _normalize_feed(self, feed) -> Tuple[Dict[str, np.ndarray], int]:
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        if set(feed) != set(self._feed_names):
            raise ValueError(
                "feed names %s != endpoint inputs %s"
                % (sorted(feed), sorted(self._feed_names)))
        out, n_rows = {}, None
        for name, val in feed.items():
            shape, dtype = self._specs[name]
            # coerce to the spec dtype so every request meets the same
            # signature the warmup rungs did
            arr = np.asarray(val, dtype=dtype)
            if arr.shape[1:] != tuple(shape):
                raise ValueError(
                    "feed %r rows have shape %s, endpoint expects %s"
                    % (name, arr.shape[1:], tuple(shape)))
            if n_rows is None:
                n_rows = arr.shape[0]
            elif arr.shape[0] != n_rows:
                raise ValueError(
                    "inconsistent request row counts: %r has %d rows, "
                    "expected %d" % (name, arr.shape[0], n_rows))
            out[name] = arr
        if not n_rows:
            raise ValueError("empty request (0 rows)")
        if n_rows > self._policy.max_batch_size:
            raise ValueError(
                "request of %d rows exceeds max_batch_size=%d — split it"
                % (n_rows, self._policy.max_batch_size))
        return out, n_rows

    # ------------------------------------------------------------------
    def _fail_stragglers(self) -> None:
        for req in self._batcher.drain_pending():
            req.fail(ServerClosed("server %r stopped" % self.name))

    def _on_queue_shed(self, req: ServingRequest, retry_after_ms: float) -> None:
        self._count("shed")
        req.fail(ServerOverloaded(
            "evicted by a higher-priority request", retry_after_ms=retry_after_ms))

    def _on_expired(self, req: ServingRequest) -> None:
        self._count("expired")
        req.fail(DeadlineExceeded("deadline passed while queued"))

    # ------------------------------------------------------------------
    # Worker: owns the batcher (single-consumer coalescing) and the
    # predictor; dispatches batch N+1 before materializing batch N.
    # ------------------------------------------------------------------
    def _worker_loop(self) -> None:
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.set_device(self._device)
        pending = None
        while True:
            batch = self._batcher.next_batch(
                self._stop, self._on_expired, block=pending is None)
            if batch is None:
                if pending is not None:
                    self._finalize(*pending)
                    pending = None
                    continue
                return  # stopped and drained
            live = []
            for r in batch:
                if r.expired():
                    self._on_expired(r)
                else:
                    live.append(r)
            nxt = self._execute(live) if live else None
            if pending is not None:
                self._finalize(*pending)
            pending = nxt

    def _execute(self, batch: List[ServingRequest]):
        """Merge + pad + dispatch one batch, and queue its outputs' copy
        to the host behind its kernels; returns the pending tuple for
        ``_finalize``, or None after failing the batch."""
        valid = sum(r.n_rows for r in batch)
        try:
            merged = {
                name: (np.concatenate([r.feed[name] for r in batch], axis=0)
                       if len(batch) > 1 else batch[0].feed[name])
                for name in self._feed_names
            }
            bucket = self._policy.bucket_for(valid)
            padded = self._policy.pad_feed(merged, bucket)
            with self._predictor_lock:
                outs = self._predictor.run_padded(padded, n_valid=valid, return_numpy=False)
            ready = None
            if self._device is not None and self._device.type == "cuda":
                # non_blocking copies land in pinned host memory; the
                # event marks when they (and this batch's kernels) are done
                outs = [o.to("cpu", non_blocking=True) for o in outs]
                ready = torch.cuda.Event()
                ready.record()
        except Exception as exc:  # noqa: BLE001 — fail the batch, keep serving
            self._fail_batch(batch, exc)
            return None
        return batch, outs, ready, valid, bucket

    def _finalize(self, batch: List[ServingRequest], outs, ready, valid: int, bucket: int) -> None:
        """Wait for a dispatched batch's outputs and complete its requests."""
        try:
            if ready is not None:
                ready.synchronize()
            outs = [to_numpy(o) for o in outs]
        except Exception as exc:  # noqa: BLE001 — a deferred device error
            self._fail_batch(batch, exc)
            return
        with self._counts_lock:
            self._counts["batches"] += 1
            self._counts["rows"] += valid
            self._counts["padded_rows"] += bucket
        off = 0
        for r in batch:
            r.complete([o[off:off + r.n_rows] if o.ndim >= 1 and o.shape[0] == valid else o
                        for o in outs])
            off += r.n_rows

    def _fail_batch(self, batch: List[ServingRequest], exc: BaseException) -> None:
        self._count("failed", len(batch))
        for r in batch:
            r.fail(exc)

    # ------------------------------------------------------------------
    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Shut down.  ``drain=True`` (graceful): stop admitting, finish
        every queued request, then join the worker.  ``drain=False``:
        queued-but-unstarted requests fail with ServerClosed."""
        self._closed = True
        if not drain:
            self._fail_stragglers()
        self._stop.set()
        self._batcher.wake()
        self._worker.join(timeout)
        # a submit() that raced past the admission check may have
        # enqueued after the worker drained and exited
        if not self._worker.is_alive():
            self._fail_stragglers()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False
