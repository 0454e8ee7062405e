"""Request futures + the dynamic batcher (own copy of the JAX package's
``serving/batching.py``).

Orca/Clipper-style coalescing: concurrent submitters enqueue
row-oriented requests into a bounded queue; the server's worker pulls a
first request, then keeps absorbing arrivals until either
``max_batch_size`` rows are gathered or ``batch_timeout_ms`` has passed
since the batch opened — whichever fires first.  A request that would
overflow the open batch is carried into the next one (never split).
The queue is ``serving.admission.AdmissionQueue`` (EDF, priority
shedding, AIMD admit limit).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch.serving.admission import PRIORITY_NORMAL, AdmissionQueue
from paddle_tpu_torch.serving.errors import DeadlineExceeded, ServerOverloaded

__all__ = ["ServingRequest", "DynamicBatcher"]

# safety-net wait bound while parked on the empty-queue condition: every
# real wakeup is a notify (offer() on arrival, wake() on shutdown)
_IDLE_WAIT_S = 0.5


class ServingRequest:
    """One submitted inference request: a row-oriented feed plus a
    future the submitter waits on.  ``n_rows`` is the leading dim shared
    by every feed array (validated by the server at submit);
    ``priority`` is its admission class (lower = more important)."""

    def __init__(self, feed: Dict[str, np.ndarray], n_rows: int,
                 deadline: Optional[float] = None,
                 priority: int = PRIORITY_NORMAL):
        self.feed = feed
        self.n_rows = n_rows
        self.deadline = deadline  # time.monotonic() deadline, or None
        self.priority = int(priority)
        self.submit_t = time.perf_counter()
        self._done = threading.Event()
        self._value: Optional[List[np.ndarray]] = None
        self._exc: Optional[BaseException] = None

    # --- producer (worker) side ---
    def complete(self, value: List[np.ndarray]) -> None:
        if self._done.is_set():
            return  # first completion wins (shutdown races)
        self._value = value
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        if self._done.is_set():
            return
        self._exc = exc
        self._done.set()

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and (now or time.monotonic()) >= self.deadline

    # --- consumer (submitter) side ---
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block for the result.  Honors the request deadline even when
        the server never gets to this request."""
        if timeout is None and self.deadline is not None:
            timeout = max(0.0, self.deadline - time.monotonic())
        if not self._done.wait(timeout):
            raise DeadlineExceeded(
                "no result within %.1f ms" % ((timeout or 0.0) * 1e3))
        if self._exc is not None:
            raise self._exc
        return self._value


class DynamicBatcher:
    """Bounded request queue + the coalescing policy.  Submitters
    ``notify`` on arrival and the single consuming worker waits on the
    queue's condition while idle; ``wake()`` nudges it at shutdown.
    ``on_shed(req, retry_after_ms)`` / ``on_expired(req)`` are the
    server's hooks for requests the queue drops (priority eviction /
    offer-time sweep); the defaults fail the request typed."""

    def __init__(self, max_batch_size: int, batch_timeout_ms: float,
                 queue_capacity: int, target_wait_ms: float = 50.0,
                 min_limit: int = 4, adaptive: bool = True,
                 class_weights="default"):
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.queue = AdmissionQueue(
            queue_capacity, target_wait_ms=target_wait_ms,
            min_limit=min_limit, adaptive=adaptive,
            class_weights=class_weights)
        self._cv = self.queue.cv  # one lock: queue state + wakeups
        self._carry: Optional[ServingRequest] = None  # worker-thread only
        self.on_shed = self._default_shed
        self.on_expired = self._default_expired

    @staticmethod
    def _default_shed(req: ServingRequest, retry_after_ms: float) -> None:
        req.fail(ServerOverloaded(
            "evicted by a higher-priority request",
            retry_after_ms=retry_after_ms))

    @staticmethod
    def _default_expired(req: ServingRequest) -> None:
        req.fail(DeadlineExceeded("deadline passed while queued"))

    def qsize(self) -> int:
        return self.queue.qsize() + (1 if self._carry is not None else 0)

    # --- submitter side ---
    def offer(self, req: ServingRequest) -> None:
        admitted, expired, shed, retry_ms = self.queue.offer(req)
        for r in expired:
            self.on_expired(r)
        for r in shed:
            self.on_shed(r, retry_ms)
        if not admitted:
            raise ServerOverloaded(
                "request queue at its admit limit (%d); shedding"
                % self.queue.limit, retry_after_ms=retry_ms) from None

    def wake(self) -> None:
        """Wake a consumer parked on the empty-queue wait (shutdown)."""
        with self._cv:
            self._cv.notify_all()

    def drain_pending(self) -> List[ServingRequest]:
        """Pop and return every queued-but-unbatched request."""
        with self._cv:
            return self.queue.drain_locked()

    # --- worker side (single consumer) ---
    def _take_first(self, stop: threading.Event, on_expired,
                    block: bool = True) -> Optional[ServingRequest]:
        if self._carry is not None:
            first, self._carry = self._carry, None
            if not first.expired():
                return first
            on_expired(first)
        while True:
            expired: List[ServingRequest] = []
            with self._cv:
                while True:
                    req, ex = self.queue.pop_locked()
                    expired.extend(ex)
                    if req is not None or expired:
                        break
                    if not block or stop.is_set():
                        break
                    self._cv.wait(timeout=_IDLE_WAIT_S)
            for r in expired:
                on_expired(r)
            if req is not None:
                return req
            if expired:
                continue  # swept some; go park again for live work
            return None  # nothing ready / drained

    def next_batch(self, stop: threading.Event, on_expired,
                   block: bool = True) -> Optional[List[ServingRequest]]:
        """The next coalesced batch, or None: once stopped and drained
        (``block=True``), or at once when nothing is ready
        (``block=False``).  ``on_expired`` gets each request whose
        deadline passed while queued.  While draining (``stop`` set) the
        coalescing window is not awaited."""
        first = self._take_first(stop, on_expired, block=block)
        if first is None:
            return None
        batch = [first]
        rows = first.n_rows
        window_end = time.monotonic() + self.batch_timeout_s
        while rows < self.max_batch_size:
            expired: List[ServingRequest] = []
            with self._cv:
                req, ex = self.queue.pop_locked()
                expired.extend(ex)
                if req is None and not expired:
                    wait = window_end - time.monotonic()
                    if wait <= 0 or stop.is_set():
                        break
                    self._cv.wait(timeout=wait)
                    req, ex = self.queue.pop_locked()
                    expired.extend(ex)
            for r in expired:
                on_expired(r)
            if req is None:
                if window_end - time.monotonic() <= 0 or stop.is_set():
                    break
                continue  # window re-checked at loop top
            if rows + req.n_rows > self.max_batch_size:
                self._carry = req  # never split a request across batches
                break
            batch.append(req)
            rows += req.n_rows
        return batch
