"""Request futures + the dynamic batcher (own copy of the JAX package's
``serving/batching.py``).

Orca/Clipper-style coalescing: concurrent submitters enqueue
row-oriented requests into a bounded queue; the server's worker pulls a
first request, then keeps absorbing arrivals until either
``max_batch_size`` rows are gathered or ``batch_timeout_ms`` has passed
since the batch opened — whichever fires first.  A request that would
overflow the open batch is carried into the next one (never split).
The queue is ``serving.admission.AdmissionQueue`` (EDF, priority
shedding, AIMD admit limit); its pressure (``depth_ratio``) drives the
server's brownout ladder, which sets ``eager`` at level 2.  A batch is
always one precision variant.
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
# real wakeup is a notify (offer() on arrival, wake() on shutdown), so
# an idle server sleeps — this only bounds the damage of a lost notify
_IDLE_WAIT_S = 0.5


class ServingRequest:
    """One submitted inference request: a row-oriented feed plus a
    future the submitter waits on.  ``n_rows`` is the leading dim shared
    by every feed array (validated by the server at submit).

    ``priority`` is the request's admission class (lower = more
    important; ``serving.admission.PRIORITY_*``): under overload the
    queue sheds strictly-lower-priority entries first.

    ``trace_id`` (optional) is the request's Dapper-style trace id:
    every span recorded while the batch containing this request executes
    carries it (``monitor.trace_context``), and the flight recorder keys
    its tail-sampled record by it.  ``parent_span`` (optional) is the
    submitter-side span id the request's own spans hang under — the
    client's infer span in-process, or the wire server's request span
    when the request arrived over a transport hop.

    ``precision`` (optional) is the request's compiled-variant choice
    on a mixed-precision endpoint: None serves the endpoint's policy
    default, ``"fp32"`` is the per-request opt-out.  A batch is always
    ONE variant — the coalescing loop never mixes precisions."""

    def __init__(self, feed: Dict[str, np.ndarray], n_rows: int,
                 deadline: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 parent_span: Optional[str] = None,
                 priority: int = PRIORITY_NORMAL,
                 precision: Optional[str] = None):
        self.feed = feed
        self.n_rows = n_rows
        self.deadline = deadline  # time.monotonic() deadline, or None
        self.priority = int(priority)
        self.trace_id = trace_id
        self.parent_span = parent_span
        self.precision = precision
        self.submit_t = time.perf_counter()
        self.done_t: Optional[float] = None  # perf_counter at completion
        self._done = threading.Event()
        self._value: Optional[List[np.ndarray]] = None
        self._exc: Optional[BaseException] = None

    # --- producer (worker) side ---
    def complete(self, value: List[np.ndarray]) -> None:
        if self._done.is_set():
            return  # first completion wins (shutdown races)
        self._value = value
        self.done_t = time.perf_counter()
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        if self._done.is_set():
            return  # first completion wins (shutdown races)
        self._exc = exc
        self.done_t = time.perf_counter()
        self._done.set()

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and (now or time.monotonic()) >= self.deadline

    # --- consumer (submitter) side ---
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        """Block for the result.  Honors the request deadline even when
        the server never gets to this request (a deadline must surface
        as a typed error, never a hang)."""
        if timeout is None and self.deadline is not None:
            timeout = max(0.0, self.deadline - time.monotonic())
        if not self._done.wait(timeout):
            raise DeadlineExceeded(
                "no result within %.1f ms" % ((timeout or 0.0) * 1e3))
        if self._exc is not None:
            raise self._exc
        assert self._value is not None
        return self._value


class DynamicBatcher:
    """Bounded request queue + the coalescing policy.

    The store is an ``AdmissionQueue`` (EDF heap, priority shedding,
    AIMD admit limit) under one condition variable: submitters
    ``notify`` on arrival and the (single) consuming worker WAITS on the
    condition while idle — an idle server sleeps at ~0% CPU instead of
    polling.  ``wake()`` nudges a parked consumer at shutdown.

    ``eager`` (set by the server's brownout ladder at level >= 2)
    collapses the coalescing window to 0: whatever is queued ships
    immediately — under saturation the window only adds latency, the
    queue itself provides the batching.

    ``on_shed(req, retry_after_ms)`` / ``on_expired(req)`` are the
    server's hooks for requests the QUEUE drops (priority eviction /
    offer-time sweep); the defaults fail the request typed so a
    standalone batcher still honors the contract."""

    def __init__(self, max_batch_size: int, batch_timeout_ms: float,
                 queue_capacity: int, name: str = "server",
                 target_wait_ms: float = 50.0, min_limit: int = 4,
                 adaptive: bool = True, class_weights="default"):
        self.max_batch_size = int(max_batch_size)
        self.batch_timeout_s = float(batch_timeout_ms) / 1e3
        self.queue = AdmissionQueue(
            queue_capacity, target_wait_ms=target_wait_ms,
            min_limit=min_limit, name=name, adaptive=adaptive,
            class_weights=class_weights)
        self._cv = self.queue.cv  # one lock: queue state + wakeups
        self._carry: Optional[ServingRequest] = None  # worker-thread only
        self.eager = False
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

    def depth_ratio(self) -> float:
        """Queue pressure for the brownout controller."""
        return self.queue.depth_ratio()

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
        """Pop and return every queued-but-unbatched request (shutdown
        without drain: the server fails them with ServerClosed).  Does
        not touch the carry slot — that one is the worker's."""
        with self._cv:
            return self.queue.drain_locked()

    def close(self) -> None:
        """Retire the queue's gauge series (server stop)."""
        self.queue.close()

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
                    # sleeps until offer()/wake() notifies; the timeout
                    # is only a lost-notify safety net, not a poll
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
        """Return the next coalesced batch, or None once stopped AND
        drained.  ``on_expired`` is called with each request whose
        deadline passed while queued (the server fails + counts it).

        Requests coalesce in DEADLINE order (the queue is EDF), so the
        batch always starts from the request closest to giving up.

        ``block=False``: a non-blocking poll — returns None immediately
        when no live request is ready.

        While draining (``stop`` set) or in ``eager`` brownout mode the
        window is not awaited — only already-queued requests coalesce,
        so shutdown latency is bounded by the in-flight work and a
        saturated server ships what it has."""
        first = self._take_first(stop, on_expired, block=block)
        if first is None:
            return None
        batch = [first]
        rows = first.n_rows
        window = 0.0 if self.eager else self.batch_timeout_s
        window_end = time.monotonic() + window
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
            if (getattr(req, "precision", None)
                    != getattr(first, "precision", None)):
                # one batch = one compiled precision variant; a
                # mismatched arrival opens the NEXT batch (same carry
                # slot as a size overflow — never dropped, never mixed)
                self._carry = req
                break
            batch.append(req)
            rows += req.n_rows
        return batch
    # hot-path note: the coalescing loop above waits only on the queue
    # CV bounded by the batch window — no device syncs, no sleeps
