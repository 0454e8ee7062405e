"""Admission control: the deadline-ordered, priority-shedding request
queue (own copy of the JAX package's ``serving/admission.py``).

* **Earliest-deadline-first ordering** — one heap per priority class,
  keyed by deadline (no-deadline requests sort last, FIFO among
  themselves); expired entries surface at the top, where the sweep
  drops them with a typed ``DeadlineExceeded``.
* **Priority classes** — ``PRIORITY_HIGH=0`` < ``PRIORITY_NORMAL=1`` <
  ``PRIORITY_LOW=2`` (lower = more important).  A full queue sheds the
  lowest-priority, least-urgent queued entry to admit a more important
  arrival.
* **An adaptive admit limit (AIMD)** between ``min_limit`` and the
  configured capacity: halved when the observed queue wait overshoots
  ``target_wait_ms``, grown by one while it stays under.
* **A computed retry hint** on every shed (``retry_after_ms``).
* **Weighted fair sharing across classes** — pops are
  stride-scheduled by ``class_weights`` (default HIGH 4 : NORMAL 2 :
  LOW 1), so under steady saturation LOW gets a trickle, not zero.

The brownout ladder and the admission gauges come with the port's
monitor slice.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_LOW",
    "DEFAULT_CLASS_WEIGHTS", "AdmissionQueue",
]

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2

#: default stride-scheduling shares (lower class int = more important);
#: a class not in the map weighs 1.
DEFAULT_CLASS_WEIGHTS = {
    PRIORITY_HIGH: 4.0, PRIORITY_NORMAL: 2.0, PRIORITY_LOW: 1.0,
}

_NO_DEADLINE = float("inf")


class _Entry:
    """One queued request: EDF heap key, the admission priority, and a
    tombstone flag (priority shedding removes entries lazily)."""

    __slots__ = ("key", "seq", "req", "priority", "alive")

    def __init__(self, key: float, seq: int, req, priority: int):
        self.key = key
        self.seq = seq
        self.req = req
        self.priority = priority
        self.alive = True

    def __lt__(self, other: "_Entry") -> bool:
        return (self.key, self.seq) < (other.key, other.seq)


class AdmissionQueue:
    """The bounded, deadline-ordered, priority-shedding request store
    behind ``DynamicBatcher``.

    Locking: ``cv`` is the queue's condition variable (submitters
    notify, the single consumer waits).  ``*_locked`` methods require it
    held; ``offer`` takes it itself and returns the requests it dropped
    so the caller fails them outside the lock.
    """

    # AIMD cadence: adjust after this many pops or this much time
    _ADJUST_EVERY = 16
    _ADJUST_INTERVAL_S = 0.25
    # EWMA smoothing for the observed queue wait
    _EWMA_ALPHA = 0.2

    def __init__(self, capacity: int, target_wait_ms: float = 50.0,
                 min_limit: int = 4, adaptive: bool = True,
                 class_weights: Optional[Dict[int, float]] = "default"):
        # <= 0 means unbounded (no shedding, no adaptive limit)
        self.capacity = int(capacity) if int(capacity) > 0 else None
        self.target_wait_s = float(target_wait_ms) / 1e3
        self.min_limit = max(1, int(min_limit))
        if self.capacity is not None:
            self.min_limit = min(self.min_limit, self.capacity)
        self.adaptive = bool(adaptive) and self.capacity is not None
        self.cv = threading.Condition()
        if class_weights == "default":
            class_weights = DEFAULT_CLASS_WEIGHTS
        self.class_weights = (
            {int(k): float(v) for k, v in class_weights.items()}
            if class_weights is not None else None)
        if self.class_weights is not None and any(
                w <= 0 for w in self.class_weights.values()):
            raise ValueError(
                "class weights must be positive, got %r" % class_weights)
        self._heaps: Dict[int, List[_Entry]] = {}
        self._class_live: Dict[int, int] = {}
        # stride scheduling: each class owns a virtual-time pass advanced
        # by 1/weight per pop; the smallest pass serves next.  A class
        # waking from empty joins at _global_pass, so idling banks no credit.
        self._pass: Dict[int, float] = {}
        self._global_pass = 0.0
        self._live = 0
        self._seq = 0
        self._limit = self.capacity if self.capacity is not None else 0
        self._wait_ewma = 0.0   # seconds, EWMA of observed queue wait
        self._pops_since_adjust = 0
        self._last_adjust = time.monotonic()

    # ------------------------------------------------------------------
    @property
    def limit(self) -> int:
        """Current effective admit limit (the AIMD output)."""
        return self._limit if self.capacity is not None else 0

    def qsize(self) -> int:
        with self.cv:
            return self._live

    def _retry_after_locked(self) -> float:
        ratio = 1.0
        if self.capacity is not None and self._limit > 0:
            ratio = max(1.0, self._live / float(self._limit))
        return max(1.0, self._wait_ewma * 1e3 * ratio)

    # ------------------------------------------------------------------
    @staticmethod
    def _key(req) -> float:
        deadline = getattr(req, "deadline", None)
        return deadline if deadline is not None else _NO_DEADLINE

    def offer(self, req) -> Tuple[bool, List, List, float]:
        """Try to admit ``req``.  Returns ``(admitted, expired, shed,
        retry_after_ms)``: ``expired`` are entries the sweep dropped,
        ``shed`` are lower-priority entries evicted to make room."""
        expired: List = []
        shed: List = []
        priority = int(getattr(req, "priority", PRIORITY_NORMAL))
        with self.cv:
            now = time.monotonic()
            self._sweep_locked(now, expired)
            admitted = True
            if self.capacity is not None and self._live >= self._limit:
                victim = self._pick_victim_locked(priority)
                if victim is None:
                    admitted = False
                else:
                    victim.alive = False
                    self._live -= 1
                    self._class_live[victim.priority] -= 1
                    shed.append(victim.req)
            retry_ms = self._retry_after_locked()
            if admitted:
                self._seq += 1
                live = self._class_live.get(priority, 0)
                if live == 0 and self.class_weights is not None:
                    self._pass[priority] = max(
                        self._pass.get(priority, 0.0), self._global_pass)
                heapq.heappush(
                    self._heaps.setdefault(priority, []),
                    _Entry(self._key(req), self._seq, req, priority))
                self._class_live[priority] = live + 1
                self._live += 1
                self.cv.notify()
        return admitted, expired, shed, retry_ms

    def _sweep_locked(self, now: float, expired: List) -> None:
        """Drop dead/expired entries off every class heap's top (EDF puts
        every expired entry ahead of every live one)."""
        for cls, heap in self._heaps.items():
            while heap:
                top = heap[0]
                if not top.alive:
                    heapq.heappop(heap)
                    continue
                if top.key is not _NO_DEADLINE and top.key <= now:
                    heapq.heappop(heap)
                    top.alive = False
                    self._live -= 1
                    self._class_live[cls] -= 1
                    expired.append(top.req)
                    continue
                break

    def _pick_victim_locked(self, priority: int) -> Optional[_Entry]:
        """The strictly-lower-priority entry with the latest deadline, or
        None when every queued entry is at least as important as the
        arrival (then the arrival sheds)."""
        victim = None
        for cls, heap in self._heaps.items():
            if cls <= priority:
                continue
            for ent in heap:
                if not ent.alive:
                    continue
                if victim is None or (
                        (ent.priority, ent.key, ent.seq)
                        > (victim.priority, victim.key, victim.seq)):
                    victim = ent
        return victim

    def _next_class_locked(self) -> Optional[int]:
        best = None
        best_rank = None
        for cls, heap in self._heaps.items():
            if not self._class_live.get(cls) or not heap:
                continue
            top = heap[0]
            if self.class_weights is None:
                rank = (top.key, top.seq)
            else:
                rank = (self._pass.get(cls, 0.0), cls)
            if best_rank is None or rank < best_rank:
                best, best_rank = cls, rank
        return best

    # ------------------------------------------------------------------
    def pop_locked(self, now: Optional[float] = None
                   ) -> Tuple[Optional[object], List]:
        """Pop the next live request (None when empty) and the expired
        entries swept on the way.  Caller holds ``cv``."""
        expired: List = []
        now = time.monotonic() if now is None else now
        self._sweep_locked(now, expired)
        cls = self._next_class_locked()
        if cls is None:
            return None, expired
        ent = heapq.heappop(self._heaps[cls])
        ent.alive = False
        self._live -= 1
        self._class_live[cls] -= 1
        if self.class_weights is not None:
            cur = self._pass.get(cls, 0.0)
            self._global_pass = cur
            self._pass[cls] = cur + 1.0 / self.class_weights.get(cls, 1.0)
        submit_t = getattr(ent.req, "submit_t", None)
        if submit_t is not None:
            self._observe_locked(
                max(0.0, time.perf_counter() - submit_t), now)
        return ent.req, expired

    def _observe_locked(self, wait_s: float, now: float) -> None:
        """One observed queue wait -> the AIMD controller."""
        self._wait_ewma += self._EWMA_ALPHA * (wait_s - self._wait_ewma)
        if not self.adaptive:
            return
        self._pops_since_adjust += 1
        if (self._pops_since_adjust < self._ADJUST_EVERY
                and now - self._last_adjust < self._ADJUST_INTERVAL_S):
            return
        self._pops_since_adjust = 0
        self._last_adjust = now
        if self._wait_ewma > self.target_wait_s:
            self._limit = max(self.min_limit, self._limit // 2)
        elif self._limit < self.capacity:
            self._limit += 1

    # ------------------------------------------------------------------
    def drain_locked(self) -> List:
        """Pop and return every live queued request (shutdown), in strict
        priority order.  Caller holds ``cv``."""
        out = []
        for heap in self._heaps.values():
            out.extend(e for e in heap if e.alive)
        out.sort(key=lambda e: (e.priority, e.key, e.seq))
        self._heaps = {}
        self._class_live = {}
        self._live = 0
        return [e.req for e in out]
