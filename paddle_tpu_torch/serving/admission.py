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

``BrownoutController`` is the deterministic degradation ladder the
server climbs under sustained saturation (ratio thresholds held for
``hold_s``): L1 drops flight-recorder capture, L2 forces eager batching
(batch window 0), L3 sheds the lowest priority class at admission.
Descent is slower than ascent (hysteresis), so the ladder does not flap.
Exposed as the ``serving_brownout_level`` gauge, beside the admit
limit's ``serving_admit_limit``.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import events as _events

__all__ = [
    "PRIORITY_HIGH", "PRIORITY_NORMAL", "PRIORITY_LOW",
    "DEFAULT_CLASS_WEIGHTS", "AdmissionQueue", "BrownoutController",
]

PRIORITY_HIGH = 0
PRIORITY_NORMAL = 1
PRIORITY_LOW = 2

#: default stride-scheduling shares (lower class int = more important):
#: under three-way saturation HIGH gets 4 of every 7 pops, NORMAL 2,
#: LOW 1 — a deterministic trickle instead of starvation.  A class not
#: in the map weighs 1.
DEFAULT_CLASS_WEIGHTS = {
    PRIORITY_HIGH: 4.0, PRIORITY_NORMAL: 2.0, PRIORITY_LOW: 1.0,
}

_NO_DEADLINE = float("inf")

ADMIT_LIMIT = monitor.gauge(
    "serving_admit_limit",
    "current adaptive admission limit (AIMD on observed queue wait vs "
    "the latency target)", ("server",))
BROWNOUT_LEVEL = monitor.gauge(
    "serving_brownout_level",
    "degradation-ladder level under sustained saturation (0=normal, "
    "1=no flight capture, 2=eager batching, 3=shed lowest priority, "
    "4=cache-only embedding lookups on endpoints with a bound cache)",
    ("server",))
ADMISSION_EXPIRED = monitor.counter(
    "admission_expired_total",
    "requests shed at admission because their deadline had already "
    "passed (wire deadline propagation fail-fast)", ("server",))


class _Entry:
    """One queued request: EDF heap key, the admission priority, and a
    tombstone flag (priority shedding removes entries lazily — the heap
    is never re-built).  Request attributes are read ONCE at admission
    (duck-typed stubs without priority/deadline still work)."""

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

    Locking: ``cv`` is the queue's condition variable (the batcher's
    wakeup channel — submitters notify, the single consumer waits).
    ``*_locked`` methods require it held; ``offer`` takes it itself and
    returns the requests it dropped so the CALLER fails them outside
    the lock (no user callbacks run under ``cv``).
    """

    # AIMD cadence: adjust after this many pops or this much time,
    # whichever comes first (per-pop adjustment would thrash the limit)
    _ADJUST_EVERY = 16
    _ADJUST_INTERVAL_S = 0.25
    # EWMA smoothing for the observed queue wait
    _EWMA_ALPHA = 0.2

    def __init__(self, capacity: int, target_wait_ms: float = 50.0,
                 min_limit: int = 4, name: str = "server",
                 adaptive: bool = True,
                 class_weights: Optional[Dict[int, float]] = "default"):
        # queue.Queue convention kept from the FIFO version: <= 0 means
        # unbounded (no shedding, no adaptive limit)
        self.capacity = int(capacity) if int(capacity) > 0 else None
        self.target_wait_s = float(target_wait_ms) / 1e3
        # the AIMD floor can never exceed the configured capacity (a
        # decrease must not GROW the limit past the hard bound)
        self.min_limit = max(1, int(min_limit))
        if self.capacity is not None:
            self.min_limit = min(self.min_limit, self.capacity)
        self.adaptive = bool(adaptive) and self.capacity is not None
        self.name = name
        self.cv = threading.Condition()
        # the store: one EDF heap PER PRIORITY CLASS, so weighted fair
        # sharing can stride-schedule pops across classes while EDF
        # order is preserved within each
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
        # stride scheduling state: each class owns a virtual-time pass
        # advanced by 1/weight per pop; the smallest pass serves next.
        # _global_pass anchors a class waking from empty so an idle
        # class can never bank credit and then monopolize the queue.
        self._pass: Dict[int, float] = {}
        self._global_pass = 0.0
        self._live = 0
        self._seq = 0
        self._limit = self.capacity if self.capacity is not None else 0
        self._wait_ewma = 0.0   # seconds, EWMA of observed queue wait
        self._pops_since_adjust = 0
        self._last_adjust = time.monotonic()
        self._gauge = ADMIT_LIMIT.labels(server=name)
        if self.capacity is not None:
            self._gauge.set(self._limit)

    # ------------------------------------------------------------------
    @property
    def limit(self) -> int:
        """Current effective admit limit (the AIMD output)."""
        return self._limit if self.capacity is not None else 0

    def qsize(self) -> int:
        with self.cv:
            return self._live

    def depth_ratio(self) -> float:
        """Queue pressure in [0, ~1]: live entries / admit limit (0 for
        an unbounded queue — brownout needs a bound to define 'full')."""
        with self.cv:
            if self.capacity is None or self._limit <= 0:
                return 0.0
            return self._live / float(self._limit)

    @property
    def wait_ewma_ms(self) -> float:
        """The observed queue-wait EWMA in ms (the signal the AIMD
        limit and the ladder autotuner's batch-window proposal read)."""
        with self.cv:
            return self._wait_ewma * 1e3

    def retry_after_ms(self) -> float:
        """The shed hint: how long a rejected caller should back off —
        the EWMA queue wait scaled by the current overload ratio, never
        under 1ms (a 0 hint would invite an immediate re-storm)."""
        with self.cv:
            return self._retry_after_locked()

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
        retry_after_ms)``: ``expired`` are entries the sweep dropped
        (deadline passed while queued), ``shed`` are lower-priority
        entries evicted to make room.  The caller fails both lists
        typed, outside the lock, and raises ``ServerOverloaded``
        carrying ``retry_after_ms`` when not admitted."""
        expired: List = []
        shed: List = []
        # hot-path: begin admission_offer (heap push + bounded sweep
        # under the queue CV; no sleeps, no device syncs)
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
                    # a class waking from empty joins at the CURRENT
                    # virtual time: idle never banks credit
                    self._pass[priority] = max(
                        self._pass.get(priority, 0.0), self._global_pass)
                heapq.heappush(
                    self._heaps.setdefault(priority, []),
                    _Entry(self._key(req), self._seq, req, priority))
                self._class_live[priority] = live + 1
                self._live += 1
                self.cv.notify()
        # hot-path: end admission_offer
        return admitted, expired, shed, retry_ms

    def _sweep_locked(self, now: float, expired: List) -> None:
        """Drop dead/expired entries off every class heap's top.  EDF
        makes this complete per heap: every expired entry keys earlier
        than every live one (no-deadline entries key at +inf), so
        expired work can only sit at a top — the sweep never has to
        scan a heap's middle."""
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
        """The entry priority shedding evicts for an arrival at
        ``priority``: the strictly-lower-priority entry with the latest
        deadline (least urgent loses).  None when every queued entry is
        at least as important as the arrival — then the ARRIVAL sheds.
        O(n) scan, but only ever on the shed path of a full queue."""
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
        """The class the next pop serves.  ``class_weights=None``: pure
        cross-class EDF (the globally earliest deadline wins, FIFO on
        ties).  With weights: stride scheduling — the non-empty class
        with the smallest virtual-time pass wins, so every class drains
        in proportion to its weight and none starves."""
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
        entries swept on the way: earliest deadline within the class the
        fair-share scheduler picked (see ``_next_class_locked``).
        Records the popped request's queue wait into the AIMD
        controller.  Caller holds ``cv`` and fails the expired list
        outside the lock."""
        expired: List = []
        now = time.monotonic() if now is None else now
        # hot-path: begin admission_pop (heap pop + AIMD arithmetic
        # under the queue CV; no sleeps, no device syncs)
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
        # hot-path: end admission_pop
        return ent.req, expired

    def _observe_locked(self, wait_s: float, now: float) -> None:
        """One observed queue wait -> the AIMD controller.  Overshoot of
        the target halves the admit limit (multiplicative decrease);
        staying under grows it by 1 (additive increase)."""
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
        self._gauge.set(self._limit)

    # ------------------------------------------------------------------
    def drain_locked(self) -> List:
        """Pop and return every live queued request (shutdown).  Caller
        holds ``cv``.  Drained in strict priority order (HIGH first,
        EDF/FIFO within each class) — NOT the weighted stride order
        dispatch follows; shutdown fails everything anyway, so only a
        stable, explainable order matters here."""
        out = []
        for heap in self._heaps.values():
            out.extend(e for e in heap if e.alive)
        out.sort(key=lambda e: (e.priority, e.key, e.seq))
        self._heaps = {}
        self._class_live = {}
        self._live = 0
        return [e.req for e in out]

    def close(self) -> None:
        """Retire this queue's gauge series from the exposition."""
        ADMIT_LIMIT.remove_labels(server=self.name)


class BrownoutController:
    """The deterministic degradation ladder.

    ``update(ratio)`` is called by the server's dispatcher with the
    current queue pressure (``AdmissionQueue.depth_ratio``); the level
    climbs one rung at a time when the pressure has stayed at or above
    that rung's threshold for ``hold_s`` (sustained saturation, not a
    blip) and descends — one rung, slower (``4 * hold_s``) — when it
    has stayed below.  Levels:

      0  normal
      1  drop flight-recorder capture (tracing rent off the hot path)
      2  force the batch window to 0 (eager batching: ship what's here)
      3  shed the lowest priority class at admission
      4  (embedding-cache endpoints only) serve lookups cache-only:
         misses get the fallback row instead of queuing on PS pulls

    The rung count is the threshold tuple's length: the default ladder
    stops at 3; an ``InferenceServer`` with a bound ``EmbeddingRowCache``
    passes a 4-threshold ladder, so the cache-only rung exists only where
    it has a cache to serve from.  The same hold and 4x-hysteresis
    machinery governs every rung.

    Deterministic by construction: level changes are a pure function of
    the (ratio, clock) series — chaos tests drive it with an injected
    clock and assert exact transitions.
    """

    #: pressure at or above which each level (1, 2, 3) wants to engage
    THRESHOLDS = (0.5, 0.75, 0.9)
    #: the cache-only rung's threshold when a 4-rung ladder is built
    CACHE_ONLY_THRESHOLD = 0.97
    MAX_LEVEL = 3

    def __init__(self, name: str = "server", hold_s: float = 0.25,
                 clock=time.monotonic, thresholds=None):
        self.name = name
        self.hold_s = float(hold_s)
        self.thresholds = (tuple(float(t) for t in thresholds)
                           if thresholds is not None else self.THRESHOLDS)
        if list(self.thresholds) != sorted(self.thresholds):
            raise ValueError(
                "brownout thresholds must ascend, got %r"
                % (self.thresholds,))
        self.max_level = len(self.thresholds)
        self._clock = clock
        self.level = 0
        self._pending: Optional[Tuple[int, float]] = None  # (direction, since)
        # update() is called from the dispatcher loop AND the submit
        # path (an L3 door-shed must still be able to descend when only
        # low-priority traffic arrives — with nothing enqueued the
        # dispatcher stays parked and would never sample again)
        self._lock = threading.Lock()
        self._gauge = BROWNOUT_LEVEL.labels(server=name)
        self._gauge.set(0)

    def _target(self, ratio: float) -> int:
        lvl = 0
        for i, thr in enumerate(self.thresholds):
            if ratio >= thr:
                lvl = i + 1
        return lvl

    def update(self, ratio: float, now: Optional[float] = None) -> int:
        """Fold one pressure sample; returns the (possibly new) level.
        Thread-safe: sampled by the dispatcher each turn and by the
        submit path at the L3 door."""
        now = self._clock() if now is None else now
        with self._lock:
            target = self._target(ratio)
            if target == self.level:
                self._pending = None
                return self.level
            direction = 1 if target > self.level else -1
            if self._pending is None or self._pending[0] != direction:
                self._pending = (direction, now)
                return self.level
            hold = self.hold_s if direction > 0 else 4.0 * self.hold_s
            if now - self._pending[1] >= hold:
                self.level += direction
                self._pending = None
                self._gauge.set(self.level)
                # event ring + span-stream instant in one call; a level
                # RISE is degradation (warning), easing back is info
                _events.emit(
                    "serving/brownout",
                    severity="warning" if direction > 0 else "info",
                    cat="serving", server=self.name, level=self.level)
            return self.level

    def close(self) -> None:
        BROWNOUT_LEVEL.remove_labels(server=self.name)
