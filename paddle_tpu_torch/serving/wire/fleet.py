"""FleetBalancer: least-loaded routing over N serving processes (the
port's copy of the JAX package's ``serving/wire/fleet.py``).

The in-process replica fleet's state machine — least-loaded routing,
bounded per-backend in-flight, retirement after consecutive failures,
requeue-to-survivor so accepted requests never drop — promoted from
threads to PROCESSES: each backend is a ``ServingProcess`` on the other
side of a wire transport, failure detection is typed transport errors
(``BackendUnavailable``: the process died mid-exchange) plus an active
``/healthz`` probe loop, and requeues re-SEND the request to a
surviving backend (idempotent by construction: a request whose response
never arrived was never delivered).

Overload control closes the loop fleet-wide: every response meta
carries the server's load report (queue depth, adaptive admit limit,
brownout level), and routing ranks backends by ``in_flight + reported
backlog`` instead of in-flight counts alone — a server drowning in its
own queue stops attracting traffic before it ever fails a health check.
A ``ServerOverloaded`` answer pauses that backend until its
``retry_after_ms`` hint elapses, and EVERY re-dispatch (requeue or
overload retry) spends a token from a token-bucket throttle
(``retry_throttled_total``): under saturation the fleet propagates
back-pressure to callers instead of amplifying its own retries into a
metastable collapse.

Client surface: the same ``infer`` / ``infer_named`` / ``infer_many``
/ ``infer_stream`` contract as ``Client``/``RemoteClient``, so
the balancer drops in wherever a single endpoint handle did.  Fleet
accounting reuses ``ServingMetrics`` — the balancer IS a server-shaped
thing: ``serving_requests_total``/``serving_requeued_total``/the
latency histogram all expose with ``server=<fleet name>``, and
balancer-specific health/retirement counters live in ``wire.metrics``.

Operations: ``warmup()`` pre-compiles every bucket rung on EVERY
backend concurrently (the zero-recompile guarantee becomes fleet-wide
across processes), and ``rolling_replace()`` swaps each launched
backend for a fresh warmed child one at a time — capacity never drops
below N-1 and a child that has not built its entries and graphs never
sees traffic.
"""
from __future__ import annotations

import hashlib
import json
import random
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import monitor
from paddle_tpu_torch.faults.metrics import BACKEND_HALFOPEN_PROBES
from paddle_tpu_torch.faults.retry import RetryPolicy
from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import registry as _registry
from paddle_tpu_torch.monitor import slo as _slo
from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.serving import errors as _errors
from paddle_tpu_torch.serving.errors import (
    BackendUnavailable,
    DeadlineExceeded,
    RelaunchFailed,
    ServerOverloaded,
    ServingError,
    WireProtocolError,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.wire import launch as _launch
from paddle_tpu_torch.serving.wire.client import flight_report as _flight_report
from paddle_tpu_torch.serving.wire.client import (
    pump_stream_messages,
    raise_in_band_error,
    wire_call,
    wire_stream_open,
)
from paddle_tpu_torch.serving.wire.http import HttpTransport
from paddle_tpu_torch.serving.wire.metrics import (
    FEDERATION_SCRAPES,
    FEDERATION_STALENESS,
    FLEET_AFFINITY_HITS,
    RETRY_THROTTLED,
    WIRE_BACKEND_RETIRED,
    WIRE_HEALTH_CHECK_FAILURES,
    WIRE_HEALTH_CHECKS,
)

__all__ = ["FleetBalancer"]

# consecutive request/health failures before a backend leaves routing —
# same limit the in-process replica fleet uses for its workers
_BACKEND_FAIL_LIMIT = 3

# safety-net bound for the all-backends-busy wait (real wakeups are
# notifies from releases/retirements)
_ROUTE_WAIT_S = 0.5

# transport failures the balancer may re-route: the process died
# mid-exchange (no response), it answered that it is shutting down, or
# the frame was corrupted in flight.  Inference is stateless and
# idempotent, so re-sending a corrupted-or-lost exchange to a survivor
# cannot double-apply anything.
_RETRYABLE = (BackendUnavailable, _errors.ServerClosed, WireProtocolError)

# a backend's reported load (queue depth + admit limit in every response
# meta) participates in routing only while this fresh; after that the
# balancer falls back to its own in-flight counts (a stale report from
# a quiet backend must not repel traffic forever)
_LOAD_FRESH_S = 5.0

# cache-affinity routing is a bounded TIE-BREAK, never a mandate: the
# hinted backend (whose prefix KV cache is warm for this prompt head)
# wins only while its load score is within this slack of the
# least-loaded candidate.  A hot-prefix herd therefore spills to other
# backends exactly when least-loaded routing says it should, and a
# browned-out / overloaded / paused backend never attracts traffic on
# the strength of a warm cache (those filters run BEFORE the tie-break).
_AFFINITY_SLACK = 1.0


class _RetryThrottle:
    """Token-bucket pacing for fleet re-dispatch: tokens accrue at
    ``rate_per_s`` up to ``burst``; every requeue/retry spends one.  A
    dry bucket means the fleet's own retries have become the load — the
    typed error propagates to the caller (who holds the retry hint)
    instead of re-storming a saturated backend into metastable
    collapse."""

    def __init__(self, rate_per_s: float = 100.0, burst: int = 32):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._stamp = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(
                self.burst, self._tokens + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False


def _probe_jitter(interval_s: float, rng: random.Random) -> float:
    """Per-backend probe spacing: the interval +-15%.  N backends probed
    on one lockstep clock would thundering-herd a server that is just
    coming back; de-phased clocks spread the load."""
    return interval_s * (0.85 + 0.3 * rng.random())


class _Backend:
    """One serving process behind the balancer: transport + health and
    in-flight accounting (the routing state)."""

    __slots__ = ("idx", "name", "transport", "handle", "alive", "in_flight",
                 "executed", "failed", "consec_failures",
                 "consec_health_failures", "retired_at", "removed",
                 "give_up", "next_probe_at", "reported_depth",
                 "reported_limit", "reported_brownout", "load_ts",
                 "not_before", "prefix_hints", "affinity_hits")

    def __init__(self, idx: int, name: str, transport: HttpTransport,
                 handle: Optional[_launch.ServerHandle] = None):
        self.idx = idx
        self.name = name
        self.transport = transport
        self.handle = handle  # launched child (None: bare address)
        self.alive = True
        self.in_flight = 0  # guarded by the balancer's _route_cv
        self.executed = 0
        self.failed = 0
        self.consec_failures = 0
        self.consec_health_failures = 0
        self.retired_at = 0.0     # monotonic stamp of failure retirement
        self.removed = False      # deliberate removal: never re-admit
        self.give_up = False      # supervisor exhausted its relaunches
        self.next_probe_at = 0.0  # per-backend jittered probe clock
        # the server's self-reported load (response meta "load"): queue
        # depth + adaptive admit limit + brownout level, folded into
        # least-loaded routing while fresh (guarded by _route_cv)
        self.reported_depth = 0
        self.reported_limit = 0
        self.reported_brownout = 0
        self.load_ts = None  # monotonic stamp of the last report
        # retry-after pacing: routing skips this backend until the stamp
        # (set from ServerOverloaded.retry_after_ms — a shedding backend
        # must not be re-dispatched to before its own hint elapses)
        self.not_before = 0.0
        # cache-affinity bookkeeping: prompt-prefix hashes this backend
        # served last (bounded LRU, guarded by _route_cv) and how many
        # requests landed here BECAUSE of the hint
        self.prefix_hints: "OrderedDict[str, None]" = OrderedDict()
        self.affinity_hits = 0


class FleetBalancer:
    """Front-end balancer over serving processes.

    ``backends``: ``(host, port)`` tuples and/or ``ServerHandle``s from
    ``launch_server`` (handles enable ``rolling_replace``/
    ``stop(shutdown_backends=True)``).  ``max_in_flight`` bounds
    concurrent requests PER BACKEND (admission control: with every live
    backend at the bound, submitters wait — and time out typed against
    their deadline rather than queuing unboundedly).

    ``prefix_affinity=True`` folds prompt-prefix cache affinity into
    routing: requests whose ``tokens`` feed shares its first
    ``affinity_block`` tokens with an earlier request prefer the backend
    that served it (whose ``PrefixKVCache`` retains that prefix's KV),
    as a bounded tie-break on the load score (``_AFFINITY_SLACK``) —
    never overriding the alive/capacity/retry-after filters or genuine
    load imbalance.  Each backend remembers its last ``affinity_hints``
    prefix hashes; ``serving_fleet_affinity_hits_total`` counts routes
    the hint decided.
    """

    def __init__(self, backends: Sequence, name: str = "fleet",
                 max_in_flight: int = 8,
                 timeout_s: float = 30.0,
                 health_interval_s: Optional[float] = 1.0,
                 cooldown_s: float = 5.0,
                 supervisor: Optional[_launch.Supervisor] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_rate_per_s: float = 100.0,
                 retry_burst: int = 32,
                 prefix_affinity: bool = False,
                 affinity_block: int = 16,
                 affinity_hints: int = 1024,
                 admin_port: Optional[int] = None,
                 scrape_interval_s: float = 2.0):
        if not backends:
            raise ValueError("FleetBalancer needs at least one backend")
        self.name = name
        self._timeout_s = float(timeout_s)
        self._max_in_flight = int(max_in_flight)
        self._backends: List[_Backend] = []
        for i, b in enumerate(backends):
            self._add_backend_obj(i, b)
        # requeue budget per request: enough attempts to try every
        # backend once plus one survivor retry, with a short
        # full-jitter backoff so a fleet-wide blip isn't re-stormed
        self._retry_policy = retry_policy or RetryPolicy(
            max_attempts=max(2, len(self._backends) + 1),
            base_delay_s=0.005, multiplier=2.0, max_delay_s=0.1)
        # token-bucket pacing for EVERY re-dispatch (requeue after a
        # transport failure, paced retry after an overload shed): a dry
        # bucket fails the request typed instead of letting the fleet's
        # own retries amplify saturation into metastable collapse
        self._throttle = _RetryThrottle(retry_rate_per_s, retry_burst)
        self._throttled_counter = RETRY_THROTTLED.labels(fleet=name)
        self._prefix_affinity = bool(prefix_affinity)
        self._affinity_block = int(affinity_block)
        self._affinity_hints = int(affinity_hints)
        self._affinity_counter = FLEET_AFFINITY_HITS.labels(fleet=name)
        # circuit-breaker re-admission: a failure-retired backend goes
        # half-open after cooldown_s and takes one probe; a backend
        # whose PROCESS died is revived through the supervisor (capped
        # backoff) before the probe
        self._cooldown_s = float(cooldown_s)
        self._supervisor = supervisor
        self._metrics = ServingMetrics(name)
        self._retired_counter = WIRE_BACKEND_RETIRED.labels(fleet=name)
        self._health_counter = WIRE_HEALTH_CHECKS.labels(fleet=name)
        self._health_failures = WIRE_HEALTH_CHECK_FAILURES.labels(fleet=name)
        self._halfopen_probes = BACKEND_HALFOPEN_PROBES.labels(
            pool="fleet/%s" % name)
        self._route_cv = threading.Condition()
        self._closed = False
        self._warmed = False
        self._shape_lock = threading.Lock()
        self._feed_names: Optional[List[str]] = None
        self._fetch_names: Optional[List[str]] = None
        self._pool = None  # lazy persistent executor (infer_many)
        self._health_stop = threading.Event()
        self._health_thread = None
        # observability federation: the health thread doubles as the
        # scraper (admin tier only — a balancer without an admin port
        # never issues a scrape), caching each child's /metrics text and
        # /statusz /tracez /eventz docs for the federated admin surface
        self._scrape_interval_s = float(scrape_interval_s)
        self._scrape_lock = threading.Lock()
        self._scrapes: Dict[int, Dict[str, object]] = {}
        # scrape-only children (add_scrape_target): federated into the
        # admin surface but never routed to — how a TRAINING admin
        # (Executor.start_train_admin) joins the fleet's pane of glass.
        # Negative idx keys them into _scrapes without colliding with
        # routing backends.
        self._scrape_only: List[_Backend] = []
        self._scrape_ok = FEDERATION_SCRAPES.labels(fleet=name, status="ok")
        self._scrape_err = FEDERATION_SCRAPES.labels(
            fleet=name, status="error")
        self._staleness = FEDERATION_STALENESS.labels(fleet=name)
        self._admin_server = None
        self._admin_thread = None
        if health_interval_s:
            self._health_thread = threading.Thread(
                target=self._health_loop, args=(float(health_interval_s),),
                name="wire-fleet-health-%s" % name, daemon=True)
            self._health_thread.start()
        if admin_port is not None:
            self.start_admin(admin_port)

    # ------------------------------------------------------------------
    @classmethod
    def from_launch(cls, model_dir: str, n: int, name: str = "fleet",
                    launch_kwargs: Optional[Dict[str, object]] = None,
                    **fleet_kwargs) -> "FleetBalancer":
        """Launch ``n`` serving children for ``model_dir`` and balance
        over them (the one-call fleet constructor)."""
        kw = dict(launch_kwargs or {})
        kw.setdefault("name", name)
        handles = []
        try:
            for i in range(n):
                per = dict(kw)
                per["name"] = "%s-%d" % (kw["name"], i)
                handles.append(_launch.launch_server(model_dir, **per))
        except Exception:
            for h in handles:
                h.kill()
            raise
        return cls(handles, name=name, **fleet_kwargs)

    def _add_backend_obj(self, idx: int, b) -> _Backend:
        if isinstance(b, _launch.ServerHandle):
            be = _Backend(
                idx, "b%d@%s:%d" % (idx, b.host, b.port),
                HttpTransport(b.host, b.port, timeout_s=self._timeout_s),
                handle=b)
        else:
            host, port = b
            be = _Backend(
                idx, "b%d@%s:%d" % (idx, host, port),
                HttpTransport(host, port, timeout_s=self._timeout_s))
        self._backends.append(be)
        return be

    def add_scrape_target(self, name: str, address) -> None:
        """Register a scrape-ONLY child: its ``/metrics`` ``/statusz``
        ``/tracez`` ``/eventz`` surfaces federate into this balancer's
        admin endpoints under ``backend=<name>``, but it never receives
        routed inference traffic or health-gated retirement.  This is
        how a trainer (``Executor.start_train_admin``) shows up in the
        same pane of glass as the serving backends.  ``address`` is a
        ``(host, port)`` tuple (e.g. the value ``start_train_admin``
        returned)."""
        host, port = address
        be = _Backend(
            -1, str(name),
            HttpTransport(host, int(port), timeout_s=self._timeout_s))
        with self._route_cv:
            be.idx = -(len(self._scrape_only) + 1)
            self._scrape_only.append(be)

    # ------------------------------------------------------------------
    @property
    def num_backends(self) -> int:
        with self._route_cv:
            return sum(1 for b in self._backends if b.alive)

    def backend_stats(self) -> Dict[str, Dict[str, object]]:
        with self._route_cv:
            now = time.monotonic()
            return {
                b.name: {
                    "alive": b.alive,
                    "in_flight": b.in_flight,
                    "executed": b.executed,
                    "failed": b.failed,
                    "reported_depth": b.reported_depth,
                    "reported_limit": b.reported_limit,
                    "brownout_level": b.reported_brownout,
                    "load_fresh": (b.load_ts is not None
                                   and now - b.load_ts <= _LOAD_FRESH_S),
                    "paused_ms": max(0.0, (b.not_before - now) * 1e3),
                    "prefix_hints": len(b.prefix_hints),
                    "affinity_hits": b.affinity_hits,
                }
                for b in self._backends
            }

    def metrics(self) -> Dict[str, object]:
        snap = self._metrics.snapshot()
        snap["warmed_up"] = self._warmed
        snap["backends"] = self.backend_stats()
        return snap

    # ------------------------------------------------------------------
    def warmup(self, timeout_s: float = 600.0) -> int:
        """Fleet-wide warmup: every backend builds every bucket rung's
        entry (and, on the card, captures its graph) CONCURRENTLY; returns
        the sum of the backends' warm-up counts.  After this, steady-state
        traffic builds no entry anywhere in the fleet."""
        results: Dict[str, object] = {}

        def one(be: _Backend):
            try:
                meta, _ = be.transport.request(
                    "/warmup", {}, (), timeout_s=timeout_s)
                from paddle_tpu_torch.serving.wire.client import raise_in_band_error

                raise_in_band_error(meta)
                results[be.name] = int(meta.get("compiles", 0))
            except BaseException as e:  # noqa: BLE001 — surfaced below
                results[be.name] = e

        with self._route_cv:
            live = [b for b in self._backends if b.alive]
        threads = [threading.Thread(target=one, args=(b,), daemon=True)
                   for b in live]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        errs = {n: r for n, r in results.items()
                if isinstance(r, BaseException)}
        if errs:
            raise ServingError("fleet warmup failed on %s" % sorted(errs))
        compiles = sum(int(r) for r in results.values())
        self._metrics.count("warmup_compiles", compiles)
        self._warmed = True
        return compiles

    # ------------------------------------------------------------------
    # routing: least-loaded live backend, bounded in-flight, requeue on
    # transport failure — the replica state machine across processes
    # ------------------------------------------------------------------
    def _load_score(self, be: _Backend, now: float) -> float:
        """Routing weight: this balancer's own in-flight count plus the
        backend's self-reported backlog (queue depth, while the report
        is fresh) plus its brownout level — a server drowning in its own
        queue stops attracting traffic even when its in-flight count
        looks fine from the outside, and a degraded (browned-out)
        backend ranks behind a healthy equal."""
        score = float(be.in_flight)
        if be.load_ts is not None and now - be.load_ts <= _LOAD_FRESH_S:
            score += float(be.reported_depth) + float(be.reported_brownout)
        return score

    def _affinity_key(self, names, arrays) -> Optional[str]:
        """The routing affinity key for one request: a hash of the first
        ``affinity_block`` tokens of its ``tokens`` feed (the same
        prompt head a backend's ``PrefixKVCache`` keys on), or ``None``
        when affinity is off / the feed has no token prompt / the prompt
        is shorter than one block.  Computed on the submitting thread
        BEFORE dispatch — never inside the routing hot region."""
        if not self._prefix_affinity:
            return None
        try:
            idx = names.index("tokens")
        except ValueError:
            return None
        head = np.asarray(arrays[idx]).reshape(-1)[:self._affinity_block]
        if head.size < self._affinity_block:
            return None
        return hashlib.sha1(
            np.ascontiguousarray(head, np.int32).tobytes()).hexdigest()

    def _pick(self, exclude: Optional[_Backend],
              now: Optional[float] = None,
              affinity_key: Optional[str] = None) -> Optional[_Backend]:
        now = time.monotonic() if now is None else now
        live = [b for b in self._backends
                if b.alive and b is not exclude
                and b.in_flight < self._max_in_flight
                and b.not_before <= now]
        if not live:
            return None
        best = min(live, key=lambda b: self._load_score(b, now))
        if affinity_key is not None:
            # bounded tie-break: the hinted backend (warm prefix KV for
            # this prompt head) wins only within _AFFINITY_SLACK of the
            # least-loaded score, and only after the same eligibility
            # filters every candidate passed — affinity never defeats
            # balancing, overload pacing, or retirement
            bound = self._load_score(best, now) + _AFFINITY_SLACK
            for b in live:
                if (affinity_key in b.prefix_hints
                        and self._load_score(b, now) <= bound):
                    return b
        return best

    def _update_load(self, be: _Backend, load) -> None:
        """Fold one response's load report (success meta ``load``, or
        the same dict re-attached to a typed in-band error) into the
        routing state."""
        if not isinstance(load, dict):
            return
        with self._route_cv:
            try:
                be.reported_depth = int(load.get("queue_depth") or 0)
                be.reported_limit = int(load.get("admit_limit") or 0)
                be.reported_brownout = int(load.get("brownout_level") or 0)
            except (TypeError, ValueError):
                return  # a malformed report never breaks routing
            be.load_ts = time.monotonic()

    def _acquire(self, exclude: Optional[_Backend],
                 deadline: Optional[float],
                 affinity_key: Optional[str] = None) -> _Backend:
        with self._route_cv:
            while True:
                if self._closed:
                    raise _errors.ServerClosed(
                        "fleet %r is stopped" % self.name)
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    # expired BEFORE taking a slot: fail fast typed —
                    # never burn a backend's in-flight capacity on a
                    # request whose caller already gave up
                    self._metrics.count("expired")
                    raise DeadlineExceeded(
                        "deadline passed before acquiring a backend")
                be = self._pick(exclude, now, affinity_key)
                if be is None and exclude is not None and not any(
                        b.alive and b is not exclude for b in self._backends):
                    be = self._pick(None, now)  # only the excluded one: reuse
                if be is not None:
                    be.in_flight += 1
                    if affinity_key is not None:
                        self._note_affinity_locked(be, affinity_key)
                    return be
                if not any(b.alive for b in self._backends):
                    raise ServingError(
                        "no live backends in fleet %r" % self.name)
                wait = _ROUTE_WAIT_S
                # a retry-after pause expires on a clock, not a notify:
                # wake exactly when the earliest paused backend frees up
                nxt = min((b.not_before for b in self._backends
                           if b.alive and b.not_before > now),
                          default=None)
                if nxt is not None:
                    wait = min(wait, max(0.001, nxt - now))
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        self._metrics.count("expired")
                        raise DeadlineExceeded(
                            "deadline passed waiting for fleet capacity")
                self._route_cv.wait(timeout=wait)

    def _note_affinity_locked(self, be: _Backend, key: str) -> None:
        """Record where this prefix landed (holding _route_cv): a
        returning prefix on its hinted backend is an affinity hit; any
        landing re-hints the key here (the request is about to warm THIS
        backend's prefix cache — after a spill or retirement, future
        requests should follow the KV, not the stale hint)."""
        if key in be.prefix_hints:
            be.prefix_hints.move_to_end(key)
            be.affinity_hits += 1
            self._affinity_counter.inc()
            return
        for other in self._backends:
            other.prefix_hints.pop(key, None)
        be.prefix_hints[key] = None
        while len(be.prefix_hints) > self._affinity_hints:
            be.prefix_hints.popitem(last=False)

    def _release(self, be: _Backend, ok: bool) -> None:
        with self._route_cv:
            be.in_flight -= 1
            if ok:
                be.executed += 1
                be.consec_failures = 0
            self._route_cv.notify_all()

    def _record_failure(self, be: _Backend) -> None:
        with self._route_cv:
            be.failed += 1
            be.consec_failures += 1
            if be.consec_failures >= _BACKEND_FAIL_LIMIT and be.alive:
                self._retire_locked(be, "request failures")

    def _retire_locked(self, be: _Backend, why: str) -> None:
        be.alive = False
        be.retired_at = time.monotonic()  # half-open cooldown starts now
        self._retired_counter.inc()
        # event ring + span-stream instant in one call (emit forwards)
        _events.emit(
            "wire/backend_retired", severity="error", cat="wire",
            fleet=self.name, backend=be.name, reason=why)
        self._route_cv.notify_all()

    def _count_requeue(self, be: _Backend) -> None:
        """One re-routed request: counter + timeline marker move
        together, exactly like the in-process replica requeue."""
        self._metrics.count("requeued")
        monitor.record_instant(
            "serving/batch_requeue", cat="serving",
            server=self.name, replica=be.name)

    # ------------------------------------------------------------------
    def infer(self, feed, timeout_ms: Optional[float] = None,
              trace_id: Optional[str] = None,
              priority: Optional[int] = None,
              precision: Optional[str] = None) -> List[np.ndarray]:
        """One request through the fleet.  A backend that dies
        mid-exchange (``BackendUnavailable``) or answers that it is
        shutting down (``ServerClosed``) retires after repeated failures
        and the request REQUEUES to a survivor — an accepted request
        completes or fails typed, never silently drops.  Deadline /
        validation answers are NOT retried: they are end-state answers
        from a live backend, not lost work.  An overload shed is
        retried — PACED: the shedding backend is skipped until its
        ``retry_after_ms`` hint elapses and every re-dispatch spends a
        token from the fleet's retry throttle
        (``retry_throttled_total`` counts denials), so saturation
        propagates back-pressure instead of a retry storm.
        ``priority`` (``serving.admission.PRIORITY_*``) rides the wire
        meta into the backend's priority shedding; ``precision`` into
        the backend's mixed-precision variant dispatch (every backend
        serves the same saved manifest, so any survivor a requeue
        lands on honors the same choice)."""
        tid = trace_id or monitor.new_trace_id()
        self.last_trace_id = tid
        names, arrays = self._normalize(feed)
        akey = self._affinity_key(names, arrays)
        deadline = (
            time.monotonic() + float(timeout_ms) / 1e3
            if timeout_ms is not None else None)
        self._metrics.count("requests")
        fr = _flight.get()
        rec = _spans.recording() or fr is not None
        if not rec:
            _, routs = self._route(names, arrays, timeout_ms, deadline, tid,
                                   priority=priority, precision=precision,
                                   affinity_key=akey)
            return routs
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        sid = _spans.new_span_id()
        # capture this thread's wire/request span(s) — a requeued
        # request records one per attempted backend, and the flight
        # record should show every hop it took
        cap: List[Dict] = []
        extra_spans: List[Dict] = []
        try:
            with _spans.trace_context((tid,)):
                with _spans.parent_scope(sid):
                    with _spans.capture(cap):
                        rmeta, routs = self._route(
                            names, arrays, timeout_ms, deadline, tid,
                            priority=priority, precision=precision,
                            affinity_key=akey)
            extra_spans = list(rmeta.get("spans") or ())
            return routs
        except BaseException as e:  # noqa: BLE001 — observed, re-raised
            err = e
            raise
        finally:
            dur = time.perf_counter() - t0
            with _spans.trace_context((tid,)):
                _spans.record_span(
                    "serving/client_infer", t0, dur, cat="client",
                    span_id=sid, error=err is not None, fleet=self.name)
            if fr is not None:
                _flight_report(fr, tid, sid, t0, dur, err,
                               cap + extra_spans, fleet=self.name)

    # hot-path: begin fleet_dispatch (acquire -> wire exchange -> release;
    # the only waits are the bounded capacity CV, the retry budget's
    # jittered backoff, and socket I/O)
    def _route(self, names, arrays, timeout_ms, deadline, tid,
               priority=None, precision=None, affinity_key=None):
        t_submit = time.perf_counter()
        extra = {"precision": str(precision)} if precision is not None else None
        budget = self._retry_policy.budget(
            deadline=deadline, op="fleet.requeue")
        exclude: Optional[_Backend] = None
        while True:
            be = self._acquire(exclude, deadline, affinity_key)
            remaining_ms = timeout_ms
            if deadline is not None:
                remaining_ms = (deadline - time.monotonic()) * 1e3
                if remaining_ms <= 0:
                    # expired while acquiring: a deadline is a typed END
                    # STATE — it must never reach the socket as a 0s
                    # timeout (non-blocking mode), which would read as a
                    # backend failure and retire a healthy fleet.  The
                    # release is NEUTRAL (ok=False only decrements): the
                    # backend never saw the request, so neither its
                    # executed count nor its failure streak may move
                    self._release(be, ok=False)
                    self._metrics.count("expired")
                    raise DeadlineExceeded(
                        "deadline passed before the wire exchange")
            try:
                # the fault gate lives INSIDE the try: an error-mode
                # injection follows the exact release/requeue path a real
                # transport failure takes (never leaks the in-flight slot)
                if _faults.active is not None:  # disarmed: one is-None gate
                    _faults.active.faultpoint(
                        "fleet.dispatch", backend=be.name,
                        pid=be.handle.pid if be.handle is not None else None)
                rmeta, routs = wire_call(
                    be.transport, names, arrays, remaining_ms, tid,
                    priority=priority, extra_meta=extra)
            except _RETRYABLE:
                # retryable: the process died mid-exchange (no response
                # ever arrived), answered that it is shutting down, or
                # the frame corrupted in flight — the request did NOT
                # complete there, so re-sending a stateless inference to
                # a survivor cannot double-run anything
                self._release(be, ok=False)
                self._record_failure(be)
                if deadline is not None and time.monotonic() >= deadline:
                    # fail fast typed at the REQUEUE site: an expired
                    # request must not burn another retry/backend slot
                    self._metrics.count("expired")
                    raise DeadlineExceeded(
                        "deadline passed at requeue after backend failure")
                if not self._throttle.try_acquire():
                    # the token bucket is the anti-storm backstop: a dry
                    # bucket means the fleet's own re-dispatches have
                    # become the load — propagate the failure instead
                    self._throttled_counter.inc()
                    self._metrics.count("failed")
                    raise
                if not budget.backoff():
                    self._metrics.count("failed")
                    raise
                self._count_requeue(be)
                exclude = be
                continue
            except ServerOverloaded as e:
                # the backend ANSWERED (it is alive and shedding):
                # release clean, learn its load report, and honor its
                # retry hint — routing skips it until the hint elapses,
                # so a sick backend never sees a retry storm
                self._release(be, ok=True)
                self._update_load(be, getattr(e, "load", None))
                hint_ms = getattr(e, "retry_after_ms", None)
                if hint_ms:
                    with self._route_cv:
                        be.not_before = max(
                            be.not_before,
                            time.monotonic() + float(hint_ms) / 1e3)
                self._metrics.count("shed")
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                # paced re-dispatch (another backend may have room; this
                # one is paused by not_before): token bucket first, then
                # the jittered backoff budget — either refusing means
                # the shed propagates with its hint intact
                if not self._throttle.try_acquire():
                    self._throttled_counter.inc()
                    raise
                if not budget.backoff():
                    raise
                exclude = be
                continue
            except _errors.ServingError as e:
                # typed end states from a LIVE backend: deadline /
                # validation answers propagate; they also clear the
                # backend's failure streak (it answered)
                self._release(be, ok=True)
                self._update_load(be, getattr(e, "load", None))
                self._metrics.count(
                    "expired" if isinstance(e, DeadlineExceeded)
                    else "failed")
                raise
            except BaseException:
                # anything non-serving (an injected builtin error type, a
                # bug in the transport): the slot must still release, and
                # it counts as a backend failure like any other
                self._release(be, ok=False)
                self._record_failure(be)
                self._metrics.count("failed")
                raise
            self._release(be, ok=True)
            self._update_load(be, rmeta.get("load"))
            self._metrics.observe_request(
                time.perf_counter() - t_submit, trace_id=tid)
            return rmeta, routs
    # hot-path: end fleet_dispatch

    def _normalize(self, feed) -> Tuple[List[str], List[np.ndarray]]:
        names, _ = self._endpoint_shape()
        if not isinstance(feed, dict):
            feed = dict(zip(names, feed))
        if set(feed) != set(names):
            raise ValueError(
                "feed names %s != endpoint inputs %s"
                % (sorted(feed), sorted(names)))
        return names, [feed[n] for n in names]

    def _endpoint_shape(self) -> Tuple[List[str], List[str]]:
        with self._shape_lock:
            if self._feed_names is None:
                last_err: Optional[BaseException] = None
                for be in list(self._backends):
                    try:
                        doc = be.transport.get_json("/healthz")
                        self._feed_names = [
                            str(n) for n in doc["input_names"]]
                        self._fetch_names = [
                            str(n) for n in doc["output_names"]]
                        break
                    except ServingError as e:
                        last_err = e
                else:
                    raise last_err or ServingError(
                        "no backend answered /healthz")
            return self._feed_names, self._fetch_names

    def infer_named(self, feed, timeout_ms: Optional[float] = None,
                    trace_id: Optional[str] = None,
                    priority: Optional[int] = None) -> Dict[str, np.ndarray]:
        _, fetch_names = self._endpoint_shape()
        return dict(zip(fetch_names,
                        self.infer(feed, timeout_ms, trace_id=trace_id,
                                   priority=priority)))

    def infer_many(self, feeds, timeout_ms: Optional[float] = None,
                   priority: Optional[int] = None
                   ) -> List[List[np.ndarray]]:
        """Scatter/gather through a PERSISTENT worker pool: long-lived
        threads keep the transports' per-thread keep-alive connections
        warm across calls (fresh threads would redial every request)."""
        tids = [monitor.new_trace_id() for _ in feeds]
        self.last_trace_ids = tids
        futures = [
            self._executor().submit(self.infer, f, timeout_ms, trace_id=t,
                                    priority=priority)
            for f, t in zip(feeds, tids)
        ]
        return [f.result() for f in futures]

    def _executor(self):
        with self._shape_lock:
            if self._pool is None:
                import concurrent.futures

                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="wire-fleet")
            return self._pool

    def infer_stream(self, feed, timeout_ms: Optional[float] = None,
                     trace_id: Optional[str] = None,
                     priority: Optional[int] = None,
                     max_new_tokens: Optional[int] = None,
                     speculative: Optional[bool] = None):
        """Stream generated-token chunks through the fleet: the request
        routes like ``infer`` (least loaded, retry pacing, requeue), and
        a failure BEFORE the first message — unreachable backend, shed,
        shutdown answer — requeues to a survivor with the same throttle
        and backoff discipline, so opening a stream is as fault-tolerant
        as a unary call.  Once the first message arrives the stream is
        COMMITTED to its backend: generated tokens were already handed
        to the caller, so a mid-stream death re-raises typed
        (``BackendUnavailable``) instead of silently replaying the
        sequence on a survivor — the caller decides whether to resubmit.
        Every chunk carries one trace id (``last_trace_id``); the final
        meta lands in ``last_stream_final``.  ``speculative=True`` asks
        the backend to decode this stream with its draft model
        (greedy-exact, so the tokens are identical either way); the
        backend must have been loaded with a ``draft`` manifest."""
        tid = trace_id or monitor.new_trace_id()
        self.last_trace_id = tid
        names, arrays = self._normalize(feed)
        akey = self._affinity_key(names, arrays)
        deadline = (
            time.monotonic() + float(timeout_ms) / 1e3
            if timeout_ms is not None else None)
        self._metrics.count("requests")
        extra = {}
        if max_new_tokens is not None:
            extra["max_new_tokens"] = int(max_new_tokens)
        if speculative is not None:
            extra["speculative"] = bool(speculative)
        budget = self._retry_policy.budget(
            deadline=deadline, op="fleet.requeue")
        exclude: Optional[_Backend] = None
        while True:
            be = self._acquire(exclude, deadline, akey)
            remaining_ms = timeout_ms
            if deadline is not None:
                remaining_ms = (deadline - time.monotonic()) * 1e3
                if remaining_ms <= 0:
                    self._release(be, ok=False)
                    self._metrics.count("expired")
                    raise DeadlineExceeded(
                        "deadline passed before the wire exchange")
            try:
                if _faults.active is not None:  # disarmed: one is-None gate
                    _faults.active.faultpoint(
                        "fleet.dispatch", backend=be.name,
                        pid=be.handle.pid if be.handle is not None else None)
                it, first = wire_stream_open(
                    be.transport, names, arrays, remaining_ms, tid,
                    extra_meta=extra, priority=priority)
            except _RETRYABLE:
                # nothing streamed yet: the exact unary requeue
                # discipline applies (stateless until the first chunk)
                self._release(be, ok=False)
                self._record_failure(be)
                if deadline is not None and time.monotonic() >= deadline:
                    self._metrics.count("expired")
                    raise DeadlineExceeded(
                        "deadline passed at requeue after backend failure")
                if not self._throttle.try_acquire():
                    self._throttled_counter.inc()
                    self._metrics.count("failed")
                    raise
                if not budget.backoff():
                    self._metrics.count("failed")
                    raise
                self._count_requeue(be)
                exclude = be
                continue
            except ServerOverloaded as e:
                self._release(be, ok=True)
                self._update_load(be, getattr(e, "load", None))
                hint_ms = getattr(e, "retry_after_ms", None)
                if hint_ms:
                    with self._route_cv:
                        be.not_before = max(
                            be.not_before,
                            time.monotonic() + float(hint_ms) / 1e3)
                self._metrics.count("shed")
                if deadline is not None and time.monotonic() >= deadline:
                    raise
                if not self._throttle.try_acquire():
                    self._throttled_counter.inc()
                    raise
                if not budget.backoff():
                    raise
                exclude = be
                continue
            except _errors.ServingError as e:
                self._release(be, ok=True)
                self._update_load(be, getattr(e, "load", None))
                self._metrics.count(
                    "expired" if isinstance(e, DeadlineExceeded)
                    else "failed")
                raise
            except BaseException:
                self._release(be, ok=False)
                self._record_failure(be)
                self._metrics.count("failed")
                raise
            return self._make_stream(be, it, first, tid)

    def _make_stream(self, be: _Backend, it, first, tid: str):
        # a generator abandoned BEFORE its first next() never enters its
        # body, so _stream_chunks' finally can't run and the backend's
        # in-flight slot would leak forever — a GC finalizer covers that
        # window.  ``settled`` makes release one-shot; the finalizer and
        # the generator body can't race (the finalizer only fires once
        # the generator is unreachable, i.e. not executing).
        settled = [False]

        def _abandoned():
            if settled[0]:
                return
            settled[0] = True
            close = getattr(it, "close", None)
            if close is not None:
                close()
            self._release(be, ok=False)  # neutral: not a backend failure

        gen = self._stream_chunks(be, it, first, tid, settled)
        weakref.finalize(gen, _abandoned)
        return gen

    def _stream_chunks(self, be: _Backend, it, first, tid: str,
                       settled: List[bool]):
        t_submit = time.perf_counter()
        fr = _flight.get()
        sid = (_spans.new_span_id()
               if (_spans.recording() or fr is not None) else None)
        err: Optional[BaseException] = None
        clean = False
        counter = [0]
        try:
            rmeta = yield from pump_stream_messages(it, first, counter)
            self.last_stream_final = rmeta
            self._update_load(be, rmeta.get("load"))
            self._metrics.observe_request(
                time.perf_counter() - t_submit, trace_id=tid)
            clean = True
            return
        except GeneratorExit:
            raise  # abandoned: neutral, not a request failure
        except BaseException as e:  # noqa: BLE001 — observed, re-raised
            err = e
            raise
        finally:
            if not settled[0]:
                settled[0] = True
                close = getattr(it, "close", None)
                if close is not None:
                    close()
                if clean:
                    self._release(be, ok=True)
                elif err is None:
                    # abandoned: neutral — the slot frees, the backend's
                    # failure streak does not move
                    self._release(be, ok=False)
                elif (isinstance(err, _errors.ServingError)
                        and not isinstance(err, _RETRYABLE)):
                    # an in-band typed answer (deadline, overload...):
                    # the backend SERVED it — same accounting as the
                    # unary path (release ok, expired vs failed split)
                    self._release(be, ok=True)
                    self._update_load(be, getattr(err, "load", None))
                    self._metrics.count(
                        "expired" if isinstance(err, DeadlineExceeded)
                        else "failed")
                else:
                    # transport death / protocol break mid-stream
                    self._release(be, ok=False)
                    if isinstance(err, _RETRYABLE):
                        self._record_failure(be)
                    self._metrics.count("failed")
            dur = time.perf_counter() - t_submit
            if sid is not None:
                with _spans.trace_context((tid,)):
                    _spans.record_span(
                        "serving/client_stream", t_submit, dur,
                        cat="client", span_id=sid, chunks=counter[0],
                        error=err is not None, fleet=self.name,
                        backend=be.name)
            if fr is not None:
                # the stream's flight record names the backend that
                # served it: /tracez answers "which process decoded this
                # stream" without correlating server-side logs
                span = {
                    "name": "serving/client_stream", "cat": "client",
                    "id": sid, "ts": _spans.wall_ts(t_submit), "dur": dur,
                    "tid": threading.get_ident(), "trace_ids": [tid],
                    "chunks": counter[0], "fleet": self.name,
                    "backend": be.name,
                }
                if err is not None:
                    span["error"] = True
                if fr.get_record(tid) is not None:
                    fr.add_span(tid, span)
                elif clean or err is not None:
                    # abandonment (err None, not clean) is neutral: it
                    # must not occupy the bounded ring
                    status = ("ok" if err is None else
                              "deadline" if isinstance(err, DeadlineExceeded)
                              else "error")
                    fr.consider(tid, dur, status, [span],
                                fleet=self.name, backend=be.name)

    # ------------------------------------------------------------------
    # health checking + rolling replacement
    # ------------------------------------------------------------------
    def _health_loop(self, interval_s: float) -> None:
        # each backend owns a de-phased probe clock (see _probe_jitter):
        # N backends must not fire /healthz in lockstep at a server that
        # is just recovering.  The same loop runs the circuit breaker's
        # re-admission pass for retired backends.
        rng = random.Random("probe-jitter:%s" % self.name)
        now = time.monotonic()
        with self._route_cv:
            for be in self._backends:
                be.next_probe_at = now + interval_s * rng.random()
        while True:
            with self._route_cv:
                targets = [b for b in self._backends if b.alive]
            now = time.monotonic()
            for be in targets:
                if be.next_probe_at > now:
                    continue
                be.next_probe_at = now + _probe_jitter(interval_s, rng)
                self._health_counter.inc()
                try:
                    doc = be.transport.get_json("/healthz", timeout_s=2.0)
                    healthy = bool(doc.get("ok"))
                except ServingError:
                    healthy = False
                if healthy:
                    be.consec_health_failures = 0
                    continue
                self._health_failures.inc()
                be.consec_health_failures += 1
                if be.consec_health_failures >= _BACKEND_FAIL_LIMIT:
                    with self._route_cv:
                        if be.alive:
                            self._retire_locked(be, "health checks")
            # observability federation rides the same background loop
            # (never the request path): scrape due backends' admin
            # surfaces into the cache the admin endpoints serve from
            if self._admin_server is not None:
                self._scrape_pass()
            self._reanimate()
            with self._route_cv:
                nxt = min((b.next_probe_at for b in self._backends
                           if b.alive), default=now + interval_s)
            wait = max(0.01, min(interval_s, nxt - time.monotonic()))
            if self._health_stop.wait(wait):
                return

    # ------------------------------------------------------------------
    # circuit-breaker re-admission: retired -> (cooldown) -> half-open
    # probe -> rejoined, with the supervisor reviving dead processes
    # ------------------------------------------------------------------
    def _reanimate(self) -> None:
        """One re-admission pass.  A backend retired for FAILURES (not
        removed by an operator/rolling replacement) whose cooldown
        elapsed goes half-open: a dead child process is first revived
        through the supervisor (capped-backoff relaunch), then ONE
        ``/healthz`` probe decides — success rejoins routing with one
        remaining strike, failure restarts the cooldown.  Runs on the
        health thread; also callable directly (tests, no-thread use)."""
        now = time.monotonic()
        with self._route_cv:
            candidates = [
                b for b in self._backends
                if not b.alive and not b.removed and not b.give_up
                and now - b.retired_at >= self._cooldown_s
            ]
        for be in candidates:
            if be.handle is not None and be.handle.poll() is not None:
                if self._supervisor is None:
                    continue  # process is gone and nothing can revive it
                try:
                    handle = self._supervisor.revive(be.handle)
                except RelaunchFailed:
                    with self._route_cv:
                        be.give_up = True
                    continue
                if self._warmed:
                    # the fleet promised zero recompiles: a revived child
                    # warms before it can rejoin routing
                    try:
                        handle.warmup()
                    except ServingError:
                        handle.kill()
                        with self._route_cv:
                            be.retired_at = time.monotonic()
                        continue
                with self._route_cv:
                    old_transport = be.transport
                    be.handle = handle
                    be.transport = HttpTransport(
                        handle.host, handle.port, timeout_s=self._timeout_s)
                    be.name = "b%d@%s:%d" % (be.idx, handle.host, handle.port)
                old_transport.close()
            self._halfopen_probes.inc()
            try:
                ok = bool(be.transport.get_json(
                    "/healthz", timeout_s=2.0).get("ok"))
            except ServingError:
                ok = False
            with self._route_cv:
                if be.removed or be.alive:
                    continue
                if ok:
                    be.alive = True
                    be.consec_health_failures = 0
                    # half-open: ONE remaining strike — the next request
                    # failure re-retires immediately, a success resets
                    be.consec_failures = _BACKEND_FAIL_LIMIT - 1
                    # a rejoined backend starts with a clean load slate:
                    # pre-retirement reports and pauses describe a
                    # process state that no longer exists
                    be.not_before = 0.0
                    be.load_ts = None
                    self._route_cv.notify_all()
                else:
                    be.retired_at = time.monotonic()
            if ok:
                _events.emit(
                    "wire/backend_readmitted", severity="info", cat="wire",
                    fleet=self.name, backend=be.name)

    def check_health(self) -> Dict[str, bool]:
        """One synchronous probe round (bench/test convenience; the
        background loop does this continuously)."""
        out = {}
        for be in list(self._backends):
            self._health_counter.inc()
            try:
                doc = be.transport.get_json("/healthz", timeout_s=2.0)
                out[be.name] = bool(doc.get("ok"))
            except ServingError:
                self._health_failures.inc()
                out[be.name] = False
        return out

    # ------------------------------------------------------------------
    # observability federation: scrape cache + fleet-merged admin docs
    # ------------------------------------------------------------------
    def _scrape_backend(self, be: _Backend) -> None:
        """Fetch one backend's observability surfaces into the cache.
        Partial failure keeps the previous (stale) docs — the federated
        view degrades to older data, never to a hole."""
        docs: Dict[str, object] = {}
        ok = True
        try:
            docs["metrics_text"] = be.transport.get_text(
                "/metrics", timeout_s=2.0)
        except (ServingError, NotImplementedError):
            ok = False
        for key, path in (("statusz", "/statusz"), ("tracez", "/tracez"),
                          ("eventz", "/eventz")):
            try:
                docs[key] = be.transport.get_json(path, timeout_s=2.0)
            except ServingError:
                ok = False
        (self._scrape_ok if ok else self._scrape_err).inc()
        if not docs:
            return
        with self._scrape_lock:
            ent = self._scrapes.setdefault(be.idx, {})
            ent.update(docs)
            ent["backend"] = be.name
            ent["ts"] = time.monotonic()
            ent["wall_ts"] = time.time()

    def _scrape_pass(self, force: bool = False) -> None:
        """One scrape round over live backends whose per-backend clock
        is due (``force`` ignores the clocks), then refresh the
        worst-case staleness gauge."""
        with self._route_cv:
            targets = [b for b in self._backends if b.alive]
            targets.extend(self._scrape_only)
        now = time.monotonic()
        for be in targets:
            with self._scrape_lock:
                due = self._scrapes.get(be.idx, {}).get("next_at", 0.0)
            if not force and due > now:
                continue
            with self._scrape_lock:
                self._scrapes.setdefault(be.idx, {})["next_at"] = (
                    now + self._scrape_interval_s)
            self._scrape_backend(be)
        with self._scrape_lock:
            ages = [time.monotonic() - s["ts"]
                    for b in targets
                    for s in (self._scrapes.get(b.idx),)
                    if s is not None and "ts" in s]
        if ages:
            self._staleness.set(round(max(ages), 3))

    def scrape_once(self) -> None:
        """Synchronously refresh every live backend's cached
        observability docs (bench/test convenience; the health loop
        does this continuously once the admin tier is up)."""
        self._scrape_pass(force=True)

    def _scrape_snapshot(self) -> List[Dict[str, object]]:
        with self._scrape_lock:
            return [dict(self._scrapes[i]) for i in sorted(self._scrapes)
                    if "backend" in self._scrapes[i]]

    def federated_metrics(self) -> str:
        """The balancer's own registry plus every scraped child
        exposition re-labeled ``backend=<id>`` (an already-labeled
        child — itself a federating balancer — gets prefixed, so a
        routing tree federates transitively), merged into one
        Prometheus text-0.0.4 document."""
        parts = [_registry.parse_exposition(monitor.render_text())]
        for s in self._scrape_snapshot():
            text = s.get("metrics_text")
            if not text:
                continue
            parts.append(_registry.relabel_exposition(
                _registry.parse_exposition(text), "backend",
                str(s["backend"])))
        return _registry.render_exposition(
            _registry.merge_expositions(parts))

    def federated_statusz(self) -> Dict[str, object]:
        """Fleet-merged ``/statusz``: the balancer's own routing view,
        every child's cached statusz verbatim, and TRUE cross-fleet
        aggregates over the scraped expositions (summed counters,
        bucket-merged histograms with estimated quantiles, worst-case
        gauges)."""
        now = time.monotonic()
        scrapes = self._scrape_snapshot()
        children = {}
        parts = []
        for s in scrapes:
            entry: Dict[str, object] = {
                "age_s": round(now - s["ts"], 3) if "ts" in s else None}
            if "statusz" in s:
                entry["statusz"] = s["statusz"]
            children[str(s["backend"])] = entry
            if s.get("metrics_text"):
                parts.append(_registry.parse_exposition(s["metrics_text"]))
        return {
            "fleet": self.name,
            "role": "balancer",
            "balancer": self.metrics(),
            "backends": children,
            "aggregate": _registry.aggregate_families(
                _registry.merge_expositions(parts)),
        }

    def federated_tracez(self) -> Dict[str, object]:
        """One slow-request list across the fleet: the balancer's own
        flight recorder plus every child's cached ``/tracez``, records
        tagged with the backend they came from (trace trees intact),
        newest first."""
        requests: List[Dict[str, object]] = []
        retained: Dict[str, int] = {}
        fr = _flight.get()
        if fr is not None:
            own = fr.statusz()
            retained["_balancer"] = own.get("retained", 0)
            for r in own.get("requests", ()):
                r = dict(r)
                r["backend"] = "_balancer"
                requests.append(r)
        for s in self._scrape_snapshot():
            doc = s.get("tracez")
            if not isinstance(doc, dict):
                continue
            name = str(s["backend"])
            retained[name] = doc.get("retained", 0)
            for r in doc.get("requests", ()):
                r = dict(r)
                r["backend"] = name
                requests.append(r)
        requests.sort(key=lambda r: r.get("ts") or 0.0, reverse=True)
        return {"fleet": self.name, "role": "balancer",
                "backends": retained, "requests": requests}

    def federated_eventz(self) -> Dict[str, object]:
        """Fleet-merged operational event tail: the balancer's own ring
        plus every child's cached ``/eventz``, backend-tagged, ordered
        by wall timestamp."""
        merged: List[Dict[str, object]] = []
        own = _events.eventz()
        for e in own.get("events", ()):
            e = dict(e)
            e["backend"] = "_balancer"
            merged.append(e)
        backends = {"_balancer": own.get("retained", 0)}
        for s in self._scrape_snapshot():
            doc = s.get("eventz")
            if not isinstance(doc, dict):
                continue
            name = str(s["backend"])
            backends[name] = doc.get("retained", 0)
            for e in doc.get("events", ()):
                e = dict(e)
                e["backend"] = name
                merged.append(e)
        merged.sort(key=lambda e: e.get("ts") or 0.0)
        return {"fleet": self.name, "role": "balancer",
                "backends": backends, "events": merged}

    def admin_healthz(self) -> Dict[str, object]:
        with self._route_cv:
            alive = sum(1 for b in self._backends if b.alive)
            total = len(self._backends)
            closed = self._closed
        return {"ok": not closed and alive > 0, "role": "balancer",
                "fleet": self.name, "backends_alive": alive,
                "backends_total": total}

    # ------------------------------------------------------------------
    # admin HTTP tier: the balancer's own pane of glass
    # ------------------------------------------------------------------
    def start_admin(self, port: int = 0) -> Tuple[str, int]:
        """Serve the federated observability surface from this balancer:
        ``/healthz /metrics /statusz /tracez /sloz /eventz`` (GET) and
        ``/quitquitquit`` (POST).  ``port=0`` binds an ephemeral port;
        returns the bound ``(host, port)`` (also ``admin_address``).
        Starting the admin tier is what arms the federation scraper on
        the health loop — a balancer without one never scrapes."""
        if self._admin_server is not None:
            return self.admin_address
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        fleet = self

        class _AdminHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet, like the wire server
                pass

            def _send(self, status: int, body: bytes, ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (ConnectionError, BrokenPipeError):
                    pass

            def _send_json(self, doc, status: int = 200) -> None:
                self._send(status, json.dumps(doc).encode("utf-8"),
                           "application/json; charset=utf-8")

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/healthz":
                        self._send_json(fleet.admin_healthz())
                    elif path == "/metrics":
                        self._send(
                            200,
                            fleet.federated_metrics().encode("utf-8"),
                            "text/plain; version=0.0.4; charset=utf-8")
                    elif path == "/statusz":
                        self._send_json(fleet.federated_statusz())
                    elif path == "/tracez":
                        self._send_json(fleet.federated_tracez())
                    elif path == "/sloz":
                        self._send_json(_slo.sloz())
                    elif path == "/eventz":
                        self._send_json(fleet.federated_eventz())
                    else:
                        self.send_error(404, "unknown path")
                except Exception as e:  # noqa: BLE001 — typed to the peer
                    self._send_json({"error": type(e).__name__,
                                     "message": str(e)}, status=500)

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path == "/quitquitquit":
                    self._send_json({"ok": True, "admin_stopping": True})
                    threading.Thread(
                        target=fleet._stop_admin,
                        name="fleet-admin-quit", daemon=True).start()
                else:
                    self.send_error(404, "unknown path")

        class _QuietAdminServer(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                import sys
                exc = sys.exc_info()[1]
                if isinstance(exc, (ConnectionError, BrokenPipeError)):
                    return
                super().handle_error(request, client_address)

        srv = _QuietAdminServer(("127.0.0.1", int(port)), _AdminHandler)
        self._admin_server = srv
        self._admin_thread = threading.Thread(
            target=srv.serve_forever,
            name="fleet-admin-%s" % self.name, daemon=True)
        self._admin_thread.start()
        # first federated view without waiting a full scrape interval
        try:
            self.scrape_once()
        except Exception:
            pass
        return self.admin_address

    @property
    def admin_address(self) -> Optional[Tuple[str, int]]:
        """Bound ``(host, port)`` of the admin tier, or None."""
        srv = self._admin_server
        if srv is None:
            return None
        return srv.server_address[0], srv.server_address[1]

    def _stop_admin(self) -> None:
        srv, self._admin_server = self._admin_server, None
        thread, self._admin_thread = self._admin_thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def rolling_replace(self, warmup: bool = True,
                        drain_timeout_s: float = 30.0
                        ) -> List[_launch.ServerHandle]:
        """Replace every LAUNCHED backend with a fresh child, one at a
        time: launch new -> (optionally) warm it -> add to routing ->
        drain the old -> shut it down.  Routable capacity never drops
        below the current live count, and a cold backend never sees
        traffic.  Backends constructed from bare addresses are skipped
        (nothing to relaunch)."""
        new_handles: List[_launch.ServerHandle] = []
        with self._route_cv:
            olds = [b for b in self._backends
                    if b.alive and b.handle is not None]
        for old in olds:
            handle = _launch.relaunch(old.handle)
            if warmup:
                handle.warmup()
            with self._route_cv:
                be = self._add_backend_obj(len(self._backends), handle)
                self._route_cv.notify_all()
            new_handles.append(handle)
            # drain: stop routing to the old backend, let its in-flight
            # requests finish, then ask the process to exit gracefully.
            # removed (not retired): re-admission must never resurrect a
            # deliberately replaced backend
            with self._route_cv:
                old.alive = False
                old.removed = True
                self._route_cv.notify_all()
                deadline = time.monotonic() + drain_timeout_s
                while old.in_flight > 0 and time.monotonic() < deadline:
                    self._route_cv.wait(timeout=0.1)
            _events.emit(
                "wire/backend_replaced", severity="info", cat="wire",
                fleet=self.name, old=old.name, new=be.name)
            old.handle.shutdown(timeout_s=drain_timeout_s)
            old.transport.close()
        return new_handles

    # ------------------------------------------------------------------
    def stop(self, shutdown_backends: bool = False,
             timeout_s: float = 30.0) -> None:
        """Stop balancing (in-flight requests finish; new ones are
        refused typed).  ``shutdown_backends=True`` additionally drains
        and exits every LAUNCHED child."""
        with self._route_cv:
            if self._closed:
                return
            self._closed = True
            self._route_cv.notify_all()
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
        self._stop_admin()
        # retire this fleet's federation series from the exposition
        FEDERATION_SCRAPES.remove_labels(fleet=self.name, status="ok")
        FEDERATION_SCRAPES.remove_labels(fleet=self.name, status="error")
        FEDERATION_STALENESS.remove_labels(fleet=self.name)
        with self._shape_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        if shutdown_backends:
            for be in self._backends:
                if be.handle is not None:
                    be.handle.shutdown(timeout_s=timeout_s)
        for be in self._backends:
            be.transport.close()
        for be in self._scrape_only:
            be.transport.close()
        self._metrics.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
