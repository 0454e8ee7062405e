"""InferenceServer: a dynamic-batching front end over AnalysisPredictor.

The port of the JAX package's ``serving/server.py``.  N replica worker
threads (one per predictor) sit behind one bounded queue and
``DynamicBatcher``; a dispatcher routes each coalesced batch to the
least-loaded live replica (per-replica in-flight accounting), and a
``BucketPolicy`` pads every batch onto a fixed ladder of batch sizes, so
each replica's executor sees a closed set of feed signatures.
``warmup()`` runs every rung, for every precision dtype the endpoint
serves, on every replica, one replica at a time; on a card each (rung,
dtype) pair is then a captured CUDA graph, so steady-state serving
captures nothing (``metrics()['recompiles']`` counts cache entries built
after warmup, ``jit_cache_stats()['graphs']`` the graphs).

Replicas on one card: each predictor has its own executor (its own
capture stream and graph memory pools), and each replica dispatches and
replays on a CUDA stream of its own, so one replica's host work overlaps
the other's device work.  Inside each replica's loop the dispatch is
double-buffered: batch N+1 is merged, padded and dispatched before batch
N's outputs are waited for, and N's copy to the host is queued right
behind N's kernels.

Replica fleet semantics: a batch whose replica fails is re-routed to a
live replica (accepted requests never drop while a survivor is left); a
replica that fails repeatedly is retired from routing (and re-admitted
for one probe batch after ``readmit_cooldown_s``, when set), and
``remove_replica()`` drains one gracefully at runtime.  Under sustained
queue pressure the brownout ladder (``admission.BrownoutController``)
drops flight capture (L1), batches eagerly (L2) and sheds the lowest
priority class at the door (L3).

Lifecycle: construct (workers start) -> ``warmup()`` -> ``submit()`` /
``Client`` traffic -> ``stop(drain=True)`` for a graceful drain.

Observability: metrics live in the process registry
(``paddle_tpu_torch.monitor``); ``start_admin()`` binds a localhost HTTP
surface with ``/metrics`` (Prometheus text, or OpenMetrics with
exemplars when the scraper asks for it), ``/statusz`` (this server's
metrics, per-replica health, the predictors' cache stats and the
registry) and ``/tracez`` (the flight recorder's tail-sampled slow or
failed requests).  Each request carries a trace id through the queue
wait, the batch, the predictor and the executor's spans; replica workers
register named thread lanes for the merged trace.  The fault points
``server.admit`` and ``replica.dispatch`` gate admission and each
replica's dispatch.
"""
from __future__ import annotations

import contextlib
import inspect
import json
import queue
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import monitor, profiler
from paddle_tpu_torch.core.types import PRECISION_ALIASES as _PRECISION_ALIASES
from paddle_tpu_torch.faults.metrics import BACKEND_HALFOPEN_PROBES
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import spans as _mon_spans
from paddle_tpu_torch.scope import to_numpy
from paddle_tpu_torch.serving.admission import (
    ADMISSION_EXPIRED,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    BrownoutController,
)
from paddle_tpu_torch.serving.batching import DynamicBatcher, ServingRequest
from paddle_tpu_torch.serving.bucketing import BucketPolicy
from paddle_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
    ServingError,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics

__all__ = ["InferenceServer"]

# dispatched-but-not-finalized batches a replica may hold: one executing
# (its copy to the host pending) and one queued behind it.  The batcher's
# queue, not the replica queues, stays the admission buffer.
_MAX_IN_FLIGHT = 2

# consecutive batch failures before a replica is retired from routing
_REPLICA_FAIL_LIMIT = 3

# safety-net bound for the routing capacity wait (real wakeups are
# notifies from _release / _retire_replica / stop)
_ROUTE_WAIT_S = 0.5


class _Replica:
    """One predictor behind the shared batcher: its own worker thread,
    CUDA stream (on a card), bounded in-flight accounting and health."""

    __slots__ = ("idx", "name", "predictor", "nonblocking", "precision", "device", "stream",
                 "lock", "q", "thread", "alive", "in_flight", "executed", "failed",
                 "consec_failures", "retired_at", "removed")

    def __init__(self, idx: int, predictor):
        self.idx = idx
        self.name = "r%d" % idx
        self.predictor = predictor
        # a predictor whose run_padded takes return_numpy hands back device
        # tensors without waiting (batch N's copy to the host overlaps
        # batch N+1's dispatch); precision= is detected the same way, so a
        # duck-typed predictor without them runs synchronously in fp32
        try:
            params = inspect.signature(predictor.run_padded).parameters
            self.nonblocking = "return_numpy" in params
            self.precision = "precision" in params
        except (TypeError, ValueError):
            self.nonblocking = False
            self.precision = False
        self.device: Optional[torch.device] = getattr(predictor, "device", None)
        # the replica's own stream: replicas that share the default stream
        # would serialise each other's feed copies, replays and read-outs
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device is not None and self.device.type == "cuda" else None)
        self.lock = threading.Lock()  # warmup vs worker predictor use
        self.q: "queue.Queue" = queue.Queue()  # (batch, retries) | None
        self.thread: Optional[threading.Thread] = None
        self.alive = True
        self.in_flight = 0  # guarded by the server's _route_cv
        self.executed = 0
        self.failed = 0
        self.consec_failures = 0
        self.retired_at = None  # monotonic stamp of failure retirement
        self.removed = False    # remove_replica(): never re-admit

    def on_stream(self):
        """The context every predictor call of this replica runs in."""
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()


class InferenceServer:
    """Wraps one or more predictors exposing ``run_padded`` /
    ``jit_cache_stats`` / ``get_input_names`` (AnalysisPredictor) behind
    a batched, bucketed, deadline-aware ``submit()``.

    ``predictor``: a single predictor, or a sequence of predictors, one
    replica each, behind the same queue with least-loaded routing.

    ``input_specs`` (``{name: (per_row_shape, dtype)}``) defaults to the
    first predictor's program-derived specs; pass it explicitly when a
    feed var has dynamic non-batch dims.  ``embedding_cache``: an
    ``EmbeddingRowCache`` bound to every replica's program (sparse
    lookups read through it) and to a 4-rung brownout ladder whose L4
    serves lookups cache-only.
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
        readmit_cooldown_s: Optional[float] = None,
        target_queue_wait_ms: float = 50.0,
        brownout_hold_s: float = 0.25,
        class_weights="default",
        embedding_cache=None,
    ):
        self.name = name
        # circuit-breaker re-admission of a failure-retired replica: after
        # this cooldown it goes half-open and takes one probe batch (it
        # rejoins with a single strike left: the probe's success resets
        # the streak, a failure retires it again).  None keeps retirement
        # terminal.
        self._readmit_cooldown = (float(readmit_cooldown_s)
                                  if readmit_cooldown_s is not None else None)
        predictors = list(predictor) if isinstance(predictor, (list, tuple)) else [predictor]
        if not predictors:
            raise ValueError("InferenceServer needs at least one predictor")
        self._replicas = [_Replica(i, p) for i, p in enumerate(predictors)]
        self._predictor = predictors[0]  # single-replica surface
        self._nonblocking = self._replicas[0].nonblocking
        self._policy = BucketPolicy(max_batch_size, bucket_ladder)
        self._batcher = DynamicBatcher(
            max_batch_size, batch_timeout_ms, queue_capacity, name=name,
            target_wait_ms=target_queue_wait_ms, class_weights=class_weights)
        self._metrics = ServingMetrics(name)
        # queue-level drops (priority eviction, the offer-time sweep) go
        # through the server's accounting
        self._batcher.on_shed = self._on_queue_shed
        self._batcher.on_expired = self._on_expired
        # the hot-id embedding cache, bound to every replica's program so
        # that their sparse lookups read through it
        self._embedding_cache = embedding_cache
        if embedding_cache is not None:
            for p in predictors:
                embedding_cache.bind(p)
        # the degradation ladder, driven by queue pressure from the
        # dispatcher loop and the admission door; with a cache its 4th
        # rung serves lookups cache-only
        thresholds = (BrownoutController.THRESHOLDS + (BrownoutController.CACHE_ONLY_THRESHOLD,)
                      if embedding_cache is not None else None)
        self._brownout = BrownoutController(name, hold_s=brownout_hold_s,
                                            thresholds=thresholds)
        self._admission_expired = ADMISSION_EXPIRED.labels(server=name)
        self._specs = dict(input_specs) if input_specs else predictors[0].input_specs()
        self._feed_names = list(predictors[0].get_input_names())
        # mixed-precision endpoints: the serving dtypes, default first
        # (AnalysisPredictor.precision_dtypes); warmup runs every rung for
        # every entry, so the per-request choice never builds an entry
        dts = getattr(predictors[0], "precision_dtypes", None)
        if callable(dts) and self._replicas[0].precision:
            self._precision_dtypes = [str(d) for d in dts()]
        else:
            self._precision_dtypes = ["fp32"]
        self._default_dtype = self._precision_dtypes[0]
        # rungs already warmed on every replica (warmup and replan
        # barriers); replan_ladder warms only the delta
        self._warmed_rungs: set = set()
        self._warmup_runs = 0
        self._batches_by_dtype: Dict[str, int] = {}  # guarded by _route_cv
        self._autotune_thread: Optional[threading.Thread] = None
        self._autotune_stop: Optional[threading.Event] = None
        self._replan_lock = threading.Lock()
        self._stop = threading.Event()
        self._closed = False  # admission gate (set before _stop on shutdown)
        self._abort = False   # stop(drain=False): fail instead of route
        self._admin = None    # optional HTTP surface (start_admin)
        self._admin_thread: Optional[threading.Thread] = None
        self._admin_lock = threading.Lock()
        self._warmed = False
        self._route_cv = threading.Condition()  # replica in_flight / alive state
        for rep in self._replicas:
            rep.thread = threading.Thread(
                target=self._replica_loop, args=(rep,),
                name="serving-%s-%s" % (name, rep.name), daemon=True)
            rep.thread.start()
        self._worker = threading.Thread(
            target=self._dispatch_loop, name="serving-%s" % name, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    @property
    def bucket_ladder(self) -> List[int]:
        return list(self._policy.ladder)

    @property
    def max_batch_size(self) -> int:
        return self._policy.max_batch_size

    @property
    def num_replicas(self) -> int:
        """Live (routable) replica count."""
        with self._route_cv:
            return sum(1 for r in self._replicas if r.alive)

    def replica_stats(self) -> Dict[str, Dict[str, object]]:
        """Per-replica health and throughput (the in-flight accounting
        behind least-loaded routing)."""
        with self._route_cv:
            return {
                r.name: {
                    "alive": r.alive,
                    "in_flight": r.in_flight,
                    "executed": r.executed,
                    "failed": r.failed,
                    "nonblocking": r.nonblocking,
                }
                for r in self._replicas
            }

    def metrics(self) -> Dict[str, object]:
        """This server's ``ServingMetrics`` snapshot (requests, completed,
        failed, shed, expired, batches, warmup_compiles, recompiles,
        requeued; latency percentiles, the batch and arrival histograms,
        padding waste, requests by precision), with ``rows`` and
        ``padded_rows`` (valid and bucket rows executed),
        ``precision_batches`` (batches executed by dtype),
        ``warmup_runs`` (the predictor runs of the warm-ups: ``batches +
        warmup_runs`` is the number of dispatches),
        the queue depth, admit limit, brownout level, ladder, batch
        window, queue-wait EWMA, precision dtypes and per-replica
        health."""
        snap = self._metrics.snapshot()
        hist = snap["batch_histogram"]
        snap["rows"] = sum(v["valid_rows"] for v in hist.values())
        snap["padded_rows"] = sum(int(b) * v["batches"] for b, v in hist.items())
        snap["warmup_runs"] = self._warmup_runs
        with self._route_cv:
            snap["precision_batches"] = dict(self._batches_by_dtype)
        snap["queue_depth"] = self._batcher.qsize()
        snap["admit_limit"] = self._batcher.queue.limit
        snap["brownout_level"] = self._brownout.level
        snap["bucket_ladder"] = self.bucket_ladder
        snap["batch_timeout_ms"] = self._batcher.batch_timeout_s * 1e3
        # exported so a recorded /statusz snapshot is a complete input for
        # the ladder autotuner (ladder + histogram + wait EWMA)
        snap["queue_wait_ewma_ms"] = round(self._batcher.queue.wait_ewma_ms, 3)
        snap["precision_dtypes"] = list(self._precision_dtypes)
        snap["warmed_up"] = self._warmed
        snap["replicas"] = self.replica_stats()
        if self._embedding_cache is not None:
            snap["embedding_cache"] = self._embedding_cache.stats()
        return snap

    def load(self) -> Dict[str, object]:
        """The overload-control load report: queue depth, the adaptive
        admit limit and the brownout level."""
        return {
            "queue_depth": self._batcher.qsize(),
            "admit_limit": self._batcher.queue.limit,
            "brownout_level": self._brownout.level,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the whole process registry
        (this server's series are labeled ``server=<name>``)."""
        return monitor.render_text()

    def tracez(self) -> Dict[str, object]:
        """The ``/tracez`` document: the process flight recorder's
        tail-sampled slow, failed or deadline-missed request traces (an
        empty shell when no recorder is installed)."""
        rec = _flight.get()
        if rec is None:
            return {"recorder": False, "retained": 0, "requests": []}
        doc = rec.statusz()
        doc["recorder"] = True
        return doc

    def statusz(self) -> Dict[str, object]:
        """JSON-serializable status: this server's metrics (with the
        bucket occupancy histogram, per-replica health and the recompile
        counter), the predictors' cache stats and the process registry."""
        return {
            "server": self.name,
            "metrics": self.metrics(),
            "jit_cache": self._predictor.jit_cache_stats(),
            "replica_jit_cache": {r.name: r.predictor.jit_cache_stats()
                                  for r in self._replicas},
            "registry": monitor.snapshot(),
        }

    # ------------------------------------------------------------------
    def start_admin(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        """Serve ``/metrics`` (Prometheus text; OpenMetrics 1.0 with
        exemplars when the scraper sends ``Accept:
        application/openmetrics-text``), ``/statusz`` (JSON) and
        ``/tracez`` over HTTP on ``host:port`` (port 0: ephemeral);
        returns the bound ``(host, port)``.  Stopped by ``stop()``."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        server = self

        class _AdminHandler(BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    om = "application/openmetrics-text" in (self.headers.get("Accept") or "")
                    text, ctype = monitor.expose(openmetrics=om)
                    body = text.encode("utf-8")
                elif path == "/statusz":
                    body = json.dumps(server.statusz(), sort_keys=True, default=str).encode("utf-8")
                    ctype = "application/json"
                elif path == "/tracez":
                    body = json.dumps(server.tracez(), sort_keys=True, default=str).encode("utf-8")
                    ctype = "application/json"
                else:
                    self.send_error(404, "unknown path (try /metrics, /statusz or /tracez)")
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # keep scrapes out of stderr
                pass

        with self._admin_lock:
            if self._admin is not None:  # a repeated start reuses it
                return self._admin.server_address
            self._admin = ThreadingHTTPServer((host, port), _AdminHandler)
            self._admin_thread = threading.Thread(
                target=self._admin.serve_forever, name="serving-admin-%s" % self.name,
                daemon=True)
            self._admin_thread.start()
            return self._admin.server_address

    @property
    def admin_address(self) -> Optional[Tuple[str, int]]:
        return self._admin.server_address if self._admin is not None else None

    # ------------------------------------------------------------------
    def warmup(self, cache_dir: Optional[str] = None, configure_cache: bool = True) -> int:
        """Run every bucket rung, for every precision dtype, on every
        replica, so no shape the ladder can produce meets a replica for
        the first time under traffic; returns the predictor runs it made
        (``warmup_runs``), and counts the cache entries they built as
        ``warmup_compiles`` (on the CPU and fresh predictors, one each).
        On a card each (rung, dtype) pair runs twice on each replica's
        stream, the second run capturing its CUDA graph, one replica at a
        time.  Rows are zeros
        (always in range for int id feeds).  After warmup the recompile
        counter arms: an entry built later on any replica increments
        ``metrics()['recompiles']``.  ``cache_dir`` and
        ``configure_cache`` (the JAX package's persistent compilation
        cache) are accepted and unused: nothing here compiles to disk."""
        runs0 = self._warmup_runs
        compiles = self._warm_rungs(self._policy.ladder)
        self._metrics.count("warmup_compiles", compiles)
        self._warmed = True
        return self._warmup_runs - runs0

    def _warm_rungs(self, rungs) -> int:
        """Warm ``rungs`` on every replica for every dtype the endpoint
        serves, skipping rungs already warm; shared by ``warmup()`` and the
        autotuner's re-plan barrier (a new ladder is warmed here while the
        old one still serves).  Returns the cache entries built."""
        compiles = 0
        todo = [b for b in rungs if b not in self._warmed_rungs]
        if not todo:
            return 0
        for rep in self._replicas:  # one replica at a time: one capture at a time
            misses0 = rep.predictor.jit_cache_stats()["misses"]
            passes = 2 if rep.stream is not None else 1  # eager run, then the capture
            for bucket in todo:
                feed = {name: np.zeros((bucket,) + tuple(shape), dtype)
                        for name, (shape, dtype) in self._specs.items()}
                for pdtype in (self._precision_dtypes if rep.precision else (None,)):
                    kw = {"precision": pdtype} if pdtype is not None else {}
                    with rep.lock, rep.on_stream():
                        with profiler.RecordEvent("serving/%s/warmup" % self.name):
                            for _ in range(passes):
                                rep.predictor.run_padded(feed, n_valid=bucket, **kw)
                        if rep.stream is not None:
                            rep.stream.synchronize()
                    self._warmup_runs += passes
            compiles += rep.predictor.jit_cache_stats()["misses"] - misses0
        self._warmed_rungs.update(todo)
        return compiles

    # ------------------------------------------------------------------
    def replan_ladder(self, ladder: Optional[Sequence[int]] = None,
                      batch_timeout_ms: Optional[float] = None,
                      max_rungs: int = 8) -> Dict[str, object]:
        """Re-plan the bucket ladder behind a warmup barrier.

        With ``ladder=None`` the new ladder (and, unless given, the batch
        window) comes from ``serving.autotune.plan`` over this server's
        observed arrival-size histogram and queue-wait EWMA.  New rungs
        are warmed on every replica (every dtype) before the policy is
        swapped, so a re-plan never builds an entry under a request.
        Returns the applied plan; ``serving_ladder_replans_total`` moves
        only when the ladder changed."""
        from paddle_tpu_torch.serving import autotune

        with self._replan_lock:
            proposal = None
            if ladder is None:
                proposal = autotune.plan(
                    self._metrics.arrival_histogram(), self.max_batch_size,
                    self._policy.ladder,
                    queue_wait_ewma_ms=self._batcher.queue.wait_ewma_ms,
                    current_timeout_ms=self._batcher.batch_timeout_s * 1e3,
                    max_rungs=max_rungs)
                ladder = proposal["ladder"]
                if batch_timeout_ms is None:
                    batch_timeout_ms = proposal["batch_timeout_ms"]
            new_policy = BucketPolicy(self.max_batch_size, ladder)
            changed = new_policy.ladder != self._policy.ladder
            compiles = 0
            if changed:
                compiles = self._warm_rungs(new_policy.ladder)  # the barrier
                self._policy = new_policy  # one reference swap
                self._metrics.count_replan()
                monitor.record_instant("serving/ladder_replan", cat="serving",
                                       server=self.name, ladder=str(new_policy.ladder))
            if batch_timeout_ms is not None:
                self._batcher.batch_timeout_s = float(batch_timeout_ms) / 1e3
            return {
                "ladder": list(new_policy.ladder),
                "changed": changed,
                "barrier_compiles": compiles,
                "batch_timeout_ms": (float(batch_timeout_ms) if batch_timeout_ms is not None
                                     else self._batcher.batch_timeout_s * 1e3),
                **({"proposal": proposal} if proposal else {}),
            }

    def start_autotuner(self, interval_s: float = 10.0, max_rungs: int = 8) -> None:
        """Periodic online re-plan: every ``interval_s`` the autotuner
        thread re-derives the ladder and batch window from the live
        arrival histogram and applies a change behind the warmup barrier.
        Idempotent; stopped by ``stop()``."""
        if self._autotune_thread is not None:
            return
        self._autotune_stop = threading.Event()

        def _loop():
            while not self._autotune_stop.wait(interval_s):
                try:
                    self.replan_ladder(max_rungs=max_rungs)
                except Exception as e:  # noqa: BLE001 — a failed re-plan keeps the ladder
                    monitor.record_instant("serving/ladder_replan_error", cat="serving",
                                           server=self.name, error=repr(e))

        self._autotune_thread = threading.Thread(
            target=_loop, name="serving-%s-autotune" % self.name, daemon=True)
        self._autotune_thread.start()

    # ------------------------------------------------------------------
    def submit(self, feed, timeout_ms: Optional[float] = None,
               trace_id: Optional[str] = None, parent_span: Optional[str] = None,
               priority: int = PRIORITY_NORMAL,
               precision: Optional[str] = None) -> ServingRequest:
        """Enqueue one request; returns its future (ServingRequest).

        ``feed``: dict (or positional sequence) of arrays whose shared
        leading dim is the request's row count (1..max_batch_size).
        ``precision``: the variant on a mixed-precision endpoint (None the
        policy default, ``"fp32"`` the opt-out; both are warm); an unknown
        dtype raises ValueError here.  ``priority`` is the admission
        class (lower = more important): a full queue sheds
        strictly-lower-priority entries first, and brownout level 3 sheds
        the lowest class at the door.  ``trace_id`` / ``parent_span`` join
        the request to a caller's trace (``Client`` mints them).  Raises
        ServerOverloaded (with a ``retry_after_ms`` hint) when shed,
        ServerClosed after stop(), and DeadlineExceeded at once for a
        ``timeout_ms`` that is already <= 0 (``admission_expired_total``).
        """
        if self._closed:
            raise ServerClosed("server %r is stopped" % self.name)
        if timeout_ms is not None and float(timeout_ms) <= 0:
            self._admission_expired.inc()
            self._metrics.count("expired")
            raise DeadlineExceeded(
                "deadline exhausted before admission (%.1f ms)" % float(timeout_ms))
        if _faults.active is not None:  # disarmed: one is-None gate
            _faults.active.faultpoint("server.admit", server=self.name, priority=int(priority))
        # the ladder is sampled here too: at L3 the door sheds low priority
        # before anything enqueues, so low-priority-only traffic would never
        # wake the parked dispatcher and the level could latch at 3
        self._apply_brownout(self._brownout.update(self._batcher.depth_ratio()))
        if self._brownout.level >= 3 and int(priority) >= PRIORITY_LOW:
            self._metrics.count("shed")
            raise ServerOverloaded(
                "brownout level %d sheds priority %d" % (self._brownout.level, int(priority)),
                retry_after_ms=self._batcher.queue.retry_after_ms())
        if precision is not None:
            precision = _PRECISION_ALIASES.get(str(precision).lower(), str(precision))
            if precision not in self._precision_dtypes:
                raise ValueError("unknown precision %r for endpoint %r (serves %s)"
                                 % (precision, self.name, self._precision_dtypes))
            if precision == self._default_dtype:
                precision = None  # one batch group for the default
        feed, n_rows = self._normalize_feed(feed)
        self._metrics.observe_arrival(n_rows)
        deadline = time.monotonic() + float(timeout_ms) / 1e3 if timeout_ms is not None else None
        req = ServingRequest(feed, n_rows, deadline, trace_id=trace_id, parent_span=parent_span,
                             priority=priority, precision=precision)
        try:
            self._batcher.offer(req)
        except Exception:
            self._metrics.count("shed")
            raise
        self._metrics.count("requests")
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
            raise ValueError("feed names %s != endpoint inputs %s"
                             % (sorted(feed), sorted(self._feed_names)))
        out, n_rows = {}, None
        for name, val in feed.items():
            shape, dtype = self._specs[name]
            # coerce to the spec dtype so every request meets the same
            # signature the warmup rungs did
            arr = np.asarray(val, dtype=dtype)
            if arr.shape[1:] != tuple(shape):
                raise ValueError("feed %r rows have shape %s, endpoint expects %s"
                                 % (name, arr.shape[1:], tuple(shape)))
            if n_rows is None:
                n_rows = arr.shape[0]
            elif arr.shape[0] != n_rows:
                raise ValueError("inconsistent request row counts: %r has %d rows, expected %d"
                                 % (name, arr.shape[0], n_rows))
            out[name] = arr
        if not n_rows:
            raise ValueError("empty request (0 rows)")
        if n_rows > self._policy.max_batch_size:
            raise ValueError("request of %d rows exceeds max_batch_size=%d — split it"
                             % (n_rows, self._policy.max_batch_size))
        return out, n_rows

    # ------------------------------------------------------------------
    def _fail_stragglers(self) -> None:
        """Fail every request still queued once no worker will serve it:
        a stuck request surfaces as a typed error, never a hang."""
        for req in self._batcher.drain_pending():
            req.fail(ServerClosed("server %r stopped" % self.name))

    def _on_queue_shed(self, req: ServingRequest, retry_after_ms: float) -> None:
        """A queued request evicted by priority shedding: counted as shed
        (it never ran) and failed with the retry hint."""
        self._metrics.count("shed")
        req.fail(ServerOverloaded("evicted by a higher-priority request",
                                  retry_after_ms=retry_after_ms))

    def _on_expired(self, req: ServingRequest) -> None:
        self._metrics.count("expired")
        fr = _flight.get()
        if fr is not None:
            # deadline-missed requests are always tail-sampled; the
            # client's span joins this record when its future raises
            fr.consider(req.trace_id, time.perf_counter() - req.submit_t, "deadline", (),
                        server=self.name)
        req.fail(DeadlineExceeded("deadline passed while queued"))

    def _apply_brownout(self, level: int) -> None:
        """The side effect of a (possibly new) brownout level outside the
        controller: eager batching from L2 (the coalescing window only
        adds latency to a saturated server).  L1's dropped flight capture
        is read in ``_execute``, L3's door shed in ``submit``; on an
        embedding-cache endpoint L4 serves lookups cache-only, released
        with the controller's slower descent when the level steps down."""
        self._batcher.eager = level >= 2
        if self._embedding_cache is not None:
            self._embedding_cache.set_cache_only(level >= 4)

    # ------------------------------------------------------------------
    # Dispatcher: one thread owns the batcher (single-consumer
    # coalescing) and routes each batch to the least-loaded live replica
    # ------------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        _mon_spans.set_thread_lane("serving/%s/dispatcher" % self.name)
        try:
            while True:
                # one pressure sample per turn drives the ladder
                self._apply_brownout(self._brownout.update(self._batcher.depth_ratio()))
                batch = self._batcher.next_batch(self._stop, self._on_expired, block=True)
                if batch is None:
                    return  # stopped and drained
                self._maybe_readmit()
                self._route(batch, retries=max(1, len(self._replicas)))
        finally:
            for rep in self._replicas:
                rep.q.put(None)  # drain sentinel

    def _maybe_readmit(self) -> None:
        """Half-open re-admission (``readmit_cooldown_s`` set): a
        failure-retired replica whose cooldown elapsed rejoins routing
        with one strike left; the next batch routed to it is the probe."""
        if self._readmit_cooldown is None:
            return
        now = time.monotonic()
        with self._route_cv:
            for rep in self._replicas:
                if (rep.alive or rep.removed or rep.retired_at is None
                        or now - rep.retired_at < self._readmit_cooldown):
                    continue
                rep.alive = True
                rep.retired_at = None
                rep.consec_failures = _REPLICA_FAIL_LIMIT - 1
                BACKEND_HALFOPEN_PROBES.labels(pool="server/%s" % self.name).inc()
                monitor.record_instant("serving/replica_readmit", cat="serving",
                                       server=self.name, replica=rep.name)
                self._route_cv.notify_all()

    def _pick_replica(self, exclude: Optional[_Replica]):
        """Least-loaded live replica with capacity, or None.  Caller holds
        ``_route_cv``."""
        live = [r for r in self._replicas
                if r.alive and r is not exclude and r.in_flight < _MAX_IN_FLIGHT]
        if not live:
            return None
        return min(live, key=lambda r: r.in_flight)

    def _route(self, batch: List[ServingRequest], retries: int,
               exclude: Optional[_Replica] = None) -> None:
        """Hand a batch to the least-loaded replica; blocks while every
        live replica is at its in-flight bound.  With no live replica (or
        an aborting stop) the batch fails typed, never hangs.  The put is
        inside the routing lock, under which a replica thread marks itself
        dead before its last queue drain, so a batch never strands in a
        queue nobody serves."""
        with self._route_cv:
            while True:
                if self._abort:
                    break
                rep = self._pick_replica(exclude)
                if rep is None and exclude is not None:
                    # the excluded (failing) replica is the only one left
                    if not any(r.alive and r is not exclude for r in self._replicas):
                        break
                if rep is not None:
                    rep.in_flight += 1
                    rep.q.put((batch, retries))
                    return
                if not any(r.alive for r in self._replicas):
                    break
                self._route_cv.wait(timeout=_ROUTE_WAIT_S)
        exc: Exception
        if self._abort or self._closed:
            exc = ServerClosed("server %r is stopped" % self.name)
        else:
            exc = ServingError("no live replicas on server %r" % self.name)
        self._metrics.count("failed", len(batch))
        for r in batch:
            r.fail(exc)

    def _release(self, rep: _Replica) -> None:
        with self._route_cv:
            rep.in_flight -= 1
            self._route_cv.notify_all()

    def _retire_replica(self, rep: _Replica) -> None:
        with self._route_cv:
            rep.alive = False
            rep.retired_at = time.monotonic()  # the re-admission cooldown's start
            self._route_cv.notify_all()

    def _count_requeue(self, rep: _Replica) -> None:
        """One re-routed batch: ``serving_requeued_total`` and the timeline
        marker move together, tagged with the replica it bounced off."""
        self._metrics.count("requeued")
        monitor.record_instant("serving/batch_requeue", cat="serving",
                               server=self.name, replica=rep.name)

    def _requeue(self, rep: _Replica, batch: List[ServingRequest], retries: int) -> None:
        """Re-route a batch off ``rep``, failing already-expired requests
        first (an expired request re-routed would take real capacity)."""
        live = []
        for r in batch:
            if r.expired():
                self._on_expired(r)
            else:
                live.append(r)
        if not live:
            return
        self._count_requeue(rep)
        self._route(live, retries, exclude=rep)

    def _replica_exit(self, rep: _Replica) -> None:
        """A replica thread's last bookkeeping: marked dead under the
        routing lock, then anything that landed before the mark drained."""
        self._retire_replica(rep)
        self._drain_replica_queue(rep)

    # ------------------------------------------------------------------
    def remove_replica(self, replica, timeout: float = 30.0) -> None:
        """Remove one replica at runtime: stop routing to it and wait for
        its in-flight work to finish (re-routing anything still queued).
        ``replica``: index or ``r<idx>`` name.  Refuses to remove the last
        live replica (stop() the server instead).  The replica's thread
        stays as a re-route forwarder until the server stops, so a batch
        routed concurrently with the removal cannot strand."""
        if isinstance(replica, int):
            rep = self._replicas[replica]
        else:
            matches = [r for r in self._replicas if r.name == str(replica)]
            if not matches:
                raise ValueError("unknown replica %r" % (replica,))
            rep = matches[0]
        with self._route_cv:
            if not rep.alive:
                return  # already retired or removed
            if sum(1 for r in self._replicas if r.alive) <= 1:
                raise ValueError("cannot remove the last live replica of server %r" % self.name)
            monitor.record_instant("serving/replica_drain", cat="serving",
                                   server=self.name, replica=rep.name)
            rep.alive = False
            rep.removed = True  # deliberate: re-admission never undoes it
            self._route_cv.notify_all()
            deadline = time.monotonic() + timeout
            while rep.in_flight > 0 and time.monotonic() < deadline:
                self._route_cv.wait(timeout=0.1)

    # ------------------------------------------------------------------
    # Replica worker: a double buffer per replica — dispatch batch N+1
    # before waiting for batch N's outputs, so N's device work and copy to
    # the host overlap N+1's merge, pad and dispatch.
    # ------------------------------------------------------------------
    def _replica_loop(self, rep: _Replica) -> None:
        _mon_spans.set_thread_lane("serving/%s/%s worker" % (self.name, rep.name))
        if rep.stream is not None:
            torch.cuda.set_device(rep.device)
        pending = None
        _unset = object()
        while True:
            item = _unset
            if not rep.alive:
                # retired or removed: finish the in-flight batch, re-route
                # the rest, then park as a forwarder until the stop
                # sentinel (a batch routed concurrently with the retirement
                # can still land in this queue)
                if pending is not None:
                    self._finalize(rep, *pending)
                    pending = None
                self._drain_replica_queue(rep)
                item = rep.q.get()
                if item is not None and not rep.alive:
                    batch, retries = item
                    self._release(rep)
                    self._requeue(rep, batch, retries)
                    continue
                # the stop sentinel (exit below), or the replica was
                # re-admitted while parked: this batch is the probe
            if item is _unset:
                if pending is None:
                    item = rep.q.get()
                else:
                    try:
                        item = rep.q.get_nowait()
                    except queue.Empty:
                        self._finalize(rep, *pending)
                        pending = None
                        continue  # back to the blocking wait
            if item is None:
                if pending is not None:
                    self._finalize(rep, *pending)
                    pending = None
                self._replica_exit(rep)
                return  # server drained
            batch, retries = item
            live = []
            for r in batch:
                # deadlines are checked again here: a batch can wait
                # behind a slow predecessor after routing
                if r.expired():
                    self._on_expired(r)
                else:
                    live.append(r)
            if not live:
                self._release(rep)
                continue
            nxt = self._execute(rep, live, retries)
            if pending is not None:
                self._finalize(rep, *pending)
                pending = None
            if nxt is not None and not rep.nonblocking:
                # a synchronous predictor's outputs are already on the host
                self._finalize(rep, *nxt)
                nxt = None
            pending = nxt

    def _drain_replica_queue(self, rep: _Replica) -> None:
        """Re-route (never drop) batches queued on a dead replica.  A stop
        sentinel met mid-drain is put back: it is the replica's one
        shutdown signal."""
        saw_sentinel = False
        while True:
            try:
                item = rep.q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                saw_sentinel = True
                continue
            batch, retries = item
            self._release(rep)  # give up this replica's slot
            self._requeue(rep, batch, retries)  # and take one elsewhere
        if saw_sentinel:
            rep.q.put(None)

    # hot-path: begin serve_execute (merge, pad, dispatch; the wait for the
    # outputs lives in _finalize, one batch behind)
    def _execute(self, rep: _Replica, batch: List[ServingRequest], retries: int):
        """Merge, pad and dispatch one batch on ``rep``, and queue its
        outputs' copy to the host behind its kernels on the replica's
        stream; returns the pending tuple for ``_finalize``, or None after
        a failure (which re-routes or fails the requests).

        With a trace session or flight recorder live, the batch runs under
        its requests' trace context (the executor's spans carry their ids)
        and, with a recorder, under a span capture that rides into
        ``_finalize``; otherwise the cost is two gate checks."""
        valid = sum(r.n_rows for r in batch)
        # brownout L1+: flight capture is the first rent shed
        fr = _flight.get() if self._brownout.level < 1 else None
        cap = [] if fr is not None else None
        tids = ()
        if cap is not None or _mon_spans.recording():
            tids = tuple(r.trace_id for r in batch if r.trace_id)
        try:
            with contextlib.ExitStack() as stack:
                if cap is not None:
                    stack.enter_context(_mon_spans.capture(cap))
                if tids or cap is not None:
                    now = time.perf_counter()
                    for r in batch:
                        # per-request queue wait, each span owning its one
                        # trace id under its submitter's span
                        with _mon_spans.trace_context((r.trace_id,) if r.trace_id else ()):
                            _mon_spans.record_span(
                                "serving/queue_wait", r.submit_t, now - r.submit_t,
                                cat="serving", parent=r.parent_span, server=self.name,
                                replica=rep.name, n_rows=r.n_rows)
                    stack.enter_context(_mon_spans.trace_context(tids))
                    if len(batch) == 1 and batch[0].parent_span:
                        # an unshared batch keeps a connected tree under its
                        # request's submitter span
                        stack.enter_context(_mon_spans.parent_scope(batch[0].parent_span))
                if _faults.active is not None:  # disarmed: one is-None gate
                    _faults.active.faultpoint("replica.dispatch", server=self.name,
                                              replica=rep.name)
                merged = {
                    name: (np.concatenate([r.feed[name] for r in batch], axis=0)
                           if len(batch) > 1 else batch[0].feed[name])
                    for name in self._feed_names
                }
                bucket = self._policy.bucket_for(valid)
                padded = self._policy.pad_feed(merged, bucket)
                t0 = time.perf_counter()
                kw = {"return_numpy": False} if rep.nonblocking else {}
                # one batch is one precision variant (the batcher never mixes)
                prec = getattr(batch[0], "precision", None)
                if prec is not None and rep.precision:
                    kw["precision"] = prec
                ready = None
                # the misses are read under the lock a re-plan's warm runs
                # hold, so an entry they build is not this batch's
                with rep.lock, rep.on_stream():
                    misses0 = rep.predictor.jit_cache_stats()["misses"]
                    with profiler.RecordEvent("serving/%s/batch" % self.name):
                        outs = rep.predictor.run_padded(padded, n_valid=valid, **kw)
                    if rep.stream is not None:
                        # non_blocking copies into pinned host memory; the
                        # event marks when they and the batch's kernels end
                        outs = [o.to("cpu", non_blocking=True) for o in outs]
                        ready = torch.cuda.Event()
                        ready.record(rep.stream)
                    recompiled = rep.predictor.jit_cache_stats()["misses"] > misses0
        except BaseException as exc:  # noqa: BLE001 — re-route or fail, keep serving
            self._replica_failure(rep, batch, retries, exc, cap=cap)
            return None
        return (batch, outs, ready, valid, bucket, t0, recompiled, retries, cap)
    # hot-path: end serve_execute

    def _replica_failure(self, rep: _Replica, batch: List[ServingRequest], retries: int,
                         exc: BaseException, cap: Optional[list] = None) -> None:
        """A batch failed on ``rep``: retire the replica when it fails
        repeatedly, and re-route the batch to a survivor so accepted
        requests do not drop; only with no survivor (or no retry budget
        left) do the requests fail, each tail-sampled with the spans the
        batch captured."""
        rep.failed += 1
        rep.consec_failures += 1
        if rep.consec_failures >= _REPLICA_FAIL_LIMIT and rep.alive:
            monitor.record_instant("serving/replica_retired", cat="serving",
                                   server=self.name, replica=rep.name)
            self._retire_replica(rep)
        self._release(rep)
        with self._route_cv:
            survivors = any(r.alive and r is not rep for r in self._replicas)
        if retries > 0 and survivors:
            self._requeue(rep, batch, retries - 1)
            return
        self._metrics.count("failed", len(batch))
        fr = _flight.get()
        if fr is not None:
            now = time.perf_counter()
            for r in batch:
                fr.consider(r.trace_id, now - r.submit_t, "error", cap or (),
                            server=self.name, replica=rep.name, error=repr(exc))
        for r in batch:
            r.fail(exc)

    def _finalize(self, rep: _Replica, batch: List[ServingRequest], outs, ready, valid: int,
                  bucket: int, t0: float, recompiled: bool, retries: int,
                  cap: Optional[list] = None) -> None:
        """Wait for a dispatched batch's outputs and complete its requests.
        A deferred device error surfaces here, handled as a dispatch
        failure.  The batch is observed here, so its run time spans
        dispatch to outputs on the host."""
        tids = ()
        rec = cap is not None or _mon_spans.recording()
        if rec:
            tids = tuple(r.trace_id for r in batch if r.trace_id)
        try:
            with contextlib.ExitStack() as stack:
                if cap is not None:
                    stack.enter_context(_mon_spans.capture(cap))
                if tids:
                    stack.enter_context(_mon_spans.trace_context(tids))
                if rec and len(batch) == 1 and batch[0].parent_span:
                    stack.enter_context(_mon_spans.parent_scope(batch[0].parent_span))
                if rec:
                    m0 = time.perf_counter()
                if ready is not None:
                    ready.synchronize()
                outs = [to_numpy(o) for o in outs]
                if rec:
                    _mon_spans.record_span("serving/materialize", m0, time.perf_counter() - m0,
                                           cat="serving", server=self.name, replica=rep.name)
        except BaseException as exc:  # noqa: BLE001
            self._replica_failure(rep, batch, retries, exc, cap=cap)
            return
        rep.executed += 1
        rep.consec_failures = 0
        self._metrics.observe_batch(valid, bucket, time.perf_counter() - t0,
                                    recompiled=recompiled and self._warmed, replica=rep.name)
        dtype = getattr(batch[0], "precision", None) or self._default_dtype
        self._metrics.count_precision(dtype, len(batch))
        with self._route_cv:
            self._batches_by_dtype[dtype] = self._batches_by_dtype.get(dtype, 0) + 1
        off = 0
        now = time.perf_counter()
        for r in batch:
            per_req = [o[off:off + r.n_rows] if o.ndim >= 1 and o.shape[0] == valid else o
                       for o in outs]
            off += r.n_rows
            r.complete(per_req)
            self._metrics.observe_request(now - r.submit_t, trace_id=r.trace_id)
        fr = _flight.get() if cap is not None else None
        if fr is not None:
            # the tail-sampling decision, per request: slow ones keep the
            # batch's span tree
            for r in batch:
                fr.consider(r.trace_id, now - r.submit_t, "ok", cap, server=self.name,
                            replica=rep.name, bucket=int(bucket), n_rows=int(r.n_rows))
        self._release(rep)

    # ------------------------------------------------------------------
    def stop(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Shut down.  ``drain=True`` (graceful): stop admitting, finish
        every queued request, then join the dispatcher and replicas.
        ``drain=False``: queued-but-unstarted requests fail with
        ServerClosed (batches already routed to a replica complete)."""
        self._closed = True
        if self._autotune_stop is not None:
            self._autotune_stop.set()
            if self._autotune_thread is not None:
                self._autotune_thread.join(timeout=5.0)
                self._autotune_thread = None
        with self._admin_lock:
            admin, self._admin = self._admin, None
        if admin is not None:
            admin.shutdown()
            admin.server_close()
        if drain:
            monitor.record_instant("serving/server_drain", cat="serving", server=self.name)
        else:
            # empty the queue before releasing the dispatcher, so it
            # cannot route work being abandoned
            self._abort = True
            self._fail_stragglers()
        self._stop.set()
        self._batcher.wake()
        with self._route_cv:
            self._route_cv.notify_all()
        # one deadline across every join
        deadline = (time.monotonic() + timeout) if timeout is not None else None

        def _remaining():
            return None if deadline is None else max(0.0, deadline - time.monotonic())

        self._worker.join(_remaining())
        for rep in self._replicas:
            rep.thread.join(_remaining())
        # a submit() that raced past the admission check may have enqueued
        # after the dispatcher drained and exited
        if not self._worker.is_alive():
            self._fail_stragglers()
        # retire this instance's series from the exposition; metrics()
        # and statusz() keep working off the detached children
        self._metrics.close()
        self._batcher.close()
        self._brownout.close()
        ADMISSION_EXPIRED.remove_labels(server=self.name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False
