"""Serving metrics — a view over the framework-wide registry (the port's
``serving/metrics.py``, over ``paddle_tpu_torch.monitor`` and
``paddle_tpu_torch.profiler``).

Since the monitor refactor, counters and the latency histogram live in
``paddle_tpu_torch.monitor.REGISTRY`` (labeled ``server=<name>,
instance=<k>``), so serving shows up in the same ``/metrics`` text
exposition and ``monitor.snapshot()`` as the executor and reader
metrics.  This class keeps the per-SERVER-INSTANCE bookkeeping exact:

* ``snapshot()`` — a plain dict (QPS, p50/p99 latency, mean batch
  occupancy, shed/expired counts, recompile counter) for tests, bench
  drivers, and the ``/statusz`` endpoint, reading THIS instance's
  registry children (two servers with the same name get distinct
  ``instance`` labels, so counts never bleed across constructions);
* a bounded latency reservoir for exact p50/p99 (the registry histogram
  carries the bucketed exposition view of the same observations);
* per-batch events routed through ``paddle_tpu_torch.profiler`` — each
  executed batch is timed under a ``RecordEvent`` (visible in the
  stop_profiler() table and any active monitor trace session) and
  emitted to the active JSONL trace sink for offline tail analysis.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from paddle_tpu_torch import monitor, profiler

__all__ = ["ServingMetrics"]

_RESERVOIR = 8192  # latencies kept for the percentile estimate

_COUNTER_HELP = {
    "requests": "admitted into the queue",
    "completed": "results delivered",
    "failed": "completed with a non-deadline error",
    "shed": "rejected at admission (queue full)",
    "expired": "deadline passed before a result",
    "batches": "predictor executions",
    "warmup_compiles": "executables built by warmup() (CUDA graphs captured on the card)",
    "recompiles": "jit-cache misses AFTER warmup (a graph captured under traffic)",
    "requeued": "batches re-routed off a failed/removed replica",
    # decode tier 2 (zero on non-decode servers)
    "prefix_fallback": "shared-prefix admissions that fell back to a "
                       "full prefill (corrupted/evicted-mid-admit "
                       "entry — degraded, never wrong tokens)",
    "prefix_store_failed": "freed-slot prefix KV offers that failed to "
                           "extract or store (the entry is simply not "
                           "retained)",
}
_LABELS = ("server", "instance")
_COUNTERS = {
    key: monitor.counter("serving_%s_total" % key, help, _LABELS)
    for key, help in _COUNTER_HELP.items()
}
_LATENCY = monitor.histogram(
    "serving_request_latency_seconds",
    "submit-to-complete request latency", _LABELS)
_BATCH_ROWS = monitor.counter(
    "serving_batch_rows_total",
    "rows in executed padded batches (bucket size x batches)", _LABELS)
_BATCH_VALID_ROWS = monitor.counter(
    "serving_batch_valid_rows_total",
    "valid (non-padding) rows in executed batches", _LABELS)
_PRECISION_REQS = monitor.counter(
    "serving_precision_requests_total",
    "requests served per compiled precision variant",
    _LABELS + ("dtype",))
_LADDER_REPLANS = monitor.counter(
    "serving_ladder_replans_total",
    "bucket-ladder re-plans applied behind the warmup barrier",
    _LABELS)
_PADDING_WASTE = monitor.gauge(
    "serving_padding_waste_ratio",
    "cumulative padding rows / padded rows for this endpoint (the "
    "bucket ladder's rent; the autotuner's objective)", _LABELS)
_PIPELINE_BUBBLE = monitor.gauge(
    "serving_pipeline_bubble_ratio",
    "structural GPipe bubble of a pipelined replica's last executed "
    "schedule, (K-1)/(M+K-1) — the idle fraction the micro-batch count "
    "amortizes", _LABELS)
_PIPELINE_OCCUPANCY = monitor.gauge(
    "serving_pipeline_stage_occupancy",
    "fraction of schedule slots each pipeline stage spends computing "
    "(M/(M+K-1)); one series per stage coordinate", _LABELS + ("stage",))

# distinguishes same-named servers constructed in one process
_instance_seq = itertools.count()


class ServingMetrics:
    def __init__(self, name: str = "server"):
        self.name = name
        self.instance = str(next(_instance_seq))
        lbl = {"server": name, "instance": self.instance}
        self._c = {key: m.labels(**lbl) for key, m in _COUNTERS.items()}
        self._latency = _LATENCY.labels(**lbl)
        self._batch_rows = _BATCH_ROWS.labels(**lbl)
        self._batch_valid = _BATCH_VALID_ROWS.labels(**lbl)
        self._replans = _LADDER_REPLANS.labels(**lbl)
        self._waste_gauge = _PADDING_WASTE.labels(**lbl)
        self._precision_children: Dict[str, object] = {}  # dtype -> child
        self._pipeline_children: Dict[str, object] = {}  # stage -> child
        self._pipeline_bubble = None  # gauge child, set on first publish
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._latencies: deque = deque(maxlen=_RESERVOIR)  # seconds, per request
        # bucket -> [n_batches, total_valid_rows]
        self._occupancy: Dict[int, list] = {}
        # request n_rows -> count: the observed ARRIVAL-size histogram
        # the ladder autotuner plans from (request sizes, not batch
        # sizes — rung spacing must fit what callers actually send)
        self._arrivals: Dict[int, int] = {}
        self._padded_rows = 0   # cumulative bucket rows executed
        self._valid_rows = 0    # cumulative valid rows executed

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Retire this instance's series from the registry exposition
        (snapshot() keeps working off the detached children).  Called by
        InferenceServer.stop() so a process that constructs servers
        repeatedly doesn't grow /metrics without bound."""
        lbl = {"server": self.name, "instance": self.instance}
        for metric in list(_COUNTERS.values()) + [
                _LATENCY, _BATCH_ROWS, _BATCH_VALID_ROWS,
                _LADDER_REPLANS, _PADDING_WASTE]:
            metric.remove_labels(**lbl)
        with self._lock:
            dtypes = list(self._precision_children)
            stages = list(self._pipeline_children)
            had_pipeline = self._pipeline_bubble is not None
        for dtype in dtypes:
            _PRECISION_REQS.remove_labels(dtype=dtype, **lbl)
        for stage in stages:
            _PIPELINE_OCCUPANCY.remove_labels(stage=stage, **lbl)
        if had_pipeline:
            _PIPELINE_BUBBLE.remove_labels(**lbl)

    # ------------------------------------------------------------------
    def count(self, key: str, n: int = 1) -> None:
        self._c[key].inc(n)

    def count_precision(self, dtype: str, n: int = 1) -> None:
        """``n`` requests served by the ``dtype`` compiled variant.
        Child creation is under the instance lock — replica workers
        race the first request of a dtype against snapshot()/close()
        iterating the children."""
        with self._lock:
            child = self._precision_children.get(dtype)
            if child is None:
                child = self._precision_children[dtype] = (
                    _PRECISION_REQS.labels(
                        server=self.name, instance=self.instance,
                        dtype=dtype))
        child.inc(n)

    def count_replan(self) -> None:
        """One applied bucket-ladder re-plan."""
        self._replans.inc()

    def set_pipeline(self, stats: Dict[str, object]) -> None:
        """Publish a pipelined replica's schedule shape (a
        ``PipelinePredictor.pipeline_stats()`` dict): the structural
        bubble ratio plus one occupancy series per stage coordinate."""
        lbl = {"server": self.name, "instance": self.instance}
        with self._lock:
            if self._pipeline_bubble is None:
                self._pipeline_bubble = _PIPELINE_BUBBLE.labels(**lbl)
            bubble = self._pipeline_bubble
            children = []
            for stage, occ in sorted(stats["stage_occupancy"].items()):
                stage = str(stage)
                child = self._pipeline_children.get(stage)
                if child is None:
                    child = self._pipeline_children[stage] = (
                        _PIPELINE_OCCUPANCY.labels(stage=stage, **lbl))
                children.append((child, occ))
        bubble.set(round(float(stats["bubble_ratio"]), 6))
        for child, occ in children:
            child.set(round(float(occ), 6))

    def observe_arrival(self, n_rows: int) -> None:
        """Record one request's row count into the arrival histogram."""
        with self._lock:
            self._arrivals[n_rows] = self._arrivals.get(n_rows, 0) + 1

    def arrival_histogram(self) -> Dict[int, int]:
        """Snapshot of the observed request-size distribution (the
        autotuner's input)."""
        with self._lock:
            return dict(self._arrivals)

    def observe_request(self, latency_s: float,
                        trace_id: Optional[str] = None) -> None:
        self._c["completed"].inc()
        # the exemplar pins THIS request's trace id to the latency
        # bucket it landed in (OpenMetrics exposition) — the bridge from
        # a p99 bucket to the flight recorder / merged trace
        self._latency.observe(
            latency_s,
            exemplar={"trace_id": trace_id} if trace_id else None)
        with self._lock:
            self._latencies.append(latency_s)

    def observe_batch(self, valid: int, bucket: int, run_s: float,
                      recompiled: bool = False,
                      replica: str = None) -> None:
        """Record one executed batch and emit its trace event."""
        self._c["batches"].inc()
        if recompiled:
            self._c["recompiles"].inc()
        self._batch_rows.inc(bucket)
        self._batch_valid.inc(valid)
        with self._lock:
            ent = self._occupancy.setdefault(bucket, [0, 0])
            ent[0] += 1
            ent[1] += valid
            self._padded_rows += bucket
            self._valid_rows += valid
            waste = 1.0 - self._valid_rows / self._padded_rows
        # cumulative padding waste — the measured number the autotuned
        # ladder must strictly reduce (bench_serving reports it)
        self._waste_gauge.set(round(waste, 6))
        event = {
            "event": "serving.batch",
            "server": self.name,
            "valid": int(valid),
            "bucket": int(bucket),
            "run_ms": round(run_s * 1e3, 3),
            "recompiled": bool(recompiled),
        }
        if replica is not None:
            event["replica"] = replica
        profiler.emit_trace_event(event)

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Point-in-time metrics dict (the admin/bench surface)."""
        counters = {key: int(c.value) for key, c in self._c.items()}
        with self._lock:
            lats = np.asarray(self._latencies, dtype=np.float64)
            occupancy = {b: tuple(v) for b, v in self._occupancy.items()}
            elapsed = time.perf_counter() - self._t0
            arrivals = dict(self._arrivals)
            padded_rows, valid_rows = self._padded_rows, self._valid_rows
            precision_children = dict(self._precision_children)
        snap: Dict[str, object] = dict(counters)
        snap["elapsed_s"] = round(elapsed, 3)
        snap["qps"] = round(counters["completed"] / elapsed, 2) if elapsed > 0 else 0.0
        if lats.size:
            snap["latency_p50_ms"] = round(float(np.percentile(lats, 50)) * 1e3, 3)
            snap["latency_p99_ms"] = round(float(np.percentile(lats, 99)) * 1e3, 3)
        else:
            snap["latency_p50_ms"] = snap["latency_p99_ms"] = None
        total_rows = sum(b * n for b, (n, _) in occupancy.items())
        total_valid = sum(v for _, v in occupancy.values())
        snap["mean_batch_occupancy"] = (
            round(total_valid / total_rows, 4) if total_rows else None)
        snap["batch_histogram"] = {
            str(b): {"batches": n, "valid_rows": v}
            for b, (n, v) in sorted(occupancy.items())
        }
        snap["arrival_histogram"] = {
            str(k): v for k, v in sorted(arrivals.items())}
        snap["padding_waste_ratio"] = (
            round(1.0 - valid_rows / padded_rows, 4) if padded_rows
            else None)
        snap["ladder_replans"] = int(self._replans.value)
        snap["precision_requests"] = {
            dtype: int(child.value)
            for dtype, child in precision_children.items()}
        return snap
