"""Hot-id embedding row cache: the serving tier in front of PS lookups
(the port's copy of the JAX package's ``serving/embedding_cache.py``).

CTR traffic is Zipf-skewed — a tiny fraction of ids absorbs most
lookups — so a bounded row cache in front of the parameter server turns
most of serving's per-batch PS round-trips into host-memory probes, and
under pressure (or a PS outage) becomes the availability floor: the
brownout ladder's cache-only rung serves hits from the cache and misses
from a fallback row (the running mean of pulled rows, or zeros) instead
of queuing on an unreachable PS.

* **Bounded LRU** keyed ``(table, id)`` with row-count capacity —
  eviction is strict LRU (`OrderedDict` move-to-end on hit).
* **Read-through** — :meth:`lookup_through` probes the cache, pulls
  only the missing ids from the PS client, inserts, and returns the
  assembled ``[len(ids), dim]`` rows.  Hit/miss accounting is
  OCCURRENCE-weighted (the caller passes each unique id's occurrence
  count): the hit ratio is the fraction of *served rows* that never
  touched the PS, which is the number capacity planning needs.
* **Cache-only mode** (the brownout rung): misses serve the fallback
  row and count ``serving_embedding_cache_fallback_rows_total`` — no
  PS touch at all, so Zipf traffic degrades gracefully instead of
  queuing.  Outside cache-only mode a PS failure propagates typed to
  the caller (a request fully covered by cached rows still succeeds —
  the outage-survival property the chaos suite pins).
* **Invalidation** — a sparse-grad push changes rows server-side, and
  a checkpoint restore rewrites them wholesale; both paths invalidate
  (``executor.run``'s push site calls :meth:`invalidate_ids`,
  ``TrainCheckpoint.restore`` calls :meth:`invalidate`) so a cached
  copy can never be served stale.

Metrics: ``serving_embedding_cache_{hits,misses}_total``,
``serving_embedding_cache_fallback_rows_total`` and the
``serving_embedding_cache_hit_ratio`` gauge, labeled by cache name and
retired by :meth:`close`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from paddle_tpu_torch import monitor

__all__ = ["EmbeddingRowCache"]

_LABELS = ("cache",)
CACHE_HITS = monitor.counter(
    "serving_embedding_cache_hits_total",
    "embedding rows served from the hot-id cache (occurrence-weighted: "
    "each served row counts, not each unique id)", _LABELS)
CACHE_MISSES = monitor.counter(
    "serving_embedding_cache_misses_total",
    "embedding rows that missed the hot-id cache (pulled from the PS, "
    "or served from the fallback under cache-only brownout)", _LABELS)
CACHE_FALLBACK = monitor.counter(
    "serving_embedding_cache_fallback_rows_total",
    "missed rows served from the fallback (mean/zero) row because "
    "cache-only mode was active (the brownout rung / a PS outage)",
    _LABELS)
CACHE_HIT_RATIO = monitor.gauge(
    "serving_embedding_cache_hit_ratio",
    "cumulative hits / (hits + misses) for the hot-id embedding cache "
    "(the Zipf-absorption number the cache is sized by)", _LABELS)


class EmbeddingRowCache:
    """Bounded LRU of embedding rows keyed ``(table, id)``.

    ``capacity_rows`` bounds TOTAL rows across all tables (the
    operational budget is host memory, not per-table fairness).
    ``fallback``: what a cache-only miss serves — ``"mean"`` (running
    mean of every row inserted for that table; a fresh table falls
    back to zeros) or ``"zero"``.
    """

    def __init__(self, capacity_rows: int, name: str = "cache",
                 fallback: str = "mean"):
        if int(capacity_rows) < 1:
            raise ValueError(
                "capacity_rows must be >= 1, got %r" % capacity_rows)
        if fallback not in ("mean", "zero"):
            raise ValueError(
                "fallback must be 'mean' or 'zero', got %r" % fallback)
        self.capacity_rows = int(capacity_rows)
        self.name = name
        self.fallback = fallback
        self._data: "OrderedDict[Tuple[str, int], np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self._cache_only = False
        # per-table running sum/count of INSERTED rows: the mean-row
        # fallback estimator (not decremented on evict — an estimator
        # of the table's row distribution, not of current contents)
        self._mean: Dict[str, list] = {}
        self._hits = 0
        self._misses = 0
        self._fallback_rows = 0
        self._pulled_rows = 0  # unique rows actually fetched from the PS
        lbl = {"cache": name}
        self._c_hits = CACHE_HITS.labels(**lbl)
        self._c_misses = CACHE_MISSES.labels(**lbl)
        self._c_fallback = CACHE_FALLBACK.labels(**lbl)
        self._g_ratio = CACHE_HIT_RATIO.labels(**lbl)

    # ------------------------------------------------------------------
    @property
    def cache_only(self) -> bool:
        return self._cache_only

    def set_cache_only(self, on: bool) -> None:
        """Flip the brownout cache-only mode.  Idempotent and cheap (a
        bool store); the transition emits an instant marker so the
        degradation window is visible on the timeline."""
        on = bool(on)
        if on == self._cache_only:
            return
        self._cache_only = on
        monitor.record_instant(
            "serving/embedding_cache_only", cat="serving",
            cache=self.name, on=on)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._data)

    def _observe(self, hits: int, misses: int) -> None:
        self._hits += hits
        self._misses += misses
        if hits:
            self._c_hits.inc(hits)
        if misses:
            self._c_misses.inc(misses)
        total = self._hits + self._misses
        if total:
            self._g_ratio.set(round(self._hits / total, 6))

    def hit_ratio(self) -> Optional[float]:
        with self._lock:
            total = self._hits + self._misses
            return (self._hits / total) if total else None

    # ------------------------------------------------------------------
    # hot-path: begin cache_probe (dict probes + row copies under the
    # cache lock; the PS pull for misses happens OUTSIDE the lock and
    # outside this region's claim — no sleeps, no device syncs)
    def lookup_through(self, client, table: str, ids,
                       n_valid: Optional[int] = None,
                       counts=None) -> np.ndarray:
        """Rows for ``ids`` (``[len(ids), dim]`` float32), cache-aside.

        ``n_valid``: the real unique count — entries past it are the
        bucket padding (repeats of ids[0]) and are excluded from the
        hit/miss accounting.  ``counts``: per-unique occurrence counts
        (occurrence-weighted accounting; defaults to 1 each).  Misses
        pull from ``client`` and populate the cache; in cache-only mode
        they serve the fallback row instead (counted).  ``client`` may
        be None only in cache-only mode."""
        ids = np.asarray(ids).reshape(-1).astype(np.int64)  # hot-ok: host id array, not a device sync
        n = len(ids) if n_valid is None else int(n_valid)
        if n <= 0:  # degenerate all-padding bucket: probe everything,
            n = len(ids)  # unweighted (counts only covers real ids)
            counts = None
        rows = None
        missing: list = []
        hit_w = miss_w = 0
        with self._lock:
            data = self._data
            for i in range(n):
                key = (table, int(ids[i]))
                row = data.get(key)
                w = int(counts[i]) if counts is not None else 1
                if row is None:
                    missing.append(i)
                    miss_w += w
                else:
                    data.move_to_end(key)
                    if rows is None:
                        rows = np.empty((len(ids), len(row)), np.float32)
                    rows[i] = row
                    hit_w += w
            self._observe(hit_w, miss_w)
    # hot-path: end cache_probe
        if missing:
            if self._cache_only:
                fb_dim = rows.shape[1] if rows is not None else None
                fb = self._fallback_row(table, fb_dim)
                if fb is None:
                    # nothing cached for this table yet and no known
                    # dim: the PS (if reachable) is the only source
                    if client is None:
                        raise RuntimeError(
                            "embedding cache %r: cache-only mode with "
                            "no cached rows for table %r and no row "
                            "dim known" % (self.name, table))
                    fb_rows = client.pull_sparse(
                        table, ids[missing])
                    if rows is None:
                        rows = np.empty(
                            (len(ids), fb_rows.shape[1]), np.float32)
                    for k, i in enumerate(missing):
                        rows[i] = fb_rows[k]
                else:
                    if rows is None:
                        rows = np.empty((len(ids), len(fb)), np.float32)
                    for i in missing:
                        rows[i] = fb
                    with self._lock:
                        self._fallback_rows += len(missing)
                    self._c_fallback.inc(len(missing))
            else:
                if client is None:
                    raise RuntimeError(
                        "embedding cache %r: %d missed row(s) for "
                        "table %r and no PS client to pull from"
                        % (self.name, len(missing), table))
                pulled = client.pull_sparse(table, ids[missing])
                if rows is None:
                    rows = np.empty((len(ids), pulled.shape[1]), np.float32)
                for k, i in enumerate(missing):
                    rows[i] = pulled[k]
                self.put_many(table, ids[missing],
                              np.asarray(pulled, np.float32))
                with self._lock:
                    self._pulled_rows += len(missing)
        if n < len(ids):
            # bucket padding repeats ids[0]: its row is already resolved
            rows[n:] = rows[0]
        return rows

    def _fallback_row(self, table: str,
                      dim: Optional[int]) -> Optional[np.ndarray]:
        if self.fallback == "mean":
            with self._lock:
                ent = self._mean.get(table)
                if ent is not None and ent[1] > 0:
                    return (ent[0] / ent[1]).astype(np.float32)
        if dim is None:
            with self._lock:
                for (t, _id), row in self._data.items():
                    if t == table:
                        dim = len(row)
                        break
        return np.zeros(dim, np.float32) if dim is not None else None

    # ------------------------------------------------------------------
    def get(self, table: str, idx: int) -> Optional[np.ndarray]:
        with self._lock:
            row = self._data.get((table, int(idx)))
            if row is not None:
                self._data.move_to_end((table, int(idx)))
                return row.copy()
            return None

    def put_many(self, table: str, ids, rows) -> None:
        """Insert rows (copies), evicting LRU past capacity."""
        ids = np.asarray(ids).reshape(-1)
        rows = np.asarray(rows, np.float32).reshape(len(ids), -1)
        with self._lock:
            data = self._data
            ent = self._mean.setdefault(
                table, [np.zeros(rows.shape[1], np.float64), 0])
            for k, idx in enumerate(ids):
                data[(table, int(idx))] = rows[k].copy()
                data.move_to_end((table, int(idx)))
                ent[0] += rows[k]
                ent[1] += 1
            while len(data) > self.capacity_rows:
                data.popitem(last=False)

    def invalidate_ids(self, table: str, ids) -> None:
        """Drop specific rows (a sparse-grad push changed them)."""
        with self._lock:
            for idx in np.asarray(ids).reshape(-1):
                self._data.pop((table, int(idx)), None)

    def invalidate(self, table: Optional[str] = None) -> None:
        """Drop a whole table's rows (or everything): the checkpoint-
        restore / table-assign path, where rows changed wholesale."""
        with self._lock:
            if table is None:
                self._data.clear()
                self._mean.clear()
            else:
                for key in [k for k in self._data if k[0] == table]:
                    del self._data[key]
                self._mean.pop(table, None)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "size_rows": len(self._data),
                "capacity_rows": self.capacity_rows,
                "hits": self._hits,
                "misses": self._misses,
                "fallback_rows": self._fallback_rows,
                "pulled_rows": self._pulled_rows,
                "hit_ratio": (round(self._hits / total, 6)
                              if total else None),
                "cache_only": self._cache_only,
            }

    def close(self) -> None:
        """Retire this cache's series from the exposition."""
        lbl = {"cache": self.name}
        for metric in (CACHE_HITS, CACHE_MISSES, CACHE_FALLBACK,
                       CACHE_HIT_RATIO):
            metric.remove_labels(**lbl)
        with self._lock:
            self._data.clear()
            self._mean.clear()

    # ------------------------------------------------------------------
    def bind(self, program) -> "EmbeddingRowCache":
        """Attach to a program (or an ``AnalysisPredictor``'s) so the
        executor's sparse prefetch reads through this cache."""
        target = getattr(program, "_program", program)
        target._embedding_cache = self
        return self
