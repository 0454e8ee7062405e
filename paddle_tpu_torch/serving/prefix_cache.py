"""Prefix KV cache: block-hashed prompt-prefix reuse for decode (own copy
of the JAX package's ``serving/prefix_cache.py``: host numpy plus
``paddle_tpu_torch.monitor``).

The few-system-prompts-many-users traffic shape re-prefills the same
prompt head thousands of times — the dominant decode-server cost after
the per-token step itself.  :class:`PrefixKVCache` retains FINISHED
slots' KV blocks (the vLLM lineage: Kwon et al., SOSP 2023, at block
granularity rather than per-page) in a bounded byte-budget LRU, keyed
by a hash of the prompt-token prefix at ``block_tokens`` boundaries:

* **Offer** — when the scheduler frees a slot, the prompt's longest
  block-aligned prefix (bounded by the positions the slot actually
  consumed) is hashed and its KV rows extracted (one host materialize
  per retained entry — a control-plane move off the tick's hot path,
  like a rung transition).
* **Probe** — at admission, the incoming prompt is hashed at descending
  block boundaries; the longest match hands back retained KV leaves and
  the admit executable installs them, so prefill drops to the unmatched
  suffix (the prefill-token counter is the ground truth the tests and
  bench assert on).  Hash collisions cannot serve wrong tokens: every
  entry stores its prefix tokens and a probe compares them exactly.
* **Invalidation** — an endpoint reload (new weights) calls
  :meth:`invalidate`; retained KV from old weights must never seed new
  decodes.

The cache is prompt-token keyed and position-absolute, so an entry is
valid for ANY later prompt sharing the prefix — the write-before-read
pool invariant covers the suffix positions, exactly as it covers slot
reuse.  Metrics: ``serving_prefix_cache_{hits,misses,evictions}_total``
counters and the ``serving_prefix_cache_bytes`` gauge, labeled by cache
name and retired by :meth:`close`.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from paddle_tpu_torch import monitor

__all__ = ["PrefixKVCache"]

_LABELS = ("cache",)
PREFIX_HITS = monitor.counter(
    "serving_prefix_cache_hits_total",
    "decode admissions that matched a retained prompt-prefix and "
    "skipped its prefill (shared-prefix KV reuse)", _LABELS)
PREFIX_MISSES = monitor.counter(
    "serving_prefix_cache_misses_total",
    "decode admissions probed against the prefix KV cache with no "
    "block-aligned match (full prefill)", _LABELS)
PREFIX_EVICTIONS = monitor.counter(
    "serving_prefix_cache_evictions_total",
    "prefix KV entries evicted by the byte-budget LRU", _LABELS)
PREFIX_BYTES = monitor.gauge(
    "serving_prefix_cache_bytes",
    "bytes of retained prefix KV blocks (tokens + cache leaves) "
    "currently held by the prefix cache", _LABELS)


class PrefixKVCache:
    """Bounded LRU of prompt-prefix KV blocks for one decode endpoint.

    ``capacity_bytes`` bounds the sum of retained entry sizes (prefix
    tokens + extracted KV leaves); ``block_tokens`` is the hash
    granularity — prefixes are keyed only at multiples of it, so two
    prompts share an entry iff they agree on whole blocks.  One cache
    serves ONE endpoint (one weight set / pool layout); entries are not
    portable across servers.
    """

    def __init__(self, capacity_bytes: int = 64 << 20,
                 block_tokens: int = 16, name: str = "prefix"):
        if int(capacity_bytes) < 1:
            raise ValueError(
                "capacity_bytes must be >= 1, got %r" % capacity_bytes)
        if int(block_tokens) < 1:
            raise ValueError(
                "block_tokens must be >= 1, got %r" % block_tokens)
        self.capacity_bytes = int(capacity_bytes)
        self.block_tokens = int(block_tokens)
        self.name = name
        # key -> {"tokens": [m] int32, "leaves": [np arrays | None],
        #         "nbytes": int}
        self._data: "OrderedDict[str, Dict[str, object]]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._fallbacks = 0
        lbl = {"cache": name}
        self._c_hits = PREFIX_HITS.labels(**lbl)
        self._c_misses = PREFIX_MISSES.labels(**lbl)
        self._c_evictions = PREFIX_EVICTIONS.labels(**lbl)
        self._g_bytes = PREFIX_BYTES.labels(**lbl)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._data)

    @staticmethod
    def _hash(tokens: np.ndarray) -> str:
        return hashlib.sha1(
            np.ascontiguousarray(tokens, np.int32).tobytes()).hexdigest()

    # ------------------------------------------------------------------
    # hot-path: begin prefix_probe (hash + dict probes under the cache
    # lock, on the scheduler thread between ticks — pure host work, no
    # device syncs, no sleeps; the KV install itself is one warmed
    # admit_prefix dispatch)
    def probe(self, prompt) -> Tuple[int, Optional[List[np.ndarray]]]:
        """Longest retained block-aligned proper prefix of ``prompt``:
        ``(prefix_len, kv_leaves)``, or ``(0, None)`` on a miss.  The
        match is capped one token short of the prompt so the suffix
        always re-enters prefill (the step consuming the LAST prompt
        token produces the first generated one — it must run).  Stored
        tokens are compared exactly, so a hash collision can never
        install another prompt's KV."""
        B = self.block_tokens
        m = ((len(prompt) - 1) // B) * B
        if m <= 0:
            self._count_miss()
            return 0, None
        with self._lock:
            while m > 0:
                key = self._hash(prompt[:m])
                ent = self._data.get(key)
                if ent is not None and np.array_equal(
                        ent["tokens"], prompt[:m]):
                    self._data.move_to_end(key)
                    self._hits += 1
                    self._c_hits.inc()
                    return m, list(ent["leaves"])
                m -= B
            self._misses += 1
            self._c_misses.inc()
        return 0, None
    # hot-path: end prefix_probe

    def _count_miss(self) -> None:
        with self._lock:
            self._misses += 1
        self._c_misses.inc()

    def count_fallback(self) -> None:
        """A prefix admission that fell back to full prefill (fault
        injection / corrupted entry) — tracked for :meth:`stats`; the
        server's own metrics count it as ``prefix_fallback``."""
        with self._lock:
            self._fallbacks += 1

    # ------------------------------------------------------------------
    def offer(self, prompt, consumed: int,
              extract: Callable[[int], List[Optional[np.ndarray]]]) -> bool:
        """Retain a freed slot's prefix KV: hash the prompt's longest
        block-aligned prefix covered by the slot's ``consumed``
        positions and store ``extract(m)`` (the pool's KV leaves for
        positions ``< m``).  Returns True when a new entry was stored.
        The extract (a host materialize) runs OUTSIDE the cache lock and
        only for new keys — repeat offers of a hot prefix are one dict
        probe."""
        B = self.block_tokens
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        m = (len(prompt) // B) * B
        m = min(m, (int(consumed) // B) * B)
        if m <= 0:
            return False
        key = self._hash(prompt[:m])
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                return False
        leaves = extract(m)
        tokens = prompt[:m].copy()
        nbytes = int(tokens.nbytes) + sum(
            int(leaf.nbytes) for leaf in leaves if leaf is not None)
        with self._lock:
            if key in self._data:  # lost the race to a concurrent offer
                self._data.move_to_end(key)
                return False
            self._data[key] = {
                "tokens": tokens, "leaves": leaves, "nbytes": nbytes}
            self._bytes += nbytes
            evicted = 0
            while self._bytes > self.capacity_bytes and self._data:
                _, ev = self._data.popitem(last=False)
                self._bytes -= int(ev["nbytes"])
                evicted += 1
            if evicted:
                self._evictions += evicted
                self._c_evictions.inc(evicted)
            self._g_bytes.set(float(self._bytes))
        return True

    # ------------------------------------------------------------------
    def invalidate(self) -> None:
        """Drop every entry — the endpoint-reload path: retained KV from
        the previous weights must never seed a new decode."""
        with self._lock:
            self._data.clear()
            self._bytes = 0
            self._g_bytes.set(0.0)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        with self._lock:
            total = self._hits + self._misses
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "capacity_bytes": self.capacity_bytes,
                "block_tokens": self.block_tokens,
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "fallbacks": self._fallbacks,
                "hit_ratio": (round(self._hits / total, 6)
                              if total else None),
            }

    def close(self) -> None:
        """Retire this cache's series from the exposition."""
        lbl = {"cache": self.name}
        for metric in (PREFIX_HITS, PREFIX_MISSES, PREFIX_EVICTIONS,
                       PREFIX_BYTES):
            metric.remove_labels(**lbl)
        with self._lock:
            self._data.clear()
            self._bytes = 0
