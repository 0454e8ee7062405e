"""Process-global metrics registry: named counters.

The port's own copy of the part of the JAX package's
``monitor/registry.py`` that ``reader.py``'s pipeline-stall counters and
``faults/retry.py``'s retry counter need: ``Counter`` (a lock and an
add, safe to leave on), optionally labelled (``labels(op=...)`` returns
the child counter of those label values), and ``MetricsRegistry`` with
idempotent registration, ``snapshot()`` and ``value()``.  Gauges,
histograms and the Prometheus and OpenMetrics expositions come with the
observability slice (ROADMAP A9).
"""
from __future__ import annotations

import re
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["Counter", "MetricsRegistry", "REGISTRY"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class Counter:
    """A monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._value = 0.0
        self._children: Dict[Tuple[str, ...], "Counter"] = {}

    def labels(self, **labelvalues) -> "Counter":
        """The child counter of these label values (created at first use)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError("metric %r takes labels %s, got %s"
                             % (self.name, self.labelnames, tuple(sorted(labelvalues))))
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Counter(self.name, self.help)
            return child

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up (inc %r)" % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def children(self) -> Dict[Tuple[str, ...], float]:
        """{label values: count} of a labelled counter."""
        with self._lock:
            return {k: c.value for k, c in self._children.items()}


class MetricsRegistry:
    """A named collection of counters (the process default is ``REGISTRY``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Counter] = {}

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        """The counter of this name, registered at its first request."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name, help, labelnames)
            return m

    def get(self, name: str) -> Optional[Counter]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """{name: {type, help, value}}, sorted by name; a labelled
        counter's value is {label values: count}."""
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {m.name: {"type": m.kind, "help": m.help,
                         "value": m.children() if m.labelnames else m.value}
                for m in metrics}

    def value(self, name: str, default: float = 0.0) -> float:
        m = self.get(name)
        return default if m is None else m.value


REGISTRY = MetricsRegistry()
