"""Process-global metrics registry: Counter / Gauge / Histogram with labels.

The framework-wide analog of the reference's per-subsystem stat counters
(platform/profiler.cc event totals, operators/reader queue stats): every
subsystem registers named metrics here once at import, increments them on
the hot path (a lock + an add — safe to leave on unconditionally), and
any consumer reads the whole process through one of two surfaces:

* ``snapshot()`` — a plain nested dict for tests, bench drivers, and the
  serving ``/statusz`` endpoint;
* ``render_text()`` — Prometheus text exposition (version 0.0.4) for the
  serving ``/metrics`` endpoint or any scraper;
* ``render_openmetrics()`` / ``expose(openmetrics=True)`` — OpenMetrics
  1.0 exposition, including histogram *exemplars*: ``observe(v,
  exemplar={"trace_id": ...})`` pins the offending request's trace id to
  the latency bucket it landed in, so a scraper can jump from a p99
  bucket straight to the flight-recorder trace.

Metrics are registered idempotently: re-registering the same name with
the same type/labels returns the existing metric (so module reloads and
multiple importers compose); a mismatch raises.
"""
from __future__ import annotations

import math
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "CallbackCounter", "MetricsRegistry",
    "REGISTRY", "DEFAULT_BUCKETS",
    "parse_exposition", "relabel_exposition", "merge_expositions",
    "render_exposition", "aggregate_families",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# seconds-scale latency ladder (Prometheus client default, extended down
# to 100us for host-side dispatch costs)
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class _CounterChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up (inc %r)" % (n,))
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class _GaugeChild:
    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value


class _HistogramChild:
    __slots__ = ("_lock", "_buckets", "_counts", "_sum", "_count",
                 "_exemplars")

    def __init__(self, buckets: Tuple[float, ...]):
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * len(buckets)  # per-bucket (non-cumulative)
        self._sum = 0.0
        self._count = 0
        # one exemplar slot per bucket + one for +Inf; latest wins.
        # Allocated lazily: most histograms never see an exemplar and
        # the observe() fast path must not pay for the possibility.
        self._exemplars: Optional[List[Optional[tuple]]] = None

    def observe(self, v: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            idx = len(self._buckets)  # +Inf slot
            for i, le in enumerate(self._buckets):
                if v <= le:
                    self._counts[i] += 1
                    idx = i
                    break
            if exemplar:
                if self._exemplars is None:
                    self._exemplars = [None] * (len(self._buckets) + 1)
                self._exemplars[idx] = (dict(exemplar), v, time.time())

    def exemplars(self) -> List[Optional[tuple]]:
        """Per-bucket ``(labels, value, wall_ts)`` exemplars (index
        ``len(buckets)`` is +Inf); None where none was ever attached."""
        with self._lock:
            if self._exemplars is None:
                return [None] * (len(self._buckets) + 1)
            return list(self._exemplars)

    @property
    def value(self) -> Dict[str, object]:
        """Snapshot dict: count, sum, and CUMULATIVE bucket counts keyed
        by upper bound (the exposition convention)."""
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        cum, out = 0, {}
        for le, c in zip(self._buckets, counts):
            cum += c
            out[_fmt(le)] = cum
        out["+Inf"] = total
        return {"count": total, "sum": s, "buckets": out}


class _BaseMetric:
    kind = "untyped"
    _child_cls = _CounterChild

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError("invalid metric name %r" % name)
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln == "le":
                raise ValueError("invalid label name %r" % ln)
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        self._default_child = None  # cached no-label child (hot path)

    def _new_child(self):
        return self._child_cls()

    def labels(self, **labelvalues):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                "metric %r takes labels %s, got %s"
                % (self.name, self.labelnames, tuple(sorted(labelvalues))))
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _default(self):
        """The no-label child (for unlabeled metrics used directly) —
        cached so hot-path ``metric.inc()`` skips the labels() lookup."""
        child = self._default_child
        if child is None:
            child = self._default_child = self.labels()
        return child

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            items = list(self._children.items())
        return [
            (dict(zip(self.labelnames, key)), child) for key, child in items
        ]

    def remove_labels(self, **labelvalues) -> None:
        """Drop one labeled child from the exposition (a holder of the
        child object can keep using it; it just stops being scraped).
        Lets short-lived owners — e.g. a stopped serving instance —
        retire their series instead of growing the registry forever."""
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            self._children.pop(key, None)
            if key == ():
                self._default_child = None

    def signature(self):
        return (type(self), self.labelnames)


class Counter(_BaseMetric):
    kind = "counter"
    _child_cls = _CounterChild

    def inc(self, n: float = 1) -> None:
        self._default().inc(n)

    @property
    def value(self) -> float:
        return self._default().value


class Gauge(_BaseMetric):
    kind = "gauge"
    _child_cls = _GaugeChild

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, n: float = 1) -> None:
        self._default().inc(n)

    def dec(self, n: float = 1) -> None:
        self._default().dec(n)

    @property
    def value(self) -> float:
        return self._default().value


class Histogram(_BaseMetric):
    kind = "histogram"

    def __init__(self, name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket")
        if math.isinf(b[-1]):
            b = b[:-1]  # +Inf is implicit
        self.buckets = b

    def _new_child(self):
        return _HistogramChild(self.buckets)

    def observe(self, v: float, exemplar: Optional[Dict[str, str]] = None) -> None:
        self._default().observe(v, exemplar=exemplar)

    def signature(self):
        return (type(self), self.labelnames, self.buckets)


class _CallbackChild:
    """Read-only child whose value is computed at scrape time."""

    __slots__ = ("_fn",)

    def __init__(self, fn):
        self._fn = fn

    @property
    def value(self) -> float:
        return float(self._fn())


class CallbackCounter(_BaseMetric):
    """Collect-on-read counter: the value is pulled from ``fn()`` when a
    consumer snapshots/renders, so the producer's hot path pays NOTHING
    beyond whatever bookkeeping it already does (the executor's
    ``_cache_stats`` dicts are the canonical example).  ``fn`` must be
    monotonically non-decreasing to honor counter semantics."""

    kind = "counter"

    def __init__(self, name: str, help: str = "", fn=None):
        super().__init__(name, help, ())
        if fn is None:
            raise ValueError("CallbackCounter %r needs a fn" % name)
        self._fn = fn

    def series(self):
        return [({}, _CallbackChild(self._fn))]

    @property
    def value(self) -> float:
        return float(self._fn())


def _fmt(v: float) -> str:
    return "%.10g" % v


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str], extra: Optional[Tuple[str, str]] = None) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _escape(str(v))) for k, v in items)


class MetricsRegistry:
    """A named collection of metrics (the process default is ``REGISTRY``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _BaseMetric] = {}

    # -- registration (idempotent) -------------------------------------
    def _register(self, cls, name, help, labelnames, **kw):
        probe = cls(name, help, labelnames, **kw)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.signature() != probe.signature():
                    raise ValueError(
                        "metric %r already registered as %s%s"
                        % (name, existing.kind, existing.labelnames))
                return existing
            self._metrics[name] = probe
            return probe

    def counter(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames, buckets=buckets)

    def counter_callback(self, name: str, help: str = "", fn=None) -> CallbackCounter:
        """Register a collect-on-read counter (see CallbackCounter).
        Re-registering rebinds ``fn`` (module-reload friendly)."""
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if type(existing) is not CallbackCounter:
                    raise ValueError(
                        "metric %r already registered as %s"
                        % (name, existing.kind))
                existing._fn = fn
                return existing
            m = CallbackCounter(name, help, fn=fn)
            self._metrics[name] = m
            return m

    def get(self, name: str) -> Optional[_BaseMetric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._metrics.pop(name, None)

    def reset(self) -> None:
        """Drop every metric (tests on PRIVATE registries only: metrics
        already handed out as module-level objects keep counting into
        their detached children, so resetting the process default
        silently forks the bookkeeping)."""
        with self._lock:
            self._metrics.clear()

    # -- read surfaces --------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """{name: {type, help, series: [{labels, value}, ...]}} — values
        are scalars (counter/gauge) or {count, sum, buckets} dicts."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, object] = {}
        for m in sorted(metrics, key=lambda m: m.name):
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "series": [
                    {"labels": labels, "value": child.value}
                    for labels, child in m.series()
                ],
            }
        return out

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Sum of a counter/gauge's series whose labels contain ``labels``
        as a subset (convenience for tests / bench assertions)."""
        m = self.get(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            raise TypeError("value() reads counters/gauges, %r is a histogram" % name)
        total, seen = 0.0, False
        for lbls, child in m.series():
            if all(lbls.get(k) == str(v) for k, v in labels.items()):
                total += child.value
                seen = True
        return total if seen else default

    def render_text(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append("# HELP %s %s" % (m.name, m.help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (m.name, m.kind))
            for labels, child in sorted(m.series(), key=lambda s: sorted(s[0].items())):
                if isinstance(child, _HistogramChild):
                    v = child.value
                    for le, c in v["buckets"].items():
                        lines.append("%s_bucket%s %d" % (
                            m.name, _label_str(labels, ("le", le)), c))
                    lines.append("%s_sum%s %s" % (m.name, _label_str(labels), _fmt(v["sum"])))
                    lines.append("%s_count%s %d" % (m.name, _label_str(labels), v["count"]))
                else:
                    lines.append("%s%s %s" % (m.name, _label_str(labels), _fmt(child.value)))
        return "\n".join(lines) + "\n"

    def render_openmetrics(self) -> str:
        """OpenMetrics 1.0 text exposition.

        Differences from the 0.0.4 format that matter here: counter
        *family* names drop the ``_total`` suffix in HELP/TYPE lines
        (samples keep it), the document ends with ``# EOF``, and
        histogram bucket lines may carry an exemplar —
        ``# {trace_id="..."} <value> <wall_ts>`` — linking the bucket to
        the request that landed in it (the bridge from a p99 latency
        bucket to the flight recorder / merged trace)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in sorted(metrics, key=lambda m: m.name):
            family = m.name
            if m.kind == "counter" and family.endswith("_total"):
                family = family[: -len("_total")]
            if m.help:
                lines.append("# HELP %s %s" % (family, m.help.replace("\n", " ")))
            lines.append("# TYPE %s %s" % (family, m.kind))
            for labels, child in sorted(m.series(), key=lambda s: sorted(s[0].items())):
                if isinstance(child, _HistogramChild):
                    v = child.value
                    exemplars = child.exemplars()
                    for i, (le, c) in enumerate(v["buckets"].items()):
                        line = "%s_bucket%s %d" % (
                            family, _label_str(labels, ("le", le)), c)
                        ex = exemplars[i] if i < len(exemplars) else None
                        if ex is not None:
                            ex_labels, ex_val, ex_ts = ex
                            line += " # %s %s %.3f" % (
                                _label_str(ex_labels), _fmt(ex_val), ex_ts)
                        lines.append(line)
                    lines.append("%s_sum%s %s" % (family, _label_str(labels), _fmt(v["sum"])))
                    lines.append("%s_count%s %d" % (family, _label_str(labels), v["count"]))
                else:
                    sample = family + "_total" if m.kind == "counter" else family
                    lines.append("%s%s %s" % (sample, _label_str(labels), _fmt(child.value)))
        lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def expose(self, openmetrics: bool = False) -> Tuple[str, str]:
        """Scrape-ready ``(body, content_type)`` pair: Prometheus text
        0.0.4 by default, OpenMetrics 1.0 (with exemplars) on request —
        the serving ``/metrics`` endpoint negotiates via Accept."""
        if openmetrics:
            return (self.render_openmetrics(),
                    "application/openmetrics-text; version=1.0.0; charset=utf-8")
        return (self.render_text(),
                "text/plain; version=0.0.4; charset=utf-8")


REGISTRY = MetricsRegistry()


# ---------------------------------------------------------------------------
# federation helpers: parse / relabel / merge text expositions
#
# A fleet balancer scrapes each child's /metrics (text 0.0.4 — the
# format render_text() above emits), tags every sample with the child's
# backend id, and re-exposes the union alongside its own registry.  The
# helpers below are that pipeline: text -> family dict -> relabel ->
# merge -> text.  A routing tree of balancers federates transitively
# because relabel PREFIXES an existing backend label instead of
# clobbering it ("edge" scraping a child already labeled backend="b1"
# yields backend="edge/b1").
# ---------------------------------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+)(?:\s+\S+)?\s*$")
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _unescape(s: str) -> str:
    return re.sub(
        r"\\(.)", lambda m: {"n": "\n"}.get(m.group(1), m.group(1)), s)


def parse_exposition(text: str) -> Dict[str, Dict[str, object]]:
    """Parse a Prometheus text-0.0.4 exposition into an insertion-ordered
    family dict::

        {family: {"type": kind, "help": help,
                  "samples": [(sample_name, labels_dict, value), ...]}}

    ``value`` is a float (``+Inf`` parses to ``inf``).  Histogram
    families keep their flattened ``_bucket``/``_sum``/``_count``
    samples verbatim — merging re-emits them untouched, so federated
    output round-trips exactly.  Unrecognized/comment lines are skipped;
    a sample with no preceding TYPE gets an ``untyped`` family."""
    families: Dict[str, Dict[str, object]] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line == "# EOF":
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = families.setdefault(
                    parts[2], {"type": "untyped", "help": "",
                               "samples": []})
                if parts[1] == "TYPE":
                    fam["type"] = parts[3].strip() if len(parts) > 3 else "untyped"
                else:
                    fam["help"] = parts[3] if len(parts) > 3 else ""
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, label_blob, value_str = m.group(1), m.group(2), m.group(3)
        labels: Dict[str, str] = {}
        if label_blob:
            for k, v in _LABEL_PAIR_RE.findall(label_blob):
                labels[k] = _unescape(v)
        try:
            value = float(value_str)
        except ValueError:
            continue
        family = name
        if family not in families:
            for suffix in _HIST_SUFFIXES:
                if name.endswith(suffix) and name[: -len(suffix)] in families:
                    family = name[: -len(suffix)]
                    break
        fam = families.setdefault(
            family, {"type": "untyped", "help": "", "samples": []})
        fam["samples"].append((name, labels, value))
    return families


def relabel_exposition(families: Dict[str, Dict[str, object]],
                       label: str, value: str,
                       ) -> Dict[str, Dict[str, object]]:
    """A new family dict with ``label=value`` stamped onto every sample.
    A sample that already carries ``label`` (this scrape target is
    itself a federating balancer) gets the new value PREFIXED —
    ``value + "/" + old`` — preserving the full routing path."""
    out: Dict[str, Dict[str, object]] = {}
    for fam_name, fam in families.items():
        samples = []
        for name, labels, v in fam["samples"]:
            labels = dict(labels)
            old = labels.get(label)
            labels[label] = ("%s/%s" % (value, old)) if old else str(value)
            samples.append((name, labels, v))
        out[fam_name] = {"type": fam["type"], "help": fam["help"],
                         "samples": samples}
    return out


def merge_expositions(expositions: Sequence[Dict[str, Dict[str, object]]],
                      ) -> Dict[str, Dict[str, object]]:
    """Merge parsed expositions into one family dict: first-seen HELP /
    TYPE wins per family, samples concatenate in input order.  Callers
    are responsible for label-disjointness (relabel_exposition's
    ``backend`` tag) — duplicate series are emitted as-is."""
    merged: Dict[str, Dict[str, object]] = {}
    for families in expositions:
        for fam_name, fam in families.items():
            into = merged.get(fam_name)
            if into is None:
                merged[fam_name] = {"type": fam["type"], "help": fam["help"],
                                    "samples": list(fam["samples"])}
            else:
                if into["type"] == "untyped" and fam["type"] != "untyped":
                    into["type"] = fam["type"]
                if not into["help"]:
                    into["help"] = fam["help"]
                into["samples"].extend(fam["samples"])
    return merged


def render_exposition(families: Dict[str, Dict[str, object]]) -> str:
    """Render a (parsed/relabeled/merged) family dict back to Prometheus
    text 0.0.4 — one HELP/TYPE block per family name."""
    lines: List[str] = []
    for fam_name in sorted(families):
        fam = families[fam_name]
        if fam["help"]:
            lines.append("# HELP %s %s"
                         % (fam_name, str(fam["help"]).replace("\n", " ")))
        lines.append("# TYPE %s %s" % (fam_name, fam["type"]))
        for name, labels, value in fam["samples"]:
            if float(value) == math.inf:
                val = "+Inf"
            elif value == int(value) and abs(value) < 1e15:
                val = "%d" % int(value)
            else:
                val = _fmt(value)
            lines.append("%s%s %s" % (name, _label_str(labels), val))
    return "\n".join(lines) + "\n"


def aggregate_families(families: Dict[str, Dict[str, object]],
                       quantiles: Sequence[float] = (0.5, 0.99),
                       ) -> Dict[str, Dict[str, object]]:
    """True cross-series aggregates of a (merged) exposition — the
    fleet-/statusz view: counters sum, gauges take the worst case
    (max), histograms merge bucket-wise with count/sum/mean and
    bucket-interpolated quantile estimates::

        {"counters": {name: sum}, "gauges": {name: max},
         "histograms": {name: {"count", "sum", "mean",
                               "p50_est", "p99_est"}}}
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    histograms: Dict[str, Dict[str, object]] = {}
    for fam_name, fam in families.items():
        kind = fam["type"]
        if kind == "counter":
            counters[fam_name] = sum(v for _, _, v in fam["samples"])
        elif kind == "gauge":
            vals = [v for _, _, v in fam["samples"]]
            if vals:
                gauges[fam_name] = max(vals)
        elif kind == "histogram":
            count = 0.0
            total = 0.0
            buckets: Dict[float, float] = {}
            for name, labels, v in fam["samples"]:
                if name.endswith("_count"):
                    count += v
                elif name.endswith("_sum"):
                    total += v
                elif name.endswith("_bucket"):
                    le = labels.get("le", "+Inf")
                    f = math.inf if le == "+Inf" else float(le)
                    buckets[f] = buckets.get(f, 0.0) + v
            agg: Dict[str, object] = {
                "count": count, "sum": total,
                "mean": (total / count) if count else None,
            }
            for q in quantiles:
                key = "p%g_est" % (q * 100.0)
                agg[key] = _bucket_quantile(buckets, count, q)
            histograms[fam_name] = agg
    return {"counters": counters, "gauges": gauges,
            "histograms": histograms}


def _bucket_quantile(buckets: Dict[float, float], count: float,
                     q: float) -> Optional[float]:
    """Linear-interpolated quantile estimate from merged cumulative
    buckets (the textbook Prometheus ``histogram_quantile``)."""
    if not buckets or count <= 0:
        return None
    rank = q * count
    prev_le, prev_cum = 0.0, 0.0
    for le in sorted(buckets):
        cum = buckets[le]
        if cum >= rank:
            if le == math.inf:
                return prev_le if prev_cum else None
            width = le - prev_le
            frac = ((rank - prev_cum) / (cum - prev_cum)
                    if cum > prev_cum else 1.0)
            return prev_le + width * frac
        prev_le, prev_cum = le, cum
    return prev_le
