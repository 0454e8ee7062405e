"""SLO objectives + multi-window multi-burn-rate evaluation.

Declare objectives against registry series — availability from counter
pairs, latency/TTFT bounds from histogram buckets — and evaluate them
the way the Google SRE Workbook prescribes: error rates over *paired*
look-back windows (a short window for responsiveness, a long one to
suppress flapping), alerting when the **burn rate** (windowed error
rate / error budget) clears the pair's threshold in BOTH windows:

* fast pair  — 5m and 1h at burn >= 14.4 (2% of a 30-day budget in an
  hour): page-severity, lands as a ``critical`` event;
* slow pair  — 6h and 3d at burn >= 1.0 (budget merely on track to
  exhaust): ticket-severity, lands as a ``warning`` event.

Everything runs on a background daemon thread off counter/histogram
*deltas* (never the request hot path — ``tools/check_hot_path.py``
enforces this statically): each tick snapshots the registry, appends one
cumulative ``(ts, good, total)`` sample per objective to a bounded
history, and derives windowed rates from sample differences, clamping a
window that reaches past process start to the available history.
Verdicts surface three ways: the ``/sloz`` document, the
``slo_burn_rate{slo,window}`` / ``slo_alert_firing{slo,pair}`` gauge
families, and firing/clearing transitions appended to the operational
event ring (``/eventz``).

The SLO signal is observe-only: nothing in serving reads it for control
decisions by default.

Quickstart::

    from paddle_tpu_torch.monitor import slo

    engine = slo.install([
        slo.availability("infer", good="serving_completed_total",
                         bad=("serving_failed_total",
                              "serving_expired_total"),
                         target=0.999, server="lenet"),
        slo.latency("infer_p99", "serving_request_latency_seconds",
                    threshold_s=0.25, target=0.99, server="lenet"),
        slo.latency("ttft", "serving_decode_ttft_seconds",
                    threshold_s=0.5, target=0.95),
    ], interval_s=10.0)
    ...
    engine.sloz()        # the /sloz document
    slo.uninstall()

``window_scale`` shrinks every window (and both thresholds' meaning
follows automatically) so tests and benches can drive a full
fire-and-clear cycle in seconds.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.monitor.registry import REGISTRY, MetricsRegistry

__all__ = [
    "WINDOWS", "PAIRS", "Objective", "availability", "latency",
    "SloEngine", "install", "get", "uninstall",
]

# window label -> seconds (scaled by SloEngine(window_scale=...))
WINDOWS: Dict[str, float] = {
    "5m": 300.0, "1h": 3600.0, "6h": 21600.0, "3d": 259200.0,
}

# (pair name, (short window, long window), burn threshold, severity)
PAIRS: Tuple = (
    ("fast", ("5m", "1h"), 14.4, "critical"),
    ("slow", ("6h", "3d"), 1.0, "warning"),
)


def _as_names(names) -> Tuple[str, ...]:
    if isinstance(names, str):
        return (names,)
    return tuple(names)


def _sum_counters(snap: Dict[str, object], names: Sequence[str],
                  labels: Dict[str, str]) -> float:
    """Sum every series of the named counter families whose labels are a
    superset of ``labels`` (absent family = 0 — objectives may be
    declared before the first request registers the series)."""
    total = 0.0
    for name in names:
        fam = snap.get(name)
        if not fam:
            continue
        for s in fam["series"]:
            slabels = s["labels"]
            if all(slabels.get(k) == v for k, v in labels.items()):
                total += float(s["value"])
    return total


def _merged_histogram(snap: Dict[str, object], name: str,
                      labels: Dict[str, str]):
    """(count, sum, {le_float: cumulative}) merged across every matching
    series of the named histogram family."""
    fam = snap.get(name)
    count = 0.0
    total = 0.0
    buckets: Dict[float, float] = {}
    if not fam:
        return count, total, buckets
    for s in fam["series"]:
        if not all(s["labels"].get(k) == v for k, v in labels.items()):
            continue
        v = s["value"]
        if not isinstance(v, dict):
            continue
        count += float(v.get("count", 0))
        total += float(v.get("sum", 0.0))
        for le, cum in v.get("buckets", {}).items():
            f = float("inf") if le == "+Inf" else float(le)
            buckets[f] = buckets.get(f, 0.0) + float(cum)
    return count, total, buckets


class Objective:
    """One declared objective: ``sample(snapshot)`` returns the
    cumulative ``(good, total)`` event counts the engine differences."""

    kind = "custom"

    def __init__(self, name: str, target: float, description: str = "",
                 sample_fn: Optional[Callable] = None):
        if not 0.0 < float(target) < 1.0:
            raise ValueError(
                "target must be in (0, 1) (got %r)" % (target,))
        self.name = str(name)
        self.target = float(target)
        self.description = description or self.name
        self._sample_fn = sample_fn

    @property
    def budget(self) -> float:
        """The error budget: the tolerated bad-event fraction."""
        return 1.0 - self.target

    def sample(self, snap: Dict[str, object]) -> Tuple[float, float]:
        if self._sample_fn is None:
            raise NotImplementedError
        return self._sample_fn(snap)

    def describe(self) -> Dict[str, object]:
        return {"name": self.name, "kind": self.kind,
                "target": self.target, "description": self.description}


class _Availability(Objective):
    kind = "availability"

    def __init__(self, name: str, good, bad, target: float,
                 description: str, labels: Dict[str, str]):
        super().__init__(name, target, description)
        self.good_metrics = _as_names(good)
        self.bad_metrics = _as_names(bad)
        self.labels = dict(labels)

    def sample(self, snap):
        g = _sum_counters(snap, self.good_metrics, self.labels)
        b = _sum_counters(snap, self.bad_metrics, self.labels)
        return g, g + b

    def describe(self):
        d = super().describe()
        d["good_metrics"] = list(self.good_metrics)
        d["bad_metrics"] = list(self.bad_metrics)
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


class _Latency(Objective):
    kind = "latency"

    def __init__(self, name: str, histogram: str, threshold_s: float,
                 target: float, description: str, labels: Dict[str, str]):
        super().__init__(name, target, description)
        self.histogram = str(histogram)
        self.threshold_s = float(threshold_s)
        self.labels = dict(labels)

    def sample(self, snap):
        count, _, buckets = _merged_histogram(
            snap, self.histogram, self.labels)
        if not buckets:
            return 0.0, 0.0
        # good = observations <= the smallest bucket bound covering the
        # threshold (align thresholds with bucket boundaries for an
        # exact count; otherwise this rounds the bound UP one bucket)
        bounds = sorted(le for le in buckets if le >= self.threshold_s)
        good = buckets[bounds[0]] if bounds else count
        return float(good), float(count)

    def describe(self):
        d = super().describe()
        d["histogram"] = self.histogram
        d["threshold_s"] = self.threshold_s
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


def availability(name: str, good, bad, target: float = 0.999,
                 description: str = "", **labels) -> Objective:
    """``availability >= target`` over counter families: ``good`` /
    ``bad`` are counter names (or sequences of them), summed over every
    series whose labels are a superset of ``**labels``."""
    return _Availability(name, good, bad, target,
                         description or "%s availability >= %g%%"
                         % (name, target * 100.0), labels)


def latency(name: str, histogram: str, threshold_s: float,
            target: float = 0.99, description: str = "",
            **labels) -> Objective:
    """``quantile(target) <= threshold_s`` over a histogram family —
    i.e. at least ``target`` of observations under the threshold.  A
    p99-latency or TTFT bound is this with target 0.99 / 0.95."""
    return _Latency(name, histogram, threshold_s, target,
                    description or "%s p%g <= %gs"
                    % (name, target * 100.0, threshold_s), labels)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------
_BURN = REGISTRY.gauge(
    "slo_burn_rate",
    "windowed error rate / error budget per objective and look-back "
    "window (1.0 = budget exhausting exactly on schedule)",
    ("slo", "window"))
_FIRING = REGISTRY.gauge(
    "slo_alert_firing",
    "1 while the objective's multi-window burn-rate alert pair is "
    "firing, else 0", ("slo", "pair"))


class SloEngine:
    """Background evaluator for a set of objectives.

    ``interval_s`` is the sampling/evaluation cadence; ``window_scale``
    multiplies every look-back window (tests/benches use e.g. ``0.01``
    to run a fire-and-clear cycle in seconds); ``clock`` is injectable
    for deterministic tests.  ``start()`` spawns the daemon thread;
    ``evaluate_once()`` runs one synchronous tick (usable without
    ``start()``)."""

    def __init__(self, objectives: Iterable[Objective],
                 interval_s: float = 10.0,
                 window_scale: float = 1.0,
                 registry: MetricsRegistry = REGISTRY,
                 clock: Callable[[], float] = time.monotonic):
        self.objectives: List[Objective] = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError("duplicate objective names: %r" % (names,))
        self.interval_s = float(interval_s)
        self.window_scale = float(window_scale)
        self._registry = registry
        self._clock = clock
        self._windows = {label: secs * self.window_scale
                         for label, secs in WINDOWS.items()}
        self._lock = threading.Lock()
        # objective name -> list of (ts, good, total), oldest first
        self._history: Dict[str, List[Tuple[float, float, float]]] = {
            o.name: [] for o in self.objectives}
        self._max_keep = max(self._windows.values())
        # objective name -> {pair name -> {"firing", "since"}}
        self._alerts: Dict[str, Dict[str, Dict[str, object]]] = {
            o.name: {pair: {"firing": False, "since": None}
                     for pair, _, _, _ in PAIRS}
            for o in self.objectives}
        self._last: Dict[str, Dict[str, object]] = {}
        self._ticks = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def start(self) -> "SloEngine":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="slo-engine", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        # retire this engine's gauge series from the exposition
        for o in self.objectives:
            for w in self._windows:
                _BURN.remove_labels(slo=o.name, window=w)
            for pair, _, _, _ in PAIRS:
                _FIRING.remove_labels(slo=o.name, pair=pair)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.evaluate_once()
            except Exception:
                pass  # a bad objective must never kill the evaluator

    # ------------------------------------------------------------------
    def evaluate_once(self) -> Dict[str, object]:
        """One tick: sample every objective, derive windowed burn rates,
        update gauges + alert state, emit transition events.  Returns
        the fresh ``/sloz`` document."""
        snap = self._registry.snapshot()
        now = self._clock()
        with self._lock:
            self._ticks += 1
            for obj in self.objectives:
                try:
                    good, total = obj.sample(snap)
                except Exception:
                    continue  # sampled next tick; stale verdict stands
                hist = self._history[obj.name]
                hist.append((now, float(good), float(total)))
                cutoff = now - self._max_keep - 2.0 * self.interval_s
                while len(hist) > 2 and hist[1][0] <= cutoff:
                    hist.pop(0)
                self._last[obj.name] = self._evaluate_locked(
                    obj, hist, now)
            return self._sloz_locked()

    def _evaluate_locked(self, obj: Objective, hist, now: float):
        windows: Dict[str, Dict[str, float]] = {}
        for label, span_s in self._windows.items():
            burn, rate, dt = self._window_burn(obj, hist, now, span_s)
            windows[label] = {
                "burn": round(burn, 4),
                "error_rate": round(rate, 6),
                "span_s": round(dt, 3),
            }
            _BURN.labels(slo=obj.name, window=label).set(round(burn, 4))
        alerts = []
        for pair, (short_w, long_w), threshold, severity in PAIRS:
            firing = (windows[short_w]["burn"] >= threshold
                      and windows[long_w]["burn"] >= threshold)
            state = self._alerts[obj.name][pair]
            if firing != state["firing"]:
                state["firing"] = firing
                state["since"] = time.time()
                _events.emit(
                    "slo/fired" if firing else "slo/cleared",
                    severity=severity if firing else "info",
                    cat="slo", slo=obj.name, pair=pair,
                    threshold=threshold,
                    burn_short=windows[short_w]["burn"],
                    burn_long=windows[long_w]["burn"])
            _FIRING.labels(slo=obj.name, pair=pair).set(
                1.0 if state["firing"] else 0.0)
            alerts.append({
                "pair": pair, "severity": severity,
                "windows": [short_w, long_w], "threshold": threshold,
                "firing": state["firing"], "since": state["since"],
            })
        good, total = hist[-1][1], hist[-1][2]
        verdict = dict(obj.describe())
        verdict.update({
            "good": good, "total": total,
            "windows": windows, "alerts": alerts,
            "ok": not any(a["firing"] for a in alerts),
        })
        return verdict

    def _window_burn(self, obj: Objective, hist, now: float,
                     span_s: float):
        """(burn, error_rate, actual_span) for one look-back window,
        differencing the newest sample against the oldest sample inside
        the window (clamped to full history when the window reaches
        past the first sample)."""
        ts, good, total = hist[-1]
        base = hist[0]
        for rec in hist:
            if rec[0] >= now - span_s:
                base = rec
                break
        dg, dt_total = good - base[1], total - base[2]
        if dt_total <= 0:
            return 0.0, 0.0, ts - base[0]
        rate = min(1.0, max(0.0, 1.0 - dg / dt_total))
        return rate / obj.budget, rate, ts - base[0]

    # ------------------------------------------------------------------
    def sloz(self) -> Dict[str, object]:
        """The ``/sloz`` document (last evaluated verdicts)."""
        with self._lock:
            return self._sloz_locked()

    def _sloz_locked(self) -> Dict[str, object]:
        verdicts = [dict(self._last[o.name]) for o in self.objectives
                    if o.name in self._last]
        return {
            "interval_s": self.interval_s,
            "window_scale": self.window_scale,
            "ticks": self._ticks,
            "ok": all(v["ok"] for v in verdicts) if verdicts else True,
            "objectives": verdicts,
        }


# ---------------------------------------------------------------------------
# module slot (flight.py pattern): the engine /sloz serves
# ---------------------------------------------------------------------------
_engine: Optional[SloEngine] = None
_slot_lock = threading.Lock()


def install(objectives: Iterable[Objective],
            interval_s: float = 10.0,
            window_scale: float = 1.0,
            start: bool = True, **kw) -> SloEngine:
    """Construct the process SLO engine, start its evaluator thread
    (unless ``start=False``), and make it the one ``/sloz`` serves.
    Replaces (and stops) any previously installed engine."""
    global _engine
    engine = SloEngine(objectives, interval_s=interval_s,
                       window_scale=window_scale, **kw)
    with _slot_lock:
        prev, _engine = _engine, engine
    if prev is not None:
        prev.stop()
    if start:
        engine.start()
    return engine


def get() -> Optional[SloEngine]:
    """The installed process engine, or None."""
    return _engine


def uninstall() -> None:
    """Stop and remove the installed engine (idempotent)."""
    global _engine
    with _slot_lock:
        prev, _engine = _engine, None
    if prev is not None:
        prev.stop()


def sloz() -> Dict[str, object]:
    """The process ``/sloz`` document (works with no engine installed —
    admin endpoints stay total)."""
    eng = _engine
    if eng is None:
        return {"installed": False, "ok": True, "objectives": []}
    doc = eng.sloz()
    doc["installed"] = True
    return doc
