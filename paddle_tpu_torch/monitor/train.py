"""paddle_tpu_torch.monitor.train — the training control tower.

Serving grew a full observability stack (registry -> tracing -> fleet
federation + SLO burn rates); this module is the TRAINING counterpart,
built around goodput accounting (where did the wall-clock go?) and
health attribution (is this run OK?):

* **Step-phase ledger** (``StepPhaseLedger``) — ``train_from_dataset``
  attributes every wall-clock second of the epoch to one phase:
  ``data_wait`` (reader/prefetch stall), ``h2d``, ``device_execute``,
  ``ps_wait`` (dense+sparse pull joins), ``checkpoint`` (quiesce+save;
  sync and async-commit tracked separately), ``restore_fallback``
  (resume-time restore), ``other`` (loop bookkeeping remainder).
  Accounting is WINDOW-EXCLUSIVE: an outer window charges only the
  seconds not already claimed by a nested charge, so the phases sum to
  the elapsed wall-clock exactly — ``finish_epoch`` asserts the
  measured total never exceeds wall by more than 1% (an overcount means
  double-charged time, a ledger bug worth failing loudly on).
  Exported as ``train_phase_seconds_total{phase=}`` counters plus
  ``train_examples_per_second`` / ``train_steps_per_second`` gauges and
  a static-FLOPs ``train_mfu_ratio`` estimate
  (``estimate_block_flops`` walks the block's matmul/conv op shapes).

* **Anomaly watchdog** (``TrainWatchdog``) — EWMA + z-score detectors
  for NaN/Inf loss, loss spikes, grad-norm blowups, and step-time
  regressions/stragglers.  Each detection lands a severity-tagged
  ``train/anomaly`` event (kind + step) in the process ``EventRing``;
  kinds listed in ``halt_on`` raise a typed ``TrainAnomalyError`` so a
  controller can stop a poisoned run cleanly.  The clock is injectable
  for deterministic tests.

* **Scrapeable surface** — ``Executor.start_train_admin(port=0)``
  (implemented here as ``start_train_admin(executor, ...)``) serves
  ``/metrics`` (Prometheus/OpenMetrics), ``/trainz`` (ledger snapshot +
  last-N step table + watchdog state + checkpoint/resume history),
  ``/statusz``, ``/tracez``, ``/eventz`` and ``/healthz`` — the same
  shapes the fleet federation scraper consumes, so a trainer registers
  as a child of ``FleetBalancer.add_scrape_target`` and shows up in the
  one pane of glass next to the serving backends.

* **Step log** (``StepLog`` / ``replay_step_log``) — a per-step JSONL
  stream (``train_from_dataset(train_log=...)``) replayable offline:
  ``replay_step_log`` rebuilds the phase totals + step table from the
  file, and ``tools/train_top.py --replay`` renders it.

Everything gates on the proven one-is-None-check pattern: a disarmed
train loop pays a single attribute check per step, and the armed ledger
is plain float arithmetic (no allocation, no locking).  On the card the
ledger's ``device_execute`` window closes after the fetches' host copy,
where the step's device time becomes visible to the host: a run with no
fetch returns before the card finishes, and its device time lands in the
next window.
"""
from __future__ import annotations

import collections
import json
import math
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import registry as _registry

__all__ = [
    "PHASES",
    "StepPhaseLedger",
    "TrainWatchdog",
    "TrainAnomalyError",
    "StepLog",
    "estimate_block_flops",
    "replay_step_log",
    "start_train_admin",
    "stop_train_admin",
    "trainz_doc",
    "batch_examples",
]

PHASES = (
    "data_wait",
    "h2d",
    "device_execute",
    "ps_wait",
    "checkpoint",
    "restore_fallback",
    "other",
)

_PHASE_TOTAL = _registry.REGISTRY.counter(
    "train_phase_seconds_total",
    "train_from_dataset wall-clock seconds attributed per phase "
    "(data_wait|h2d|device_execute|ps_wait|checkpoint|restore_fallback|"
    "other); phases sum to the epoch's elapsed time",
    ("phase",))
_EXAMPLES_PS = _registry.REGISTRY.gauge(
    "train_examples_per_second",
    "training throughput: examples consumed per second (epoch cumulative)")
_STEPS_PS = _registry.REGISTRY.gauge(
    "train_steps_per_second",
    "training throughput: optimizer steps per second (epoch cumulative)")
_MFU_RATIO = _registry.REGISTRY.gauge(
    "train_mfu_ratio",
    "model FLOPs utilization estimate: static per-step block FLOPs "
    "(matmul/conv shapes) x steps/s over the platform peak")


# ---------------------------------------------------------------------------
# Static-FLOPs MFU estimate
# ---------------------------------------------------------------------------
# the H100 SXM's dense bf16 tensor-core peak: the one platform peak the
# port knows, as the JAX package knows one for its TPU
_H100_PEAK_FLOPS = 989.4e12


def _default_peak_flops(device=None) -> Optional[float]:
    """Platform peak for the MFU denominator.  Env override first
    (``PADDLE_TPU_PEAK_FLOPS``); else 989.4 TFLOP/s for a CUDA device
    whose name holds "H100" (dense bf16), nominal 1 TFLOP/s for the CPU
    testbed, and None (no MFU gauge) for any other CUDA device.
    ``device``: the training executor's ``torch.device``; None means
    ``cuda:0`` where a card is present, else the CPU."""
    env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    import torch

    if device is None:
        device = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cpu":
        return 1e12
    if device.type == "cuda" and "H100" in torch.cuda.get_device_name(device):
        return _H100_PEAK_FLOPS
    return None


def _dim(d, batch: int) -> int:
    # dynamic (-1/None) dims stand in for the observed batch size
    return int(batch) if d is None or int(d) < 0 else int(d)


def _shape(block, name: str, batch: int) -> Optional[List[int]]:
    v = block._find_var_recursive(name) if name else None
    shape = getattr(v, "shape", None)
    if shape is None:
        return None
    return [_dim(d, batch) for d in shape]


def _matmul_like_flops(block, op, batch: int) -> float:
    """2*M*K*N for ``mul``/``matmul`` from the operands' static shapes."""
    xs = op.input("X")
    ys = op.input("Y")
    x = _shape(block, xs[0] if xs else None, batch)
    y = _shape(block, ys[0] if ys else None, batch)
    if not x or not y:
        return 0.0
    if op.type == "mul" or op.type == "mul_grad":
        kx = int(op.attr("x_num_col_dims", 1))
        ky = int(op.attr("y_num_col_dims", 1))
        m = _prod(x[:kx])
        k = _prod(x[kx:])
        n = _prod(y[ky:])
        return 2.0 * m * k * n
    # matmul: batch dims are everything before the trailing two
    tx = bool(op.attr("transpose_X", False))
    ty = bool(op.attr("transpose_Y", False))
    if len(x) < 2 or len(y) < 2:
        return 0.0
    bdims = _prod(x[:-2]) if len(x) > 2 else 1
    m = x[-1] if tx else x[-2]
    k = x[-2] if tx else x[-1]
    n = y[-2] if ty else y[-1]
    return 2.0 * bdims * m * k * n


def _conv2d_flops(block, op, batch: int) -> float:
    outs = op.output("Output")
    filts = op.input("Filter")
    out = _shape(block, outs[0] if outs else None, batch)
    filt = _shape(block, filts[0] if filts else None, batch)
    if not out or not filt or len(filt) != 4:
        return 0.0
    # per output element: one MAC across (C_in/groups * kh * kw)
    return 2.0 * _prod(out) * filt[1] * filt[2] * filt[3]


def _prod(dims) -> int:
    out = 1
    for d in dims:
        out *= int(d)
    return out


def estimate_block_flops(program, batch: int = 1) -> float:
    """Static per-step FLOPs estimate from the program's matmul-family
    op shapes (``mul``/``matmul``/``conv2d``; dynamic dims resolve to
    ``batch``).  Grad ops count double their forward op — the backward
    of one matmul is two matmuls (dX and dY) — which covers a
    forward+backward+optimizer block without tracing it.  Best-effort:
    ops with unresolvable shapes contribute 0, so the MFU gauge is a
    floor, never an overclaim."""
    total = 0.0
    for block in getattr(program, "blocks", []):
        for op in block.ops:
            base = op.type[:-5] if op.type.endswith("_grad") else op.type
            scale = 2.0 if op.type.endswith("_grad") else 1.0
            if base in ("mul", "matmul"):
                total += scale * _matmul_like_flops(block, op, batch)
            elif base == "conv2d":
                if op.type.endswith("_grad"):
                    # grad op outputs Input@GRAD/Filter@GRAD, not Output;
                    # approximate as 2x the forward conv via its inputs
                    fwd = next(
                        (o for o in block.ops
                         if o.type == "conv2d"
                         and o.input("Filter") == op.input("Filter")),
                        None)
                    if fwd is not None:
                        total += 2.0 * _conv2d_flops(block, fwd, batch)
                else:
                    total += _conv2d_flops(block, op, batch)
    return total


def batch_examples(feed) -> int:
    """Leading-dim example count of a feed dict (throughput gauges)."""
    if not isinstance(feed, dict):
        return 0
    for v in feed.values():
        shape = getattr(v, "shape", None)
        if shape is None:
            try:
                return len(v)
            except TypeError:
                continue
        if len(shape):
            return int(shape[0])
    return 0


# ---------------------------------------------------------------------------
# Step-phase ledger
# ---------------------------------------------------------------------------
class StepPhaseLedger:
    """Wall-clock attribution for one ``train_from_dataset`` epoch.

    The accounting contract is WINDOW-EXCLUSIVE nesting: ``charge``
    adds seconds to a phase directly; ``window_begin``/``window_end``
    measure an elapsed interval and charge only the part NOT already
    claimed by charges made inside it.  ``run()`` opens a
    device_execute window around the whole dispatch, so its internal
    h2d / ps_wait charges subtract out; the data_wait iterator wrapper
    likewise excludes the sparse-prefetch joins that run inside
    ``next()``.  The invariant — no second is ever charged twice — is
    what lets ``finish_epoch`` assert phases-sum ~= wall-clock."""

    def __init__(self, step_table: int = 64,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 metrics: bool = True, tolerance: float = 0.01,
                 device=None):
        self.seconds: Dict[str, float] = {p: 0.0 for p in PHASES}
        self.checkpoint_sync_s = 0.0
        self.checkpoint_commit_s = 0.0
        self.steps: collections.deque = collections.deque(maxlen=step_table)
        self.n_steps = 0
        self.examples_total = 0
        self.flops_per_step = flops_per_step
        self.peak_flops = (float(peak_flops) if peak_flops
                          else _default_peak_flops(device))
        self.tolerance = float(tolerance)
        self.wall_s = 0.0
        self.epoch_t0: Optional[float] = None
        self._inner = 0.0  # monotone: every charged second, all phases
        self._finished = False
        self._flushed: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._step_mark: Dict[str, float] = dict(self.seconds)
        self._sps = 0.0
        self._eps = 0.0
        self._mfu = 0.0
        # resolve the labeled counter children ONCE — the per-step flush
        # must not pay a labels() dict hash per phase
        self._counters = (
            {p: _PHASE_TOTAL.labels(phase=p) for p in PHASES}
            if metrics else None)

    # hot-path: begin ledger-charge (armed-ledger per-step accounting:
    # plain float arithmetic only — no allocation, no device sync, no
    # event emission; chip_smoke.py phase 32 measures the armed tax)
    def begin_epoch(self) -> None:
        self.epoch_t0 = time.perf_counter()
        self._finished = False

    def charge(self, phase: str, seconds: float) -> None:
        if seconds <= 0.0:
            return
        self.seconds[phase] += seconds
        self._inner += seconds

    def window_begin(self) -> Tuple[float, float]:
        return (time.perf_counter(), self._inner)

    def window_end(self, token: Tuple[float, float], phase: str,
                   detail: Optional[str] = None) -> float:
        t0, inner0 = token
        dt = (time.perf_counter() - t0) - (self._inner - inner0)
        if dt > 0.0:
            self.seconds[phase] += dt
            self._inner += dt
            if detail == "sync":
                self.checkpoint_sync_s += dt
            elif detail == "commit":
                self.checkpoint_commit_s += dt
        return dt
    # hot-path: end ledger-charge

    def timed_iter(self, batches) -> Iterator:
        """Wrap the batch iterator: each ``next()`` charges data_wait,
        minus any nested ps_wait the overlapped-prefetch join claimed
        inside it.  Close propagates to the wrapped iterator so the
        prefetch producer still shuts down on early exit."""
        src = iter(batches)
        try:
            while True:
                tok = self.window_begin()
                try:
                    v = next(src)
                except StopIteration:
                    return
                self.window_end(tok, "data_wait")
                yield v
        finally:
            closer = getattr(src, "close", None)
            if closer is not None:
                closer()

    def step_done(self, step: int, duration_s: float, examples: int = 0,
                  loss: Optional[float] = None) -> Dict[str, Any]:
        """Per-step bookkeeping: flush phase deltas to the registry
        counters, refresh the throughput/MFU gauges, append the step-
        table row.  Returns the row (the step log writes it)."""
        self.n_steps += 1
        self.examples_total += int(examples)
        if self._counters is not None:
            for p, child in self._counters.items():
                d = self.seconds[p] - self._flushed[p]
                if d > 0.0:
                    child.inc(d)
                    self._flushed[p] = self.seconds[p]
        elapsed = (time.perf_counter() - self.epoch_t0
                   if self.epoch_t0 is not None else 0.0)
        if elapsed > 0.0:
            self._sps = self.n_steps / elapsed
            self._eps = self.examples_total / elapsed
            if self.flops_per_step and self.peak_flops:
                self._mfu = self.flops_per_step * self._sps / self.peak_flops
        if self._counters is not None:
            _STEPS_PS.set(self._sps)
            _EXAMPLES_PS.set(self._eps)
            if self.peak_flops:  # no known peak: the gauge stays unset
                _MFU_RATIO.set(self._mfu)
        row: Dict[str, Any] = {
            "step": int(step),
            "duration_s": round(float(duration_s), 6),
            "examples": int(examples),
            "phases": {
                p: round(self.seconds[p] - self._step_mark[p], 6)
                for p in PHASES
                if self.seconds[p] - self._step_mark[p] > 0.0
            },
        }
        if loss is not None:
            row["loss"] = loss if math.isfinite(loss) else repr(loss)
        self._step_mark = dict(self.seconds)
        self.steps.append(row)
        return row

    def finish_epoch(self, strict: bool = True) -> None:
        """Close the epoch: the unattributed remainder lands in
        ``other`` and the 1% sum contract is asserted (strict=False on
        exceptional exits — the epoch's own error must propagate, and a
        partial ledger is still worth reading)."""
        if self._finished or self.epoch_t0 is None:
            return
        self._finished = True
        elapsed = time.perf_counter() - self.epoch_t0
        measured = sum(self.seconds.values())
        self.seconds["other"] += max(0.0, elapsed - measured)
        self.wall_s = elapsed
        if self._counters is not None:
            for p, child in self._counters.items():
                d = self.seconds[p] - self._flushed[p]
                if d > 0.0:
                    child.inc(d)
                    self._flushed[p] = self.seconds[p]
        if strict and measured > elapsed * (1.0 + self.tolerance) + 1e-6:
            raise AssertionError(
                "phase ledger overcount: phases sum to %.6fs but the epoch "
                "wall-clock is %.6fs (> %.0f%% tolerance) — some interval "
                "was charged twice" % (measured, elapsed,
                                       self.tolerance * 100.0))

    def snapshot(self) -> Dict[str, Any]:
        wall = self.wall_s
        if not wall and self.epoch_t0 is not None:
            wall = time.perf_counter() - self.epoch_t0
        total = sum(self.seconds.values())
        return {
            "phases": {p: round(self.seconds[p], 6) for p in PHASES},
            "fractions": {
                p: round(self.seconds[p] / total, 4) if total else 0.0
                for p in PHASES
            },
            "wall_s": round(wall, 6),
            "n_steps": self.n_steps,
            "examples": self.examples_total,
            "steps_per_second": round(self._sps, 4),
            "examples_per_second": round(self._eps, 4),
            "mfu_ratio": round(self._mfu, 6),
            "flops_per_step": self.flops_per_step,
            "peak_flops": self.peak_flops,
            "checkpoint": {
                "sync_s": round(self.checkpoint_sync_s, 6),
                "commit_s": round(self.checkpoint_commit_s, 6),
            },
            "steps": list(self.steps),
            "finished": self._finished,
        }


# ---------------------------------------------------------------------------
# Anomaly watchdog
# ---------------------------------------------------------------------------
class TrainAnomalyError(RuntimeError):
    """Typed halt raised by ``TrainWatchdog`` for kinds in ``halt_on``;
    carries the anomaly kind, the global step, and the offending
    value so a controller can route on it without parsing text."""

    def __init__(self, kind: str, step: int, value=None):
        super().__init__(
            "training anomaly %r at step %d (value=%r)" % (kind, step, value))
        self.kind = kind
        self.step = step
        self.value = value


class _Ewma:
    """EWMA mean + variance (z-score detector state)."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float):
        self.alpha = float(alpha)
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def z(self, x: float) -> float:
        if self.n < 2:
            return 0.0
        return (x - self.mean) / math.sqrt(self.var + 1e-12)

    def update(self, x: float) -> None:
        if self.n == 0:
            self.mean = x
        else:
            d = x - self.mean
            self.mean += self.alpha * d
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * d * d)
        self.n += 1


class TrainWatchdog:
    """EWMA + z-score anomaly detection over the per-step signals.

    Detections (each emits one severity-tagged ``train/anomaly`` event
    with ``kind`` + ``step`` into the process EventRing):

    * ``nan_loss`` (critical) — the loss went NaN/Inf.  Default member
      of ``halt_on``: ``raise_if_halt`` raises ``TrainAnomalyError``.
    * ``loss_spike`` (error) — loss z-score above ``z_threshold`` after
      ``warmup_steps`` observations.
    * ``grad_norm_blowup`` (error) — grad-norm z-score above threshold
      (NaN/Inf grad norm reports here too, as critical).
    * ``step_time_regression`` (warning) — step time z-score above
      threshold AND 1.5x the EWMA mean (the straggler signal; the
      absolute guard keeps micro-jitter on fast steps quiet).

    ``clock`` is injectable (event timestamps / tests); the detector
    itself is driven purely by the values passed to ``observe_step``.
    """

    def __init__(self, loss_index: int = 0, alpha: float = 0.1,
                 z_threshold: float = 8.0, warmup_steps: int = 8,
                 halt_on: Tuple[str, ...] = ("nan_loss",),
                 clock=time.time, history: int = 64):
        self.loss_index = loss_index
        self.z_threshold = float(z_threshold)
        self.warmup_steps = int(warmup_steps)
        self.halt_on = tuple(halt_on or ())
        self.clock = clock
        self.anomalies: collections.deque = collections.deque(maxlen=history)
        self.halted: Optional[Dict[str, Any]] = None
        self.steps_observed = 0
        self._loss = _Ewma(alpha)
        self._grad = _Ewma(alpha)
        self._dur = _Ewma(alpha)

    def _flag(self, found: List[Dict[str, Any]], kind: str, severity: str,
              step: int, value) -> None:
        safe = (float(value) if isinstance(value, (int, float))
                and math.isfinite(value) else repr(value))
        found.append({"kind": kind, "severity": severity,
                      "step": int(step), "value": safe,
                      "ts": float(self.clock())})

    def observe_step(self, step: int, loss: Optional[float] = None,
                     grad_norm: Optional[float] = None,
                     step_time_s: Optional[float] = None
                     ) -> List[Dict[str, Any]]:
        """Feed one step's signals; returns the anomalies found (also
        appended to ``self.anomalies`` and emitted as events).  Does NOT
        raise — callers log the step first, then ``raise_if_halt``."""
        found: List[Dict[str, Any]] = []
        warmed = self.steps_observed >= self.warmup_steps
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                self._flag(found, "nan_loss", "critical", step, loss)
            else:
                if warmed and abs(self._loss.z(loss)) > self.z_threshold:
                    self._flag(found, "loss_spike", "error", step, loss)
                self._loss.update(loss)
        if grad_norm is not None:
            grad_norm = float(grad_norm)
            if not math.isfinite(grad_norm):
                self._flag(found, "grad_norm_blowup", "critical",
                           step, grad_norm)
            else:
                if warmed and self._grad.z(grad_norm) > self.z_threshold:
                    self._flag(found, "grad_norm_blowup", "error",
                               step, grad_norm)
                self._grad.update(grad_norm)
        if step_time_s is not None:
            step_time_s = float(step_time_s)
            if (warmed and self._dur.z(step_time_s) > self.z_threshold
                    and step_time_s > 1.5 * self._dur.mean):
                self._flag(found, "step_time_regression", "warning",
                           step, step_time_s)
            self._dur.update(step_time_s)
        self.steps_observed += 1
        for rec in found:
            self.anomalies.append(rec)
            _events.emit("train/anomaly", severity=rec["severity"],
                         message="%s at step %d (value=%s)"
                         % (rec["kind"], rec["step"], rec["value"]),
                         cat="train", anomaly=rec["kind"],
                         step=rec["step"])
        return found

    def raise_if_halt(self, anomalies: List[Dict[str, Any]]) -> None:
        for rec in anomalies:
            if rec["kind"] in self.halt_on:
                self.halted = rec
                raise TrainAnomalyError(rec["kind"], rec["step"],
                                        rec.get("value"))

    def state(self) -> Dict[str, Any]:
        return {
            "steps_observed": self.steps_observed,
            "z_threshold": self.z_threshold,
            "warmup_steps": self.warmup_steps,
            "halt_on": list(self.halt_on),
            "halted": self.halted,
            "loss": {"mean": self._loss.mean,
                     "std": math.sqrt(self._loss.var)},
            "grad_norm": {"mean": self._grad.mean,
                          "std": math.sqrt(self._grad.var)},
            "step_time_s": {"mean": self._dur.mean,
                            "std": math.sqrt(self._dur.var)},
            "anomalies": list(self.anomalies),
        }


# ---------------------------------------------------------------------------
# Per-step JSONL step log
# ---------------------------------------------------------------------------
class StepLog:
    """Append-only JSONL stream of per-step records; line-flushed so a
    ``tail -f`` (or ``train_top --replay``) sees steps as they land."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record, sort_keys=True, default=str) + "\n")
        self._f.flush()

    def close(self) -> None:
        try:
            self._f.close()
        except Exception:
            pass


def replay_step_log(path: str) -> Dict[str, Any]:
    """Rebuild a /trainz-shaped summary from a step log written by
    ``train_from_dataset(train_log=...)`` — phase totals, step table,
    anomaly list — for offline analysis of a run that's gone."""
    phases = {p: 0.0 for p in PHASES}
    steps: List[Dict[str, Any]] = []
    anomalies: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    examples = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if rec.get("event"):
                events.append(rec)
                continue
            steps.append(rec)
            examples += int(rec.get("examples", 0))
            for p, v in (rec.get("phases") or {}).items():
                if p in phases:
                    phases[p] += float(v)
            anomalies.extend(rec.get("anomalies") or [])
    wall = sum(float(r.get("duration_s", 0.0)) for r in steps)
    return {
        "path": path,
        "phases": {p: round(v, 6) for p, v in phases.items()},
        "n_steps": len(steps),
        "examples": examples,
        "wall_s": round(wall, 6),
        "steps_per_second": round(len(steps) / wall, 4) if wall else 0.0,
        "examples_per_second": round(examples / wall, 4) if wall else 0.0,
        "steps": steps[-64:],
        "anomalies": anomalies,
        "events": events,
    }


# ---------------------------------------------------------------------------
# /trainz + the trainer admin endpoint
# ---------------------------------------------------------------------------
def trainz_doc(executor) -> Dict[str, Any]:
    """The ``/trainz`` document: ledger snapshot, watchdog state, and
    the executor's checkpoint/resume bookkeeping (which checkpoint
    served a resume, how many integrity fallbacks it took)."""
    led = getattr(executor, "last_train_ledger", None)
    wd = getattr(executor, "last_train_watchdog", None)
    return {
        "role": "trainer",
        "ledger": led.snapshot() if led is not None else None,
        "watchdog": wd.state() if wd is not None else None,
        "checkpoint": {
            "last_resume_step": getattr(executor, "last_resume_step", None),
            "last_restore_path": getattr(executor, "last_restore_path", None),
            "last_restore_fallbacks": getattr(
                executor, "last_restore_fallbacks", 0),
            "last_restore_stats": getattr(
                executor, "last_restore_stats", None),
            # this epoch's saves (step, directory name, sync or async,
            # foreground seconds): the history the JAX package's doc
            # names, read from the executor's bookkeeping
            "history": list(getattr(executor, "last_checkpoints", ()) or ()),
        },
        "trace_id": getattr(executor, "last_train_trace_id", None),
        "train_log": getattr(executor, "last_train_log", None),
    }


_admin_lock = threading.Lock()


def start_train_admin(executor, host: str = "127.0.0.1",
                      port: int = 0) -> Tuple[str, int]:
    """Serve the trainer's scrape surface on ``host:port`` (port 0 =
    ephemeral): ``/metrics`` (Prometheus text; OpenMetrics 1.0 with
    exemplars under ``Accept: application/openmetrics-text``),
    ``/trainz``, ``/statusz``, ``/tracez`` (flight recorder), ``/eventz``
    and ``/healthz`` — the same document shapes the fleet federation
    scraper reads from a serving backend, so
    ``FleetBalancer.add_scrape_target`` federates a trainer unchanged.
    Returns the bound ``(host, port)``; repeat calls reuse the running
    server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _TrainAdminHandler(BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                om = "application/openmetrics-text" in (
                    self.headers.get("Accept") or "")
                text, ctype = _registry.REGISTRY.expose(openmetrics=om)
                body = text.encode("utf-8")
            elif path == "/trainz":
                body = json.dumps(trainz_doc(executor), sort_keys=True,
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif path == "/statusz":
                doc = {"role": "trainer",
                       "trainz": trainz_doc(executor),
                       "jit_cache": executor.jit_cache_stats(),
                       "registry": _registry.REGISTRY.snapshot()}
                body = json.dumps(doc, sort_keys=True,
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif path == "/tracez":
                rec = _flight.get()
                doc = ({"recorder": False, "retained": 0, "requests": []}
                       if rec is None else dict(rec.statusz(), recorder=True))
                body = json.dumps(doc, sort_keys=True,
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif path == "/eventz":
                body = json.dumps(_events.eventz(), sort_keys=True,
                                  default=str).encode("utf-8")
                ctype = "application/json"
            elif path == "/healthz":
                body = json.dumps({"ok": True, "role": "trainer"},
                                  sort_keys=True).encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(
                    404, "unknown path (try /metrics, /trainz, /statusz, "
                         "/tracez, /eventz or /healthz)")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # keep scrapes out of stderr
            pass

    with _admin_lock:
        existing = getattr(executor, "_train_admin", None)
        if existing is not None:  # concurrent/repeat start: reuse
            return existing.server_address
        server = ThreadingHTTPServer((host, port), _TrainAdminHandler)
        executor._train_admin = server
        executor._train_admin_thread = threading.Thread(
            target=server.serve_forever, name="train-admin", daemon=True)
        executor._train_admin_thread.start()
        return server.server_address


def stop_train_admin(executor) -> None:
    with _admin_lock:
        server = getattr(executor, "_train_admin", None)
        executor._train_admin = None
        thread = getattr(executor, "_train_admin_thread", None)
        executor._train_admin_thread = None
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5.0)
