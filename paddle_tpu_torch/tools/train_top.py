#!/usr/bin/env python
"""train_top — live terminal console for a training run.

Polls a trainer admin (``Executor.start_train_admin`` — ``/trainz`` +
``/eventz``) and renders the operator's one screen for a running epoch:
per-phase wall-clock occupancy bars (where did the second go —
data_wait / h2d / device_execute / ps_wait / checkpoint /
restore_fallback / other), throughput (steps/s, examples/s) and the
static-FLOPs MFU estimate, the anomaly watchdog's state and recent
detections, the last-N step table, and the training event tail
(``train/anomaly``, ``train/resume``, ``train/progress``).

Pure stdlib (urllib + ANSI), so it runs anywhere the trainer does::

    python -m paddle_tpu_torch.tools.train_top 127.0.0.1:8899            # live, 2s refresh
    python -m paddle_tpu_torch.tools.train_top 127.0.0.1:8899 --once     # one frame, exit 0
    python -m paddle_tpu_torch.tools.train_top --replay run/steps.jsonl  # offline step log

``--once`` renders a single frame without touching the terminal modes
(no clear, no cursor control) — scriptable, and the CI smoke test.
``--replay`` rebuilds the frame from a ``train_log=`` JSONL step log
instead of a live admin (implies ``--once``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request

_CLEAR = "\x1b[2J\x1b[H"
_SEV_COLOR = {"info": "\x1b[37m", "warning": "\x1b[33m",
              "error": "\x1b[31m", "critical": "\x1b[41;97m"}
_RESET = "\x1b[0m"

PHASES = ("data_wait", "h2d", "device_execute", "ps_wait", "checkpoint",
          "restore_fallback", "other")


def fetch_json(base: str, path: str, timeout_s: float = 5.0):
    """GET a JSON admin document from ``base`` (``host:port``)."""
    with urllib.request.urlopen(
            "http://%s%s" % (base, path), timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _f(v, fmt="%.1f", dash="-"):
    if v is None:
        return dash
    try:
        return fmt % float(v)
    except (TypeError, ValueError):
        return dash


def _bar(frac: float, width: int = 32) -> str:
    try:
        frac = max(0.0, min(1.0, float(frac)))
    except (TypeError, ValueError):
        frac = 0.0
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def render_frame(trainz: dict, eventz: dict, events_tail: int = 8,
                 color: bool = True) -> str:
    """One full console frame as a string (no terminal control)."""
    def paint(sev, text):
        if not color:
            return text
        return _SEV_COLOR.get(sev, "") + text + _RESET

    lines = []
    ledger = trainz.get("ledger") or {}
    watchdog = trainz.get("watchdog") or {}
    ckpt = trainz.get("checkpoint") or {}
    halted = watchdog.get("halted")
    lines.append("trainer   %s   steps %s   wall %ss   %s" % (
        time.strftime("%Y-%m-%d %H:%M:%S"),
        ledger.get("n_steps", "-"), _f(ledger.get("wall_s"), "%.1f"),
        paint("critical", "HALTED:%s" % halted.get("kind"))
        if halted else "healthy"))
    lines.append("")

    # phase occupancy bars
    phases = ledger.get("phases") or {}
    fractions = ledger.get("fractions") or {}
    lines.append("%-18s %-32s %9s %6s"
                 % ("PHASE", "", "seconds", "pct"))
    for p in PHASES:
        frac = fractions.get(p, 0.0)
        lines.append("%-18s %-32s %9s %5s%%" % (
            p, _bar(frac), _f(phases.get(p), "%.3f"),
            _f(frac * 100.0 if frac is not None else None, "%.1f")))
    if not phases:
        lines.append("  (no ledger yet — train with phase_ledger=True)")
    lines.append("")

    # throughput / MFU
    lines.append(
        "throughput  %s steps/s   %s examples/s   mfu %s   "
        "ckpt sync %ss / commit %ss" % (
            _f(ledger.get("steps_per_second"), "%.2f"),
            _f(ledger.get("examples_per_second"), "%.1f"),
            _f(ledger.get("mfu_ratio"), "%.4f"),
            _f((ledger.get("checkpoint") or {}).get("sync_s"), "%.3f"),
            _f((ledger.get("checkpoint") or {}).get("commit_s"), "%.3f")))
    resume = ckpt.get("last_resume_step")
    if resume is not None:
        lines.append("resume      step %s from %s (%s fallback(s))" % (
            resume, ckpt.get("last_restore_path"),
            ckpt.get("last_restore_fallbacks", 0)))
    lines.append("")

    # watchdog state + recent anomalies
    anomalies = watchdog.get("anomalies") or []
    lines.append("WATCHDOG  observed %s steps   z>%s   anomalies %d" % (
        watchdog.get("steps_observed", "-"),
        _f(watchdog.get("z_threshold"), "%.1f"), len(anomalies)))
    for a in anomalies[-4:]:
        lines.append("  %s step %-6s %s value=%s" % (
            paint(a.get("severity", "warning"),
                  "%-8s" % a.get("severity", "?")),
            a.get("step", "?"), a.get("kind", "?"), a.get("value", "?")))
    if not watchdog:
        lines.append("  (no watchdog — train with watchdog=True)")
    lines.append("")

    # last-N step table (most recent few)
    steps = (ledger.get("steps") or [])[-5:]
    lines.append("%-8s %10s %9s %10s  %s"
                 % ("STEP", "dur_ms", "loss", "examples", "top phase"))
    for s in steps:
        ph = s.get("phases") or {}
        top = max(ph, key=ph.get) if ph else "-"
        lines.append("%-8s %10s %9s %10s  %s" % (
            s.get("step", "?"), _f(s.get("duration_s", 0.0) * 1e3
                                   if s.get("duration_s") is not None
                                   else None, "%.2f"),
            _f(s.get("loss"), "%.4f"), s.get("examples", "-"), top))
    if not steps:
        lines.append("  (no steps yet)")
    lines.append("")

    events = (eventz.get("events") or [])[-events_tail:]
    lines.append("EVENTS (last %d of %d)"
                 % (len(events), len(eventz.get("events") or [])))
    for e in events:
        ts = time.strftime("%H:%M:%S", time.localtime(e.get("ts", 0)))
        sev = e.get("severity", "info")
        attrs = " ".join(
            "%s=%s" % (k, v) for k, v in sorted(e.items())
            if k not in ("ts", "kind", "severity", "seq", "message"))
        lines.append("  %s %s %-24s %s" % (
            ts, paint(sev, "%-8s" % sev), e.get("kind", "?"), attrs))
    if not events:
        lines.append("  (none)")
    return "\n".join(lines)


def poll_once(base: str, timeout_s: float = 5.0):
    """(trainz, eventz) from a trainer admin address; a surface that
    fails to fetch degrades to an empty doc, never a crash."""
    docs = []
    for path in ("/trainz", "/eventz"):
        try:
            docs.append(fetch_json(base, path, timeout_s=timeout_s))
        except Exception:
            docs.append({})
    return tuple(docs)


def replay_frame(path: str, events_tail: int = 8,
                 color: bool = True) -> str:
    """Render one frame from a ``train_log=`` JSONL step log (offline
    replay of a run that's gone — same summary monitor.train builds)."""
    import os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from paddle_tpu_torch.monitor.train import replay_step_log

    doc = replay_step_log(path)
    total = sum(doc["phases"].values()) or 1.0
    trainz = {
        "ledger": {
            "phases": doc["phases"],
            "fractions": {p: v / total for p, v in doc["phases"].items()},
            "wall_s": doc["wall_s"],
            "n_steps": doc["n_steps"],
            "steps_per_second": doc["steps_per_second"],
            "examples_per_second": doc["examples_per_second"],
            "steps": doc["steps"],
        },
        "watchdog": {"anomalies": doc["anomalies"],
                     "steps_observed": doc["n_steps"]} if doc["anomalies"]
        else {},
        "checkpoint": {},
    }
    return render_frame(trainz, {"events": doc.get("events") or []},
                        events_tail=events_tail, color=color)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live console over a trainer admin's /trainz + "
                    "/eventz (or an offline step-log replay)")
    ap.add_argument("address", nargs="?",
                    help="trainer admin host:port (start_train_admin)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds (live mode)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit 0")
    ap.add_argument("--events", type=int, default=8,
                    help="event-tail length")
    ap.add_argument("--replay", metavar="STEP_LOG",
                    help="render from a train_log= JSONL file instead "
                         "of a live admin (implies --once)")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)

    color = not args.no_color and sys.stdout.isatty()
    if args.replay:
        try:
            print(replay_frame(args.replay, events_tail=args.events,
                               color=color))
        except (OSError, ValueError) as e:
            print("train_top: cannot replay %s: %s" % (args.replay, e),
                  file=sys.stderr)
            return 1
        return 0
    if not args.address:
        ap.error("an admin address is required (or use --replay)")
    if args.once:
        trainz, eventz = poll_once(args.address)
        if not trainz:
            print("train_top: no /trainz from %s" % args.address,
                  file=sys.stderr)
            return 1
        print(render_frame(trainz, eventz, events_tail=args.events,
                           color=color))
        return 0
    try:
        while True:
            trainz, eventz = poll_once(args.address)
            frame = render_frame(trainz, eventz, events_tail=args.events,
                                 color=color)
            sys.stdout.write(_CLEAR + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
