#!/usr/bin/env python
"""fleet_top — live terminal console for a serving fleet (the port's
copy of the JAX package's ``tools/fleet_top.py``).

Polls a FleetBalancer's federated admin endpoints (``/statusz``,
``/sloz``, ``/eventz`` — see ``FleetBalancer.start_admin``) and renders
the operator's one screen for a running fleet: per-backend QPS,
p50/p99 latency, mean TTFT, batch occupancy, brownout level,
in-flight counts and the precision/storage dtype mix (default
precision dtype plus the int8 KV-cache / mesh-table-row rungs), the
SLO objectives' multi-window burn rates with firing alerts, and the
fleet-merged operational event tail.

Pure stdlib (urllib + ANSI), so it runs anywhere the fleet does::

    python -m paddle_tpu_torch.tools.fleet_top 127.0.0.1:8899            # live, 2s refresh
    python -m paddle_tpu_torch.tools.fleet_top 127.0.0.1:8899 --once     # one frame, exit 0

``--once`` renders a single frame without touching the terminal modes
(no clear, no cursor control) — scriptable, and the CI smoke test.
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


def _hist_mean_ms(registry: dict, name: str) -> object:
    """Mean of a histogram family (ms) from a child registry snapshot,
    summed across its series; None when absent/empty."""
    fam = (registry or {}).get(name)
    if not isinstance(fam, dict):
        return None
    count = total = 0.0
    for s in fam.get("series", ()):
        v = s.get("value")
        if isinstance(v, dict):
            count += float(v.get("count", 0))
            total += float(v.get("sum", 0.0))
    return (total / count) * 1e3 if count else None


def _dtype_tag(metrics: dict, registry: dict) -> str:
    """One compact storage/compute-dtype tag per backend from its
    scraped statusz: default precision dtype, then the non-fp32 storage
    rungs (decode KV cache, mesh-table rows) as ``kv:``/``row:`` parts
    — e.g. ``bf16+kv:int8``; plain fp32 everywhere renders ``fp32``."""
    parts = []
    dts = metrics.get("precision_dtypes")
    if isinstance(dts, (list, tuple)) and dts:
        parts.append(str(dts[0]))
    kv = (metrics.get("decode") or {}).get("kv_dtype")
    if kv and kv != "fp32":
        parts.append("kv:%s" % kv)
    fam = (registry or {}).get("sharding_sparse_row_dtype")
    if isinstance(fam, dict):
        row_dts = sorted({
            str((s.get("labels") or {}).get("dtype"))
            for s in fam.get("series", ())
            if (s.get("labels") or {}).get("dtype")})
        parts.extend("row:%s" % d for d in row_dts if d != "fp32")
    return "+".join(parts) if parts else ("fp32" if metrics else "-")


def _backend_rows(statusz: dict):
    """Join the balancer's routing view with each child's scraped
    statusz into per-backend display rows."""
    routing = (statusz.get("balancer") or {}).get("backends") or {}
    scraped = statusz.get("backends") or {}
    rows = []
    for name in sorted(set(routing) | set(scraped)):
        r = routing.get(name) or {}
        child = (scraped.get(name) or {}).get("statusz") or {}
        m = child.get("metrics") or {}
        reg = child.get("registry") or {}
        rows.append({
            "name": name,
            "alive": r.get("alive"),
            "in_flight": r.get("in_flight"),
            "qps": m.get("qps"),
            "p50_ms": m.get("latency_p50_ms"),
            "p99_ms": m.get("latency_p99_ms"),
            "ttft_ms": _hist_mean_ms(reg, "serving_decode_ttft_seconds"),
            "occupancy": m.get("mean_batch_occupancy"),
            "brownout": r.get("brownout_level"),
            "dtype": _dtype_tag(m, reg),
            "age_s": (scraped.get(name) or {}).get("age_s"),
        })
    return rows


def render_frame(statusz: dict, sloz: dict, eventz: dict,
                 events_tail: int = 8, color: bool = True) -> str:
    """One full console frame as a string (no terminal control)."""
    def paint(sev, text):
        if not color:
            return text
        return _SEV_COLOR.get(sev, "") + text + _RESET

    lines = []
    fleet = statusz.get("fleet", "?")
    rows = _backend_rows(statusz)
    alive = sum(1 for r in rows if r["alive"])
    lines.append("fleet %s   %s   backends %d/%d alive   slo %s"
                 % (fleet, time.strftime("%Y-%m-%d %H:%M:%S"),
                    alive, len(rows),
                    "ok" if sloz.get("ok", True) else
                    paint("critical", "BURNING")))
    lines.append("")

    lines.append("%-28s %-5s %5s %7s %8s %8s %8s %5s %5s %-13s"
                 % ("BACKEND", "alive", "infl", "qps", "p50_ms",
                    "p99_ms", "ttft_ms", "occ", "brn", "dtype"))
    for r in rows:
        lines.append("%-28s %-5s %5s %7s %8s %8s %8s %5s %5s %-13s" % (
            r["name"][:28],
            {True: "yes", False: "NO"}.get(r["alive"], "?"),
            r["in_flight"] if r["in_flight"] is not None else "-",
            _f(r["qps"]), _f(r["p50_ms"], "%.2f"),
            _f(r["p99_ms"], "%.2f"), _f(r["ttft_ms"], "%.2f"),
            _f(r["occupancy"], "%.2f"),
            r["brownout"] if r["brownout"] is not None else "-",
            r["dtype"][:13]))
    if not rows:
        lines.append("  (no backends scraped yet)")
    lines.append("")

    objectives = sloz.get("objectives") or []
    if sloz.get("installed", True) and objectives:
        lines.append("%-20s %7s %7s %7s %7s %7s  %s"
                     % ("SLO", "target", "5m", "1h", "6h", "3d",
                        "alerts"))
        for obj in objectives:
            w = obj.get("windows") or {}
            firing = [a for a in obj.get("alerts", ())
                      if a.get("firing")]
            tag = " ".join(
                paint(a.get("severity", "warning"),
                      "%s!" % a.get("pair")) for a in firing) or "-"
            lines.append("%-20s %6.2f%% %7s %7s %7s %7s  %s" % (
                str(obj.get("name", "?"))[:20],
                float(obj.get("target", 0.0)) * 100.0,
                _f((w.get("5m") or {}).get("burn"), "%.2f"),
                _f((w.get("1h") or {}).get("burn"), "%.2f"),
                _f((w.get("6h") or {}).get("burn"), "%.2f"),
                _f((w.get("3d") or {}).get("burn"), "%.2f"),
                tag))
    else:
        lines.append("SLO: no engine installed")
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
    """(statusz, sloz, eventz) from a balancer admin address; a surface
    that fails to fetch degrades to an empty doc, never a crash."""
    docs = []
    for path in ("/statusz", "/sloz", "/eventz"):
        try:
            docs.append(fetch_json(base, path, timeout_s=timeout_s))
        except Exception:
            docs.append({})
    return tuple(docs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live console over a fleet balancer's federated "
                    "observability endpoints")
    ap.add_argument("address", help="balancer admin host:port")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh seconds (live mode)")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit 0")
    ap.add_argument("--events", type=int, default=8,
                    help="event-tail length")
    ap.add_argument("--no-color", action="store_true")
    args = ap.parse_args(argv)

    color = not args.no_color and sys.stdout.isatty()
    if args.once:
        statusz, sloz, eventz = poll_once(args.address)
        if not statusz:
            print("fleet_top: no /statusz from %s" % args.address,
                  file=sys.stderr)
            return 1
        print(render_frame(statusz, sloz, eventz,
                           events_tail=args.events, color=color))
        return 0
    try:
        while True:
            statusz, sloz, eventz = poll_once(args.address)
            frame = render_frame(statusz, sloz, eventz,
                                 events_tail=args.events, color=color)
            sys.stdout.write(_CLEAR + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
