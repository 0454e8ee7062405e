"""Metrics/docs parity guard for the port: the registry and README agree.

The JAX package's ``tools/check_metrics_docs.py``, pointed at the port:
every metric that ``paddle_tpu_torch``'s modules register into
``paddle_tpu_torch.monitor.REGISTRY`` must be listed in the README port
section's "Observability" metrics table, and every row there must name a
metric that still registers.  The registered set comes from importing
the registering modules and reading the live registry.  Run::

    python -m paddle_tpu_torch.tools.check_metrics_docs   # exits 1 and prints the diff
"""
from __future__ import annotations

import importlib
import re
import sys
from typing import Set, Tuple

from paddle_tpu_torch.tools import REPO_ROOT, readme_subsection

# modules whose import registers metrics
REGISTERING_MODULES = [
    "paddle_tpu_torch.monitor",
    "paddle_tpu_torch.monitor.flight",
    "paddle_tpu_torch.monitor.events",
    "paddle_tpu_torch.monitor.slo",
    "paddle_tpu_torch.monitor.push",
    "paddle_tpu_torch.monitor.train",
    "paddle_tpu_torch.executor",
    "paddle_tpu_torch.reader",
    "paddle_tpu_torch.faults.metrics",
    "paddle_tpu_torch.serving.metrics",
    "paddle_tpu_torch.serving.decode",
    "paddle_tpu_torch.serving.prefix_cache",
    "paddle_tpu_torch.serving.speculative",
    "paddle_tpu_torch.serving.embedding_cache",
    "paddle_tpu_torch.serving.wire.metrics",
    "paddle_tpu_torch.sharding.metrics",
]

# table rows look like ``| `metric_name` | type | ... |``
_ROW_RE = re.compile(r"^\|\s*`([a-zA-Z_:][a-zA-Z0-9_:]*)`\s*\|")
_SECTION = "Observability"


def registered_metrics() -> Set[str]:
    for mod in REGISTERING_MODULES:
        importlib.import_module(mod)
    from paddle_tpu_torch.monitor import REGISTRY

    return set(REGISTRY.snapshot())


def documented_metrics(root: str) -> Set[str]:
    names = set()
    for line in readme_subsection(root, _SECTION):
        m = _ROW_RE.match(line.strip())
        if m:
            names.add(m.group(1))
    return names


def check(repo_root: str = None) -> Tuple[Set[str], Set[str]]:
    """Returns (undocumented, stale)."""
    registered = registered_metrics()
    documented = documented_metrics(repo_root or REPO_ROOT)
    return registered - documented, documented - registered


def main() -> int:
    undocumented, stale = check()
    if not undocumented and not stale:
        print("check_metrics_docs: OK (%d metrics documented)" % len(registered_metrics()))
        return 0
    for name in sorted(undocumented):
        print("undocumented metric %r: add a row to the README port section's "
              "Observability table" % name, file=sys.stderr)
    for name in sorted(stale):
        print("stale README row %r: no such metric is registered" % name, file=sys.stderr)
    print("check_metrics_docs: %d problem(s)" % (len(undocumented) + len(stale)),
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
