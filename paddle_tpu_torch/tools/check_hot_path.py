"""Static hot-path guard for the port: no blocking host-device syncs in
annotated regions.

The JAX package's ``tools/check_hot_path.py``, pointed at the port.  A
captured step's dispatch must queue the replay without waiting for the
card: a ``.item()``, ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize``
or ``np.asarray`` of a tensor inside an annotated region would serialise
the host with the card.  Regions are marked in the source::

    # hot-path: begin <label>
    ...code...
    # hot-path: end <label>

A line that legitimately needs a flagged token (``np.asarray`` of a HOST
value) carries an inline waiver comment: ``# hot-ok: <reason>``.  Run::

    python -m paddle_tpu_torch.tools.check_hot_path   # exits 1 and prints violations
"""
from __future__ import annotations

import os
import re
import sys
from typing import List, Tuple

from paddle_tpu_torch.tools import REPO_ROOT

# files owning annotated hot regions (repo-root relative)
CHECKED_FILES = [
    # the dispatch: plan hit -> feed coercion -> entry hit -> replay
    "paddle_tpu_torch/executor.py",
    # the prefetch consumer's pop: the batch must already be staged
    "paddle_tpu_torch/reader.py",
    # the armed ledger's per-step charges
    "paddle_tpu_torch/monitor/train.py",
    # int8 KV quantize-on-write inside the captured step and verify fns
    "paddle_tpu_torch/quant.py",
    # the slot pool's dispatches: entry lookup + input copies + replay
    "paddle_tpu_torch/serving/kv_pool.py",
    # the decode scheduler's tick: fault gate + chunk dispatch
    "paddle_tpu_torch/serving/decode.py",
    # the request-batching server's merge, pad and dispatch (the wait for
    # the outputs is one batch behind, outside the region)
    "paddle_tpu_torch/serving/server.py",
    # admission's heap push and pop under the queue's lock
    "paddle_tpu_torch/serving/admission.py",
    # the predictor's dispatch: the precision variant is one dict lookup
    "paddle_tpu_torch/inference.py",
    # the wire layer: encode/decode, the client POST, the traced call and
    # the fleet's acquire -> exchange -> release (socket waits only)
    "paddle_tpu_torch/serving/wire/codec.py",
    "paddle_tpu_torch/serving/wire/http.py",
    "paddle_tpu_torch/serving/wire/client.py",
    "paddle_tpu_torch/serving/wire/fleet.py",
    # the hot-id cache's probe under its lock (the PS pull is outside)
    "paddle_tpu_torch/serving/embedding_cache.py",
    # a sequence-parallel step's per-output constrain: spec lookup and a slice
    "paddle_tpu_torch/sharding/activations.py",
]

# blocking-sync tokens (substring match on code, not comments)
BANNED_TOKENS = [
    ".item()",
    ".cpu()",
    ".tolist()",
    "torch.cuda.synchronize",
    "np.asarray",
    "np.array(",
    "time.sleep",
    # observability background work and event emission stay off the
    # request and step paths
    "_events.emit",
    "events.emit",
    "evaluate_once",
    ".eventz(",
]

_BEGIN = re.compile(r"#\s*hot-path:\s*begin\b\s*(?P<label>[\w./-]*)")
_END = re.compile(r"#\s*hot-path:\s*end\b")
_WAIVER = "# hot-ok:"


def check_source(text: str, path: str = "<string>") -> List[Tuple[str, int, str, str]]:
    """Return [(path, lineno, token, line)] violations in ``text``."""
    violations = []
    label = None
    opened_at = 0
    for i, line in enumerate(text.splitlines(), start=1):
        m = _BEGIN.search(line)
        if m:
            if label is not None:
                violations.append(
                    (path, i, "<nesting>",
                     "hot-path region %r opened inside %r (line %d)"
                     % (m.group("label"), label, opened_at)))
            label = m.group("label") or "<anonymous>"
            opened_at = i
            continue
        if _END.search(line):
            if label is None:
                violations.append(
                    (path, i, "<orphan-end>", line.strip()))
            label = None
            continue
        if label is None:
            continue
        code = line.split("#", 1)[0]
        if _WAIVER in line:
            continue
        for token in BANNED_TOKENS:
            if token in code:
                violations.append((path, i, token, line.strip()))
    if label is not None:
        violations.append(
            (path, opened_at, "<unclosed>",
             "hot-path region %r never closed" % label))
    return violations


def check_files(repo_root: str = None) -> List[Tuple[str, int, str, str]]:
    root = repo_root or REPO_ROOT
    out = []
    for rel in CHECKED_FILES:
        with open(os.path.join(root, rel)) as f:
            out.extend(check_source(f.read(), rel))
    return out


def main() -> int:
    violations = check_files()
    if not violations:
        n = 0
        for rel in CHECKED_FILES:
            with open(os.path.join(REPO_ROOT, rel)) as f:
                n += sum(1 for ln in f if _BEGIN.search(ln))
        print("check_hot_path: OK (%d regions across %d files clean)"
              % (n, len(CHECKED_FILES)))
        return 0
    for path, lineno, token, line in violations:
        print("%s:%d: blocking call %r in hot-path region: %s"
              % (path, lineno, token, line), file=sys.stderr)
    print("check_hot_path: %d violation(s)" % len(violations), file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
