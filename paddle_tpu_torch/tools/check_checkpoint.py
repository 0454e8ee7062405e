"""Offline checkpoint verifier for the port: is this run directory restorable?

The JAX package's ``tools/check_checkpoint.py`` for the single-device
checkpoints the port writes (the directory format is shared).  It walks
a training-checkpoint run directory (``TrainCheckpoint`` layout) and
verifies each committed checkpoint WITHOUT loading any state onto a
device:

1. **Manifest completeness** — ``cursor.json`` parses with an integer
   step; ``params/__manifest__.json`` exists and every variable it
   lists has its file on disk; ``ps/manifest.json`` (when present)
   likewise, with matching id and row counts.
2. **Content hashes** — ``integrity.json`` must exist, list every
   other file (and nothing extra), and every size + sha256 must match
   (``paddle_tpu_torch.faults.checkpoint.verify_checkpoint_dir``, the
   same verification ``restore()`` runs before trusting a checkpoint).

A shard-wise checkpoint (``shards/``, ROADMAP A10) is reported as not
restorable by the port.  Run-level: a ``LATEST`` pointer naming a
missing directory is flagged.  Run::

    python -m paddle_tpu_torch.tools.check_checkpoint RUN_DIR [--checkpoint ckpt-000040]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _layout():
    """The layout's protocol strings, from the one definition."""
    from paddle_tpu_torch.faults.checkpoint import _LATEST, _PREFIX

    return _PREFIX, _LATEST


def _shape_of_npy(path: str):
    """(shape, dtype-str) from a .npy header — no data read; (None,
    reason) when the header itself is unreadable."""
    import numpy as np

    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, dtype = np.lib.format._read_array_header(f, version)
    except (OSError, ValueError) as e:
        return None, str(e)
    return tuple(int(d) for d in shape), str(dtype)


def _check_params(pdir: str, ck_name: str, problems: List[str]) -> None:
    mpath = os.path.join(pdir, "__manifest__.json")
    if not os.path.exists(mpath):
        problems.append("%s: params/ has no __manifest__.json" % ck_name)
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        problems.append("%s: params/__manifest__.json unreadable (%s)"
                        % (ck_name, e))
        return
    packed = manifest.get("packed_file")
    if packed:
        target = packed + ("" if packed.endswith(".npz") else ".npz")
        if not os.path.exists(os.path.join(pdir, target)):
            problems.append("%s: packed params file %r is missing"
                            % (ck_name, target))
        return
    for ent in manifest.get("vars", ()):
        fname = ent["name"].replace("/", "%2F") + ".npy"
        if not os.path.exists(os.path.join(pdir, fname)):
            problems.append("%s: params var %r has no file %r"
                            % (ck_name, ent["name"], fname))


def _check_ps(psdir: str, ck_name: str, problems: List[str]) -> None:
    mpath = os.path.join(psdir, "manifest.json")
    if not os.path.exists(mpath):
        problems.append("%s: ps/ has no manifest.json" % ck_name)
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        problems.append("%s: ps/manifest.json unreadable (%s)"
                        % (ck_name, e))
        return
    for ent in manifest.get("tables", ()):
        i = int(ent["index"])
        shapes = {}
        for part in ("ids", "rows") + (
                ("moments",) if ent.get("moments") else ()):
            fpath = os.path.join(psdir, "t%03d_%s.npy" % (i, part))
            if not os.path.exists(fpath):
                problems.append(
                    "%s: PS table %r is missing its %s file"
                    % (ck_name, ent["table"], part))
            else:
                shape, why = _shape_of_npy(fpath)
                if shape is None:
                    problems.append(
                        "%s: PS table %r %s file has an unreadable "
                        "array header (%s)"
                        % (ck_name, ent["table"], part, why))
                else:
                    shapes[part] = shape
        n = shapes.get("ids", (None,))[0]
        for part in ("rows", "moments"):
            if n is not None and part in shapes and shapes[part][0] != n:
                problems.append(
                    "%s: PS table %r %s count %d != ids count %d"
                    % (ck_name, ent["table"], part, shapes[part][0], n))


def check_checkpoint(path: str) -> List[str]:
    """Problems for ONE committed checkpoint directory."""
    from paddle_tpu_torch.faults.checkpoint import (
        CheckpointCorruptionError,
        verify_checkpoint_dir,
    )

    name = os.path.basename(path.rstrip(os.sep))
    problems: List[str] = []
    cursor = os.path.join(path, "cursor.json")
    try:
        with open(cursor) as f:
            int(json.load(f)["step"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        problems.append("%s: unreadable cursor.json (%s)" % (name, e))
    if not os.path.exists(os.path.join(path, "integrity.json")):
        problems.append(
            "%s: no integrity.json — content hashes unverifiable "
            "(pre-integrity checkpoint?)" % name)
    else:
        try:
            verify_checkpoint_dir(path)
        except CheckpointCorruptionError as e:
            problems.append(str(e))
    # belt and braces: a manifest malformed in a way a specific guard
    # above didn't anticipate must become a PROBLEM, not a crash that
    # swallows every finding already collected
    if os.path.isdir(os.path.join(path, "shards")):
        problems.append("%s: shard-wise state (shards/) is ROADMAP A10; the port "
                        "cannot restore it" % name)
    for sub, checker in (("params", _check_params),
                         ("ps", _check_ps)):
        subdir = os.path.join(path, sub)
        if sub != "params" and not os.path.isdir(subdir):
            continue
        try:
            checker(subdir, name, problems)
        except Exception as e:  # noqa: BLE001 — report, keep walking
            problems.append(
                "%s: %s/ metadata is malformed (%s: %s)"
                % (name, sub, type(e).__name__, e))
    return problems


def check(run_dir: str, checkpoint: Optional[str] = None) -> List[str]:
    """Problems for a whole run directory (or one named checkpoint)."""
    problems: List[str] = []
    if not os.path.isdir(run_dir):
        return ["run dir %r does not exist" % run_dir]
    if checkpoint is not None:
        return check_checkpoint(os.path.join(run_dir, checkpoint))
    prefix, latest_name = _layout()
    names = sorted(d for d in os.listdir(run_dir)
                   if d.startswith(prefix)
                   and os.path.isdir(os.path.join(run_dir, d)))
    if not names:
        problems.append("run dir %r holds no committed checkpoints"
                        % run_dir)
    ptr = os.path.join(run_dir, latest_name)
    if os.path.exists(ptr):
        with open(ptr) as f:
            pointed = f.read().strip()
        if pointed and pointed not in names:
            problems.append(
                "LATEST points at %r which does not exist (restore "
                "falls back, but the pointer is stale)" % pointed)
    for d in names:
        problems.extend(check_checkpoint(os.path.join(run_dir, d)))
    return problems


def main() -> int:
    ap = argparse.ArgumentParser(
        description="verify a TrainCheckpoint run directory offline")
    ap.add_argument("run_dir")
    ap.add_argument("--checkpoint", default=None,
                    help="verify only this checkpoint name (ckpt-NNNNNN)")
    args = ap.parse_args()
    problems = check(args.run_dir, checkpoint=args.checkpoint)
    if not problems:
        print("check_checkpoint: OK (%s)" % args.run_dir)
        return 0
    for p in problems:
        print("check_checkpoint: %s" % p, file=sys.stderr)
    print("check_checkpoint: %d problem(s)" % len(problems),
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
