"""Offline checkpoint verifier for the port: is this run directory restorable?

The JAX package's ``tools/check_checkpoint.py`` for the checkpoints the
port writes (the directory format is shared).  It walks a
training-checkpoint run directory (``TrainCheckpoint`` layout) and
verifies each committed checkpoint WITHOUT loading any state onto a
device:

1. **Manifest completeness** — ``cursor.json`` parses with an integer
   step; ``params/__manifest__.json`` exists and every variable it
   lists has its file on disk; ``shards/manifest.json`` and
   ``ps/manifest.json`` (when present) likewise, the latter with
   matching id and row counts.
2. **Shard-index coverage** — for every shard-wise variable, the saved
   shard boxes must lie inside the recorded global shape, each file's
   array header must match its box extents and dtype, and the boxes
   must exactly tile the variable's full shape: what the shard-exchange
   restore needs to place the state on any compatible mesh of ranks.
   The mesh-resident tables' entries (``kind: mesh_table*``) are ROADMAP
   A10 part 4 and are reported as not restorable by the port.
3. **Content hashes** — ``integrity.json`` must exist, list every
   other file (and nothing extra), and every size + sha256 must match
   (``paddle_tpu_torch.faults.checkpoint.verify_checkpoint_dir``, the
   same verification ``restore()`` runs before trusting a checkpoint).

Run-level: a ``LATEST`` pointer naming a missing directory is flagged.
Run::

    python -m paddle_tpu_torch.tools.check_checkpoint RUN_DIR [--checkpoint ckpt-000040]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

import numpy as np


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


def _shape_of_npy(path: str):
    """(shape, dtype str) from a .npy header without reading the data."""
    try:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, dtype = np.lib.format._read_array_header(f, version)
    except (OSError, ValueError) as e:
        return None, str(e)
    return tuple(int(d) for d in shape), str(dtype)


def _check_shards(sdir: str, ck_name: str, problems: List[str]) -> None:
    from paddle_tpu_torch.sharding.train import boxes_cover

    mpath = os.path.join(sdir, "manifest.json")
    if not os.path.exists(mpath):
        problems.append("%s: shards/ has no manifest.json" % ck_name)
        return
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except ValueError as e:
        problems.append("%s: shards/manifest.json unreadable (%s)" % (ck_name, e))
        return
    for name, ent in sorted(manifest.get("vars", {}).items()):
        if str(ent.get("kind", "")).startswith("mesh_table"):
            problems.append(
                "%s: var %r is mesh-resident table state (%s), which comes with "
                "ROADMAP A10 part 4; the port cannot restore it" % (ck_name, name, ent["kind"]))
            continue
        shape = tuple(int(d) for d in ent["shape"])
        required = tuple((0, d) for d in shape)
        boxes = []
        for doc in ent.get("shards", ()):
            box = tuple(tuple(int(x) for x in se) for se in doc["index"])
            fpath = os.path.join(sdir, doc["file"])
            if not os.path.exists(fpath):
                problems.append("%s: var %r shard file %r is missing"
                                % (ck_name, name, doc["file"]))
                continue
            if len(box) != len(shape) or any(
                    lo < 0 or hi > d for (lo, hi), d in zip(box, shape)):
                problems.append("%s: var %r shard index %s lies outside global shape %s"
                                % (ck_name, name, box, shape))
                continue
            fshape, fdtype = _shape_of_npy(fpath)
            want = tuple(hi - lo for lo, hi in box)
            if fshape is None:
                problems.append("%s: var %r shard file %r has an unreadable array header (%s)"
                                % (ck_name, name, doc["file"], fdtype))
                continue
            if fshape != want:
                problems.append("%s: var %r shard file %r has shape %s but its index %s "
                                "implies %s" % (ck_name, name, doc["file"], fshape, box, want))
            if fdtype != str(ent["dtype"]):
                problems.append("%s: var %r shard file %r dtype %s != manifest %s"
                                % (ck_name, name, doc["file"], fdtype, ent["dtype"]))
            boxes.append(box)
        if not boxes_cover(boxes, required):
            problems.append(
                "%s: var %r: saved shard indexes do not exactly tile its required region "
                "%s — a restore (on ANY mesh) cannot assemble this variable"
                % (ck_name, name, required))


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
    for sub, checker in (("params", _check_params),
                         ("shards", _check_shards),
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
