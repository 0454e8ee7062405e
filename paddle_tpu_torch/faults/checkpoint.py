"""Crash-resumable training checkpoints.

The port's copy of the single-device half of the JAX package's
``faults/checkpoint.py``; the directory format is the JAX package's,
file for file, so either package restores the other's checkpoints.

The reference recovered a dead trainer by reloading persistables and a
PS table checkpoint (checkpoint_notify) and re-reading the dataset from
the top; this manager makes the recovery *exact to a step*: one
checkpoint atomically captures

1. the program's persistables (params + optimizer accumulators + LR),
   via ``io.save_vars`` into the checkpoint directory,
2. the PS sparse tables (``PSClient.save`` row dump, restored by value
   with ``load_tables`` — not replayed through the optimizer), and
3. the dataset **cursor** (completed-step count + caller epoch), so a
   resumed ``train_from_dataset`` skips exactly the batches already
   consumed instead of restarting the epoch.

Atomicity is tmp+rename at every level: a checkpoint is staged under
``<run_dir>/.tmp-<step>``, ``os.replace``d to ``ckpt-<step>`` only when
complete, and only then does the ``LATEST`` pointer move (itself via
tmp+rename).  A SIGKILL at ANY instant leaves either the previous
checkpoint or the new one — never a half-written directory a resume
could trust.

**Async mode** (:meth:`save_async`) takes serialization off the
training critical path: the caller (already quiesced) pays only the
snapshot — every persistable copied to the host, synchronously, before
``save_async`` returns, and the PS tables dumped by value — and the
write + commit happen on a background snapshot thread.  The copy must
be complete before the call returns: a captured step writes each new
value back into the scope's own tensor in place (the executor's
``_Graph``), so a snapshot that kept references, or a non-blocking
device-to-host copy left unwaited, would save a later step's values.
The ``checkpoint.commit`` fault point injects delay/error into the
commit phase.  One save is in flight at a time: a new ``save_async``
(or :meth:`wait`) joins the previous one first.

**Restore into a live scope**: each value is written into the scope's
existing tensor in place where there is one (its dtype kept, so a bf16
persistable saved as float32, or as the JAX package's raw 2-byte
bfloat16, comes back as bf16), else set as a new tensor in the program
var's dtype.  A captured step's buffers are the scope's tensors, so the
next replay reads the restored values.

**Shard-wise mode** (``save(..., compiled=<CompiledProgram>)``): each rank
of a mesh holds its shard of every sharded persistable, and no rank ever
holds the full tensor.  Every rank calls ``save``: it writes the shards
it is the first rank to hold (one ``.npy`` per distinct shard, replicas
written once), then rank 0 writes the shard manifest (global shape,
dtype, PartitionSpec, each file's index box), the replicated state under
``params/``, the cursor and the integrity manifest, and commits; the ranks
meet at barriers of the world group around the writes.  The layout is
the JAX package's, file for file, so either package restores the other's
shard-wise checkpoint.  ``save_async`` writes the shard files on the
caller's thread and leaves rank 0's commit to the snapshot thread.

**Topology-elastic restore** (``restore(..., compiled=)``): each rank
reads its own region of each sharded var out of the saved shard files:
the file whole where its box is a saved shard's (the same mesh), else
assembled from the overlapping shards by slice-wise reads of
memory-mapped ``.npy`` files (another mesh shape, a world of another
size, one process: ``last_restore_stats`` records the largest region
buffer).  :class:`CheckpointMeshMismatchError` is kept for the genuinely
incompatible: a layout that does not resolve on the new mesh, a global
shape that drifted, saved shards that do not tile a region.  The
mesh-resident tables' entries (``kind: mesh_table*``) are ROADMAP A10
part 4 and raise.

**Integrity-verified recovery**: every committed checkpoint carries an
``integrity.json`` manifest — a content hash (sha256) and byte size
for EVERY file in the checkpoint (params, PS tables, cursor).
``restore`` verifies the newest checkpoint before trusting it; a
flipped byte, truncation, or missing file is a typed
:class:`CheckpointCorruptionError`, counted in
``train_checkpoint_corruption_total``, and restore automatically falls
back through the keep-N chain to the newest fully-verifiable
checkpoint (each skip counted in ``train_checkpoint_fallback_total`` —
never silent).  A ``LATEST`` pointer naming a pruned/missing directory
falls back the same way.  The ``checkpoint.restore`` fault point arms
the restore path; ``python -m paddle_tpu_torch.tools.check_checkpoint``
runs the same verification offline.

Layout::

    run_dir/
      LATEST              # "ckpt-000040\n"
      ckpt-000040/
        cursor.json       # {"step": 40, "epoch": 0}
        integrity.json    # {"algo": "sha256", "files": {relpath:
                          #   {"sha256": ..., "bytes": ...}}} — every
                          #   other file in the checkpoint
        params/           # io.save_vars output (__manifest__.json + .npy;
                          #   the replicated state only in shard-wise mode)
        shards/           # optional: manifest.json + v<i>_s<j>.npy —
                          #   per-shard dumps of a mesh's sharded state
        ps/               # optional: manifest.json + t<i>_{ids,rows}.npy
                          #   (+ t<i>_moments.npy: adagrad accumulators)
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Dict, List, Optional

import numpy as np

import paddle_tpu_torch.faults as _faults
from paddle_tpu_torch.faults.metrics import (
    TRAIN_CHECKPOINT_BYTES,
    TRAIN_CHECKPOINT_CORRUPTION,
    TRAIN_CHECKPOINT_FALLBACKS,
    TRAIN_CHECKPOINT_RESTORES,
    TRAIN_CHECKPOINTS,
)

__all__ = ["TrainCheckpoint", "CheckpointMeshMismatchError",
           "CheckpointCorruptionError", "verify_checkpoint_dir",
           "hash_file"]

_MESH_TABLES = ("mesh-resident table state (bind_mesh_tables) comes with ROADMAP A10 "
                "part 4, not ported to paddle_tpu_torch yet")

class CheckpointMeshMismatchError(RuntimeError):
    """A shard-wise checkpoint is GENUINELY incompatible with the
    current mesh/layout: the layout cannot resolve on this mesh (axis
    divisibility), the global shape drifted, or the saved shards no
    longer tile a target device's region.  A merely *different* mesh
    shape or device assignment is NOT this error — the shard-exchange
    restore re-slices overlapping shards onto the new topology."""


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification: a file listed in
    ``integrity.json`` is missing, truncated, or its content hash does
    not match what the commit recorded.  Restore falls back through
    the keep-N chain; this error surfaces only when NO checkpoint in
    the run directory verifies."""


def hash_file(path: str, chunk: int = 1 << 20) -> str:
    """sha256 hex digest of a file, streamed (checkpoints can exceed
    comfortable read-at-once sizes)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def verify_checkpoint_dir(path: str) -> None:
    """Verify one committed checkpoint directory against its
    ``integrity.json``: every listed file must exist with the recorded
    size and content hash, and every file on disk must be listed (an
    unlisted file means the directory was tampered with after the
    commit).  Raises :class:`CheckpointCorruptionError`; checkpoints
    from before the integrity manifest existed pass unverified (there
    is nothing to check them against)."""
    integ = os.path.join(path, _INTEGRITY)
    if not os.path.exists(integ):
        return  # pre-integrity checkpoint: restore-as-before semantics
    try:
        with open(integ) as f:
            doc = json.load(f)
        files = dict(doc["files"])
        entries = sorted((str(rel), ent["sha256"], int(ent["bytes"]))
                         for rel, ent in files.items())
    except CheckpointCorruptionError:
        raise
    except Exception as e:  # noqa: BLE001 — ANY malformed-structure
        # shape (non-dict files, entry missing a key, junk types) must
        # become the typed corruption so the keep-N fallback engages —
        # an untyped crash here would defeat the recovery chain
        raise CheckpointCorruptionError(
            "checkpoint %s: unreadable/malformed integrity manifest (%s)"
            % (path, e)) from None
    on_disk = set()
    for dirpath, _, fns in os.walk(path):
        for fn in fns:
            rel = os.path.relpath(os.path.join(dirpath, fn), path)
            if rel != _INTEGRITY:
                on_disk.add(rel.replace(os.sep, "/"))
    listed = {rel for rel, _, _ in entries}
    for rel in sorted(listed - on_disk):
        raise CheckpointCorruptionError(
            "checkpoint %s: file %r listed in the integrity manifest "
            "is missing" % (path, rel))
    for rel in sorted(on_disk - listed):
        raise CheckpointCorruptionError(
            "checkpoint %s: file %r on disk is not in the integrity "
            "manifest (written after the commit?)" % (path, rel))
    for rel, want_digest, want_bytes in entries:
        fpath = os.path.join(path, *rel.split("/"))
        size = os.path.getsize(fpath)
        if size != want_bytes:
            raise CheckpointCorruptionError(
                "checkpoint %s: file %r is %d bytes, manifest recorded "
                "%d (truncated?)" % (path, rel, size, want_bytes))
        digest = hash_file(fpath)
        if digest != want_digest:
            raise CheckpointCorruptionError(
                "checkpoint %s: file %r content hash %s does not match "
                "the recorded %s (corrupted on disk)"
                % (path, rel, digest, want_digest))


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _load_shard(fpath: str, mmap_mode=None) -> np.ndarray:
    """``np.load`` with unreadable/truncated content re-typed as
    :class:`CheckpointCorruptionError` — a damaged PRE-integrity
    checkpoint (nothing for the hash gate to check) must still engage
    restore's fallback chain, never an untyped crash."""
    try:
        return np.load(fpath, mmap_mode=mmap_mode)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptionError(
            "shard file %s is unreadable (%s)" % (fpath, e)) from None



_LATEST = "LATEST"
_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-"
_INTEGRITY = "integrity.json"


class TrainCheckpoint:
    """One run directory's checkpoint manager.

    ``every_n_steps``: cadence for :meth:`should_save` (0 disables the
    periodic trigger; explicit :meth:`save` always works).
    ``keep``: finished checkpoints retained (older ones are pruned
    after each successful commit; the latest is never pruned).
    """

    def __init__(self, run_dir: str, every_n_steps: int = 0, keep: int = 2):
        self.run_dir = str(run_dir)
        self.every_n_steps = int(every_n_steps)
        self.keep = max(1, int(keep))
        self._bg: Optional[threading.Thread] = None
        self._bg_result: Optional[str] = None
        self._bg_error: Optional[BaseException] = None
        # restore bookkeeping (read by the executor and the drills):
        # which checkpoint actually restored, how many were skipped on
        # the way there, and the shard-exchange host-buffer high-water
        self.last_restore_path: Optional[str] = None
        self.last_restore_fallbacks: int = 0
        self.last_restore_stats: Optional[Dict] = None
        os.makedirs(self.run_dir, exist_ok=True)

    # ------------------------------------------------------------------
    def should_save(self, completed_steps: int) -> bool:
        return (self.every_n_steps > 0
                and completed_steps > 0
                and completed_steps % self.every_n_steps == 0)

    def _name(self, step: int) -> str:
        return "%s%06d" % (_PREFIX, int(step))

    # ------------------------------------------------------------------
    def save(self, program, scope, step: int, epoch: int = 0,
             ps_client=None, extra: Optional[Dict] = None,
             compiled=None) -> str:
        """Commit one checkpoint; returns the finished directory path.
        ``step`` is the number of COMPLETED steps (the resume cursor).
        ``compiled``: the CompiledProgram a sharded run executes through;
        its sharded state then saves shard-wise (every rank calls ``save``
        and writes its own shards, never a gathered full tensor).  The
        caller is responsible for quiescing async state first (the
        executor flushes the Communicator before calling)."""
        self.wait()  # never interleave with an in-flight async save
        ps_state = (self._gather_ps(ps_client)
                    if ps_client is not None else None)
        shard_state = self._gather_shards(program, scope, compiled, copy=False)
        if shard_state is None:
            return self._commit(program, scope, step, epoch, ps_state, extra)
        tmp = self._stage_shards(step, shard_state)
        final = os.path.join(self.run_dir, self._name(step))
        if shard_state["rank"] == 0:
            self._commit(program, scope, step, epoch, ps_state, extra, shard_state, tmp)
        _barrier()  # every rank returns once the checkpoint is committed
        return final

    def save_async(self, program, scope, step: int, epoch: int = 0,
                   ps_client=None, extra: Optional[Dict] = None,
                   compiled=None) -> None:
        """Snapshot now, serialize in the background.

        The caller-thread cost is the snapshot: every persistable's
        value copied to the host (into a detached snapshot scope; the
        copy from the card completes before this returns) and the PS
        tables dumped by value — the PS sockets are only touched here,
        never from the writer thread.  Serialization, the hashes, the
        tmp+rename commit, and pruning all happen on a daemon snapshot
        thread; training continues immediately, and may write the live
        scope's tensors in place the instant this returns.  A previous
        in-flight save is joined first (its error, if any, re-raises
        HERE — a silent checkpoint gap must not go unnoticed); call
        :meth:`wait` at end of epoch to commit the tail save.  Shard-wise
        (``compiled``), every rank writes its shard files here, and rank
        0's snapshot thread commits."""
        self.wait()
        shard_state = self._gather_shards(program, scope, compiled, copy=True)
        tmp = self._stage_shards(step, shard_state) if shard_state is not None else None
        if shard_state is not None and shard_state["rank"] != 0:
            return  # rank 0 commits
        snap = self._snapshot_scope(program, scope,
                                    exclude=set(shard_state["vars"]) if shard_state else ())
        ps_state = (self._gather_ps(ps_client)
                    if ps_client is not None else None)
        self._bg_result = self._bg_error = None

        def _write():
            try:
                self._bg_result = self._commit(
                    program, snap, step, epoch, ps_state, extra, shard_state, tmp)
            except BaseException as e:  # noqa: BLE001 — re-raised at wait()
                self._bg_error = e

        self._bg = threading.Thread(
            target=_write, name="ckpt-writer-%06d" % int(step), daemon=True)
        self._bg.start()

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        """Join the in-flight background save, if any.  Returns its
        committed path (None when nothing was in flight) and re-raises
        its failure."""
        bg, self._bg = self._bg, None
        if bg is not None:
            bg.join(timeout)
            if bg.is_alive():  # caller keeps ownership of the join
                self._bg = bg
                raise TimeoutError("background checkpoint still writing")
        if self._bg_error is not None:
            err, self._bg_error = self._bg_error, None
            raise err
        result, self._bg_result = self._bg_result, None
        return result

    @property
    def in_flight(self) -> bool:
        return self._bg is not None and self._bg.is_alive()

    @staticmethod
    def _gather_shards(program, scope, compiled, copy: bool):
        """This rank's shards of the compiled program's sharded state, as
        host arrays: ``{"rank", "mesh_axes", "vars": {name: {"shape",
        "dtype", "spec", "boxes": [every distinct box, sorted], "own":
        [(box index, array)] for the boxes this rank writes}}}``.  None
        when ``compiled`` is None or nothing is sharded."""
        if compiled is None:
            committed = scope.__dict__.get("_mesh_committed") or {}
            if any(scope.vars.get(n) is c[1] for n, c in committed.items()):
                raise ValueError(
                    "scope holds this rank's shards of a compiled run; pass the run's "
                    "CompiledProgram (compiled=) to save them shard-wise")
            return None
        from paddle_tpu_torch import io as _io
        from paddle_tpu_torch.core import types as core_types
        from paddle_tpu_torch.scope import to_numpy
        from paddle_tpu_torch.sharding.rules import spec_to_manifest
        from paddle_tpu_torch.sharding.train import shard_boxes

        mesh = compiled.mesh
        entries: Dict[str, Dict] = {}
        for v in _io._collect(program, _io._is_persistable, None):
            val = scope.get(v.name)
            if val is None:
                continue
            sh = compiled.state_sharding(v.name)
            if sh.is_fully_replicated:
                continue  # the params/ path: one portable copy
            shape = compiled._var_shape(v.name)
            if shape is None or tuple(val.shape) != sh.shard_shape(shape):
                raise ValueError(
                    "var %r holds shape %s, not this rank's shard of %s: run the compiled "
                    "program once before saving it shard-wise" % (v.name, tuple(val.shape),
                                                                  shape))
            boxes = shard_boxes(sh, shape)
            order = sorted(boxes)
            mine = sh.local_box(shape)
            own = []
            if min(boxes[mine]) == mesh.rank:  # the first rank holding a box writes it
                arr = to_numpy(val)  # a host copy (bfloat16 as float32)
                own.append((order.index(mine), np.array(arr, copy=True) if copy else arr))
            entries[v.name] = {
                "shape": tuple(shape),
                "dtype": str(core_types.np_dtype(val.dtype)),
                "spec": spec_to_manifest(sh.spec),
                "boxes": order,
                "own": own,
            }
        if not entries:
            return None
        return {"rank": mesh.rank, "mesh_axes": dict(mesh.shape), "vars": entries}

    def _stage_shards(self, step: int, shard_state) -> str:
        """Every rank writes its shard files into the staging directory
        rank 0 made; returns it after the last rank is done."""
        tmp = os.path.join(self.run_dir, _TMP_PREFIX + self._name(step))
        final = os.path.join(self.run_dir, self._name(step))
        if shard_state["rank"] == 0:
            for stale in (tmp, final):  # a crashed previous attempt
                if os.path.isdir(stale):
                    shutil.rmtree(stale)
            os.makedirs(os.path.join(tmp, "shards"))
        _barrier()
        for i, (name, ent) in enumerate(sorted(shard_state["vars"].items())):
            for j, arr in ent["own"]:
                np.save(os.path.join(tmp, "shards", "v%03d_s%02d.npy" % (i, j)), arr)
        _barrier()
        return tmp

    @staticmethod
    def _write_shard_manifest(dirname: str, shard_state) -> None:
        """The JAX package's ``shards/manifest.json``: each var's global
        shape, dtype, spec and its files with their index boxes."""
        manifest = {"mesh_axes": shard_state["mesh_axes"], "vars": {}}
        for i, (name, ent) in enumerate(sorted(shard_state["vars"].items())):
            manifest["vars"][name] = {
                "shape": list(ent["shape"]),
                "dtype": ent["dtype"],
                "spec": ent["spec"],
                "shards": [{"file": "v%03d_s%02d.npy" % (i, j), "index": [list(se) for se in box]}
                           for j, box in enumerate(ent["boxes"])],
            }
        with open(os.path.join(dirname, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    @staticmethod
    def _snapshot_scope(program, scope, exclude=()):
        """Copy every persistable's current value into a detached host
        scope (dtype kept): the writer thread reads ONLY these copies, so
        training may mutate the live scope the instant this returns.
        ``Tensor.to("cpu")`` of a card tensor is a blocking copy: it
        waits for the work queued before it, and nothing queued after it
        can reach the copy."""
        import torch

        from paddle_tpu_torch import io as _io
        from paddle_tpu_torch.scope import Scope

        snap = Scope(device="cpu")
        for v in _io._collect(program, _io._is_persistable, None):
            if v.name in exclude:  # saved shard-wise
                continue
            val = scope.get(v.name)
            if val is None:
                continue
            if isinstance(val, torch.Tensor):
                snap.vars[v.name] = val.detach().to("cpu", copy=True)
            else:
                snap.vars[v.name] = torch.from_numpy(np.array(val, copy=True))
        return snap

    def _commit(self, program, scope, step, epoch, ps_state, extra, shard_state=None,
                staged=None) -> str:
        """The write + atomic-rename phase (caller thread for ``save``,
        snapshot thread for ``save_async``); reads only the given scope
        and the pre-gathered ``ps_state``.  ``staged``: the directory the
        ranks wrote their shard files into (``_stage_shards``)."""
        from paddle_tpu_torch import io as _io

        final = os.path.join(self.run_dir, self._name(step))
        tmp = os.path.join(self.run_dir, _TMP_PREFIX + self._name(step))
        if staged is None:
            for stale in (tmp, final):  # a crashed previous attempt
                if os.path.isdir(stale):
                    shutil.rmtree(stale)
            os.makedirs(tmp)
        shard_names = set(shard_state["vars"]) if shard_state else set()
        _io.save_vars(
            None, os.path.join(tmp, "params"), main_program=program,
            predicate=lambda v: _io._is_persistable(v) and v.name not in shard_names,
            scope=scope)
        if shard_state is not None:
            self._write_shard_manifest(os.path.join(tmp, "shards"), shard_state)
        if ps_state is not None:
            self._write_ps(os.path.join(tmp, "ps"), ps_state)
        cursor = {"step": int(step), "epoch": int(epoch)}
        if extra:
            cursor.update(extra)
        with open(os.path.join(tmp, "cursor.json"), "w") as f:
            json.dump(cursor, f)
        total_bytes = self._write_integrity(tmp)
        if _faults.active is not None:  # disarmed: one is-None gate
            # the chaos window: a kill/delay/error HERE lands between a
            # fully staged tmp dir and its commit — resume must still
            # see only the previous committed checkpoint
            _faults.active.faultpoint(
                "checkpoint.commit", run_dir=self.run_dir, step=int(step))
        os.replace(tmp, final)
        TRAIN_CHECKPOINT_BYTES.set(total_bytes)
        # move LATEST only after the checkpoint directory is committed
        ptr_tmp = os.path.join(self.run_dir, _LATEST + ".tmp")
        with open(ptr_tmp, "w") as f:
            f.write(self._name(step) + "\n")
        os.replace(ptr_tmp, os.path.join(self.run_dir, _LATEST))
        TRAIN_CHECKPOINTS.inc()
        self._prune(keep_name=self._name(step))
        return final

    @staticmethod
    def _write_integrity(tmp: str) -> int:
        """Hash every staged file into ``integrity.json`` (the LAST
        file written before the commit rename, so it covers all the
        others); returns the checkpoint's total byte size."""
        files: Dict[str, Dict] = {}
        total = 0
        for dirpath, _, fns in os.walk(tmp):
            for fn in sorted(fns):
                p = os.path.join(dirpath, fn)
                rel = os.path.relpath(p, tmp).replace(os.sep, "/")
                size = os.path.getsize(p)
                files[rel] = {"sha256": hash_file(p), "bytes": size}
                total += size
        with open(os.path.join(tmp, _INTEGRITY), "w") as f:
            json.dump({"algo": "sha256", "files": files}, f)
        return total + os.path.getsize(os.path.join(tmp, _INTEGRITY))

    @staticmethod
    def _gather_ps(ps_client):
        # include_moments: the adagrad accumulators dump alongside the
        # rows so a SIGKILL-resume is exact for sparse optimizers (a
        # moment-less restore would restart per-row step sizes at their
        # largest and re-diverge the loss trajectory)
        return ps_client.save(include_moments=True)

    @staticmethod
    def _write_ps(dirname: str, state) -> None:
        os.makedirs(dirname)
        manifest = []
        for i, (table, value) in enumerate(sorted(state.items())):
            ids, rows = value[0], value[1]
            moments = value[2] if len(value) == 3 else None
            np.save(os.path.join(dirname, "t%03d_ids.npy" % i),
                    np.asarray(ids, np.int64))
            np.save(os.path.join(dirname, "t%03d_rows.npy" % i),
                    np.asarray(rows, np.float32))
            if moments is not None:
                np.save(os.path.join(dirname, "t%03d_moments.npy" % i),
                        np.asarray(moments, np.float32))
            manifest.append({"table": table, "index": i,
                             "dim": int(rows.shape[1]) if rows.size else 0,
                             "moments": moments is not None})
        with open(os.path.join(dirname, "manifest.json"), "w") as f:
            json.dump({"tables": manifest}, f)

    @staticmethod
    def _step_of(name: str) -> int:
        try:
            return int(name[len(_PREFIX):])
        except ValueError:
            return -1

    def _prune(self, keep_name: str) -> None:
        # numeric order, not lexicographic: a step past the %06d padding
        # must never make a NEWER checkpoint sort as the oldest
        done = sorted(
            (d for d in os.listdir(self.run_dir)
             if d.startswith(_PREFIX)
             and os.path.isdir(os.path.join(self.run_dir, d))),
            key=self._step_of)
        excess = [d for d in done[:-self.keep] if d != keep_name]
        for d in excess:
            shutil.rmtree(os.path.join(self.run_dir, d), ignore_errors=True)

    # ------------------------------------------------------------------
    def latest(self) -> Optional[str]:
        """Path of the checkpoint the ``LATEST`` pointer names, or None
        when there is no pointer or its target is gone.  :meth:`restore`
        does NOT stop here — a dangling pointer falls back through the
        remaining complete checkpoints (counted)."""
        ptr = os.path.join(self.run_dir, _LATEST)
        if not os.path.exists(ptr):
            return None
        with open(ptr) as f:
            name = f.read().strip()
        path = os.path.join(self.run_dir, name)
        return path if os.path.isdir(path) else None

    def _completed(self) -> List[str]:
        """Committed checkpoint directory names, NEWEST first."""
        return sorted(
            (d for d in os.listdir(self.run_dir)
             if d.startswith(_PREFIX)
             and os.path.isdir(os.path.join(self.run_dir, d))),
            key=self._step_of, reverse=True)

    def restore(self, program, scope, ps_client=None,
                compiled=None) -> Optional[Dict]:
        """Restore the newest VERIFIABLE checkpoint into ``scope`` (and
        the PS tables through ``ps_client``, and any bound mesh-table
        runtime); returns its cursor dict, or None when the run
        directory holds no committed checkpoint (fresh start).

        Integrity first: each candidate is verified against its
        ``integrity.json`` before anything loads — a corrupt/truncated
        checkpoint (or a ``LATEST`` pointer naming a pruned directory)
        falls back to the next-newest complete one, counted in
        ``train_checkpoint_fallback_total`` /
        ``train_checkpoint_corruption_total``; only when NO candidate
        verifies does the :class:`CheckpointCorruptionError` surface.

        Each value is written into ``scope``'s tensor of that name in
        place where there is one (dtype kept), else set in the program
        var's dtype on the scope's device.  A shard-wise checkpoint needs
        ``compiled`` (the run's sharded layout); each rank then takes its
        own region of each sharded var, on any mesh the layout resolves
        on.  Genuinely incompatible specs stay a typed
        :class:`CheckpointMeshMismatchError` and do NOT fall back (they
        are configuration errors, not disk corruption)."""
        self.last_restore_path = None
        self.last_restore_fallbacks = 0
        self.last_restore_stats = None
        names = self._completed()
        ptr = os.path.join(self.run_dir, _LATEST)
        pointed = None
        if os.path.exists(ptr):
            with open(ptr) as f:
                pointed = f.read().strip()
        if not names:
            if pointed:
                # the pointer is on-disk evidence committed state
                # EXISTED; with every checkpoint directory gone this is
                # a loss, not a fresh start — never restart from step 0
                # silently
                TRAIN_CHECKPOINT_CORRUPTION.inc()
                raise CheckpointCorruptionError(
                    "run dir %s: LATEST names %r but no committed "
                    "checkpoint directory remains — the run's state "
                    "was lost (bad prune / partial disk restore?)"
                    % (self.run_dir, pointed))
            return None
        if pointed and pointed not in names:
            # dangling pointer (its target was pruned or lost): the
            # newest complete checkpoint serves instead — counted,
            # never a silent fresh start
            TRAIN_CHECKPOINT_FALLBACKS.inc()
            self.last_restore_fallbacks += 1
        last_err: Optional[CheckpointCorruptionError] = None
        for i, name in enumerate(names):
            path = os.path.join(self.run_dir, name)
            if _faults.active is not None:  # disarmed: one is-None gate
                # the restore-side chaos window (mirrors
                # checkpoint.commit on the save side): delay/error here
                # lands between picking a candidate and trusting it
                _faults.active.faultpoint(
                    "checkpoint.restore", run_dir=self.run_dir, path=path)
            try:
                verify_checkpoint_dir(path)
                cursor = self._restore_one(path, program, scope,
                                           ps_client, compiled)
            except CheckpointCorruptionError as e:
                # a pre-integrity checkpoint (nothing to verify against)
                # can still fail at LOAD time — _restore_one types its
                # unreadable-file failures so the fallback engages for
                # them too; the scope may be partially written, but the
                # next candidate's load overwrites every name it set
                TRAIN_CHECKPOINT_CORRUPTION.inc()
                last_err = e
                if i + 1 < len(names):
                    TRAIN_CHECKPOINT_FALLBACKS.inc()
                    self.last_restore_fallbacks += 1
                continue
            TRAIN_CHECKPOINT_RESTORES.inc()
            self.last_restore_path = path
            return cursor
        raise last_err  # every candidate failed verification

    def _restore_one(self, path: str, program, scope, ps_client,
                     compiled) -> Dict:
        """Load one verified checkpoint directory (params + PS tables +
        cursor).  Unreadable/truncated file content re-raises as
        :class:`CheckpointCorruptionError` (restore's fallback class);
        configuration errors (a missing ps_client, a shard-wise
        checkpoint without ``compiled``, a layout that does not resolve)
        keep their own types and do NOT fall back."""
        try:
            self._load_params(os.path.join(path, "params"), program, scope)
        except (OSError, ValueError, KeyError) as e:
            raise CheckpointCorruptionError(
                "checkpoint %s: params failed to load (%s)"
                % (path, e)) from None
        shards_dir = os.path.join(path, "shards")
        if os.path.isdir(shards_dir):
            self.last_restore_stats = self._restore_shards(shards_dir, scope, compiled,
                                                           program)
        ps_dir = os.path.isdir(os.path.join(path, "ps"))
        if ps_dir:
            if ps_client is None:
                raise ValueError(
                    "checkpoint %s carries PS tables but no ps_client was "
                    "given to restore them" % path)
            self._restore_ps(os.path.join(path, "ps"), ps_client)
            cache = getattr(program, "_embedding_cache", None)
            if cache is not None:
                # the restore rewrote the tables' rows wholesale: a row
                # cached before it is stale
                cache.invalidate()
        try:
            with open(os.path.join(path, "cursor.json")) as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                "checkpoint %s: unreadable cursor.json (%s)"
                % (path, e)) from None

    @staticmethod
    def _load_params(dirname: str, program, scope) -> None:
        """The program's persistables from ``dirname`` (an ``io.save_vars``
        directory, either package's) into ``scope``: in place into the
        scope's own tensor where it holds one of that size (its dtype
        kept: a captured step's buffer stays the scope's tensor), else a
        new tensor in the program var's dtype.  A bfloat16 array that the
        JAX package wrote as raw 2-byte values comes back as bfloat16."""
        import torch

        from paddle_tpu_torch import io as _io
        from paddle_tpu_torch.core import types as core_types

        arrays = _io._read_arrays(dirname)
        block = program.global_block()
        for v in _io._collect(program, _io._is_persistable, None):
            if v.name not in arrays:
                continue
            arr = np.asarray(arrays[v.name])
            if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                value = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
            else:
                value = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
            var = block._find_var_recursive(v.name)
            if var is not None and var.shape is not None and -1 not in tuple(var.shape):
                one_element = value.numel() == 1 and int(np.prod(var.shape)) == 1
                if tuple(value.shape) != tuple(var.shape) and not one_element:
                    raise ValueError("shape mismatch restoring %r: saved %s vs program %s"
                                     % (v.name, tuple(value.shape), tuple(var.shape)))
            cur = scope.vars.get(v.name)
            if isinstance(cur, torch.Tensor) and cur.numel() == value.numel():
                cur.copy_(value.reshape(cur.shape))
                continue
            dtype = core_types.torch_dtype(var.dtype) if var is not None else value.dtype
            scope.set(v.name, value.to(dtype))

    # ------------------------------------------------------------------
    # shard-exchange restore
    # ------------------------------------------------------------------
    def _restore_shards(self, dirname: str, scope, compiled, program) -> Dict:
        """This rank's region of each saved sharded var, into ``scope``:
        the saved file whole where the region is a saved shard, else
        assembled from the overlapping shards (slice-wise reads of
        memory-mapped files); the largest region buffer is recorded as
        ``max_region_bytes``, so the full tensor is never materialized
        on a rank whose region is smaller."""
        import torch

        try:
            with open(os.path.join(dirname, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruptionError(
                "checkpoint shards manifest %s is unreadable (%s)"
                % (os.path.join(dirname, "manifest.json"), e)) from None
        stats = {"direct": 0, "exchanged": 0, "regions": 0,
                 "shard_files_read": 0, "max_region_bytes": 0, "mesh_tables": 0}
        for name, ent in manifest["vars"].items():
            if str(ent.get("kind", "")).startswith("mesh_table"):
                raise NotImplementedError("checkpoint entry %r: %s" % (name, _MESH_TABLES))
            shape = tuple(int(d) for d in ent["shape"])
            dtype = np.dtype(ent["dtype"])
            saved = []
            for doc in ent["shards"]:
                box = tuple(tuple(int(x) for x in se) for se in doc["index"])
                saved.append((box, os.path.join(dirname, doc["file"])))
            if compiled is None:
                raise ValueError(
                    "checkpoint %s holds SHARD-wise state — pass the "
                    "run's CompiledProgram (compiled=) so shards "
                    "re-place onto its mesh" % os.path.dirname(dirname))
            try:
                sharding = compiled.state_sharding(name)
            except Exception as e:
                raise CheckpointMeshMismatchError(
                    "var %r: the current layout cannot resolve on this "
                    "mesh (%s) — the checkpoint itself is fine; fix the "
                    "layout or resume on a compatible mesh"
                    % (name, e)) from None
            var = program.global_block()._find_var_recursive(name)
            if (var is not None and var.shape is not None
                    and -1 not in tuple(var.shape)
                    and tuple(int(d) for d in var.shape) != shape):
                raise CheckpointMeshMismatchError(
                    "var %r was saved with global shape %s but the "
                    "program declares %s — the model changed since the "
                    "checkpoint" % (name, shape, tuple(var.shape)))
            self._check_disjoint(name, saved)
            box = sharding.local_box(shape)
            stats["regions"] += 1
            arr = self._assemble_region(name, box, dtype, saved, box, stats)
            value = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
            cur = scope.vars.get(name)
            if isinstance(cur, torch.Tensor) and tuple(cur.shape) == tuple(value.shape):
                cur.copy_(value)
            else:
                if isinstance(cur, torch.Tensor):
                    value = value.to(cur.dtype)
                scope.set(name, value)
        return stats

    @staticmethod
    def _check_disjoint(name, saved) -> None:
        """The coverage check sums overlap volumes, exact only over a
        disjoint shard grid; the boxes come from an untrusted manifest, so
        overlapping entries are typed before assembly."""
        from paddle_tpu_torch.sharding.train import box_overlap

        for i in range(len(saved)):
            for j in range(i + 1, len(saved)):
                if box_overlap(saved[i][0], saved[j][0]) is not None:
                    raise CheckpointMeshMismatchError(
                        "var %r: saved shard indexes %s and %s overlap "
                        "— a PartitionSpec shard grid is disjoint, so "
                        "the manifest was doctored or mis-written"
                        % (name, saved[i][0], saved[j][0]))

    @staticmethod
    def _assemble_region(name, box, dtype, saved, required, stats):
        """One target region: the exact-match fast path loads the saved
        file whole; otherwise overlapping saved shards are slice-read
        (mmap) into a region-sized buffer, which they must tile."""
        from paddle_tpu_torch.sharding.train import box_overlap, box_volume

        for sbox, fpath in saved:
            if sbox == box:
                arr = _load_shard(fpath)  # shard-sized, never the full tensor
                stats["direct"] += 1
                stats["shard_files_read"] += 1
                stats["max_region_bytes"] = max(stats["max_region_bytes"], int(arr.nbytes))
                return arr
        buf = np.zeros(tuple(hi - lo for lo, hi in box), dtype)
        covered = 0
        for sbox, fpath in saved:
            ov = box_overlap(sbox, box)
            if ov is None:
                continue
            src = _load_shard(fpath, mmap_mode="r")  # slice-wise read only
            src_sl = tuple(slice(lo - s[0], hi - s[0]) for (lo, hi), s in zip(ov, sbox))
            dst_sl = tuple(slice(lo - b[0], hi - b[0]) for (lo, hi), b in zip(ov, box))
            buf[dst_sl] = src[src_sl]
            stats["shard_files_read"] += 1
            req_ov = box_overlap(ov, required)
            if req_ov is not None:
                covered += box_volume(req_ov)
        if covered != box_volume(required):
            raise CheckpointMeshMismatchError(
                "var %r: the saved shards cover only %d of %d cells of "
                "target region %s — the checkpoint's shard set is "
                "incomplete for this layout/mesh (doctored manifest, or "
                "a partial save)" % (name, covered, box_volume(required), box))
        stats["exchanged"] += 1
        stats["max_region_bytes"] = max(stats["max_region_bytes"], int(buf.nbytes))
        return buf

    @staticmethod
    def _restore_ps(dirname: str, ps_client) -> None:
        try:
            with open(os.path.join(dirname, "manifest.json")) as f:
                manifest = json.load(f)
            tables = [(int(ent["index"]), str(ent["table"]),
                       bool(ent.get("moments"))) for ent in
                      manifest["tables"]]
        except (OSError, ValueError, KeyError, TypeError) as e:
            raise CheckpointCorruptionError(
                "checkpoint PS manifest %s is unreadable/malformed (%s)"
                % (os.path.join(dirname, "manifest.json"), e)) from None
        state = {}
        for i, table, has_moments in tables:
            ids = _load_shard(os.path.join(dirname, "t%03d_ids.npy" % i))
            rows = _load_shard(os.path.join(dirname, "t%03d_rows.npy" % i))
            mpath = os.path.join(dirname, "t%03d_moments.npy" % i)
            # pre-moments checkpoints (no flag, no file) restore as
            # before: rows only, accumulators restart
            if has_moments and os.path.exists(mpath):
                state[table] = (ids, rows, _load_shard(mpath))
            else:
                state[table] = (ids, rows)
        ps_client.load_tables(state)
