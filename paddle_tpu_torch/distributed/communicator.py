"""Async parameter-server communication (reference:
operators/distributed/communicator.h:160 — background send threads with
per-var queues and merge-before-send) and geo-SGD (reference:
DistributeTranspilerConfig geo mode, distribute_transpiler.py:131 —
periodic parameter-delta sync instead of per-step grad push).

The port's own copy of the JAX package's ``distributed/communicator.py``.
The step stays synchronous on the device; what goes async is the HOST
side — sparse grad pushes drain through a background thread so the next
step's compute overlaps the PS round trip, at the cost of bounded
staleness (the reference's async mode trade, listen_and_serv
RunAsyncLoop).  The send thread only ever holds host arrays: ``push``
takes a host copy of a tensor on the caller's thread, so a queued batch
never changes under the thread (a captured step's fetch is a buffer that
its next replay overwrites).  GeoSGD reads the scope's tensors with
``to_numpy`` and writes the pulled parameters back as tensors on the
scope's device.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch.distributed.ps import PSClient
from paddle_tpu_torch.faults.retry import RetryPolicy
from paddle_tpu_torch.scope import host_copy, to_numpy

__all__ = ["Communicator", "GeoSGD"]


class Communicator:
    """Background sparse-grad pusher with per-table merge queues.

    ``push`` enqueues and returns immediately; the send thread drains a
    table's queue, merges duplicate ids (grad sum — the reference's
    merge-before-send), and issues one PS push.  ``max_merge`` bounds
    staleness: at most that many batches are merged into one send.

    The send thread owns a DEDICATED ``PSClient`` (opened at thread
    start, closed in its ``finally`` on every exit path — a stopped or
    crashed communicator must not leak sockets) so its pushes never
    interleave frames with ``flush()``'s on the caller's client.
    """

    def __init__(self, client: PSClient, max_merge: int = 20, capacity: int = 200,
                 max_retries: int = 3):
        self._client = client
        self._queues: Dict[str, queue.Queue] = {}
        self._max_merge = max_merge
        self._capacity = capacity
        # bounded transient-failure retry (reference: grpc_client.cc send
        # deadline + retry) — shared RetryPolicy semantics: exponential
        # backoff with full jitter, one budget per merged send
        self._retry_policy = RetryPolicy(
            max_attempts=max(1, int(max_retries)),
            base_delay_s=0.2, multiplier=2.0, max_delay_s=2.0)
        self._dropped = 0  # batches lost to a full queue after retries
        self._lock = threading.Lock()
        # serializes PS pushes between the send thread and flush(), each
        # on its own client
        self._send_lock = threading.Lock()
        # flush()'s barrier: batches pushed and not yet on the server (or
        # dropped), counted from push() to the end of their send, so a
        # batch the send thread has popped but not sent still counts
        self._unsent = 0
        self._settled = threading.Condition()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._send_client: Optional[PSClient] = None  # the thread's own
        self._error: Optional[BaseException] = None

    # -- lifecycle (reference: Communicator::Start/Stop) --
    def start(self):
        self._running = True
        self._thread = threading.Thread(target=self._send_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self.flush()

    def push(self, table: str, ids: np.ndarray, grads: np.ndarray):
        if self._error is not None:
            # surface but DON'T clear: a concurrent flush() must also see
            # it; only flush() (the barrier) acknowledges and resets
            raise self._error
        with self._lock:
            q = self._queues.setdefault(table, queue.Queue(self._capacity))
        item = (host_copy(ids).reshape(-1), host_copy(grads))
        self._add_unsent(1)
        try:
            q.put(item, timeout=60)
        except queue.Full:
            self._add_unsent(-1)
            raise RuntimeError(
                "Communicator queue for %r full for 60s — PS unreachable?" % table
            )

    def flush(self):
        """Drain everything synchronously (barrier before eval/save):
        empty each queue here, then wait until the send thread has sent
        whatever it had popped, so on return all enqueued grads are on
        the server.  A send error ends the wait and is raised."""
        for table in list(self._queues):
            while self._drain(table, block=False):
                pass
        with self._settled:
            self._settled.wait_for(lambda: self._unsent <= 0 or self._error is not None)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def pending(self) -> int:
        return sum(q.qsize() for q in self._queues.values())

    @property
    def dropped(self) -> int:
        """Batches lost because the re-enqueue after a failed send found
        the queue full — nonzero means grads were lost."""
        return self._dropped

    # -- internals --
    def _add_unsent(self, n: int) -> None:
        with self._settled:
            self._unsent += n
            self._settled.notify_all()

    def _fail(self, e: BaseException) -> None:
        with self._settled:
            self._error = e
            self._settled.notify_all()

    def _drain(self, table: str, block: bool, client: Optional[PSClient] = None) -> bool:
        # the send thread waits for work in the queue's own blocking get,
        # outside the send lock: a wait under the lock, taken again at
        # once, starves a flush() (46 s behind an idle send thread in the
        # JAX package's copy).  A popped batch stays in the unsent count
        # until its send ends, which is what flush() waits on.
        q = self._queues[table]
        client = client if client is not None else self._client
        try:
            first = q.get(timeout=0.05) if block else q.get_nowait()
        except queue.Empty:
            return False
        with self._send_lock:
            batch: List = [first]
            while len(batch) < self._max_merge:
                try:
                    batch.append(q.get_nowait())
                except queue.Empty:
                    break
            ids = np.concatenate([b[0] for b in batch])
            grads = np.concatenate([b[1].reshape(len(b[0]), -1) for b in batch])
            # PSClient.push_sparse dedups+sums — the merge.  Transient PS
            # errors get a RetryPolicy budget (exponential backoff + full
            # jitter); if the send still fails the merged batch
            # re-enqueues so no grads are lost, and only when the queue
            # itself is full do we count a drop.
            budget = self._retry_policy.budget(op="communicator.push")
            try:
                budget.call(
                    lambda: client.push_sparse(table, ids, grads))
            except Exception:  # noqa: BLE001 — network layer
                try:
                    q.put_nowait((ids, grads))
                    self._add_unsent(1 - len(batch))
                except queue.Full:
                    self._dropped += len(batch)
                    self._add_unsent(-len(batch))
                raise
            self._add_unsent(-len(batch))
            return True

    def _send_loop(self):
        # the thread's own client: concurrent flush() pushes ride the
        # caller's client, this one closes in the finally on EVERY exit
        # path (stop, crash) — no socket leak per abandoned communicator.
        # A duck-typed client (tests, in-memory stubs) has no endpoints
        # to redial: share it and own nothing.
        if isinstance(self._client, PSClient):
            client = self._send_client = PSClient(list(self._client.endpoints))
            own = True
        else:
            client = self._send_client = self._client
            own = False
        try:
            while self._running:
                any_sent = False
                for table in list(self._queues):
                    try:
                        any_sent |= self._drain(table, block=True,
                                                client=client)
                    except Exception as e:
                        # surface on next push/flush but KEEP the thread
                        # alive — a transient PS error must not turn into a
                        # silent dead queue (the batch re-enqueued in _drain)
                        self._fail(e)
                        time.sleep(0.5)
                if not any_sent and not self._queues:
                    time.sleep(0.01)
        finally:
            if own:
                client.close()


class GeoSGD:
    """Geo-SGD periodic delta sync for dense params (reference: geo mode
    of DistributeTranspiler — trainers run local SGD and every
    ``sync_every`` steps push (param - snapshot)/num_trainers to the PS
    and pull the merged global params back).

    Each param maps to one PS table (rows = flattened param chunks);
    the server applies the delta with lr=1 sgd, so pushes from all
    trainers accumulate.
    """

    def __init__(self, program, scope, client_or_endpoints, num_trainers: int = 1,
                 trainer_id: int = 0, sync_every: int = 10, table_prefix: str = "geo"):
        self._program = program
        self._scope = scope
        self._client = (
            client_or_endpoints
            if isinstance(client_or_endpoints, PSClient)
            else PSClient(list(client_or_endpoints))
        )
        self._n = max(1, int(num_trainers))
        self._trainer_id = int(trainer_id)
        self._every = max(1, int(sync_every))
        self._prefix = table_prefix
        self._params = [p.name for p in program.all_parameters()]
        self._shapes = {}
        self._snap: Dict[str, np.ndarray] = {}
        self._step = 0

    def _table(self, name: str) -> str:
        return "%s/%s" % (self._prefix, name)

    _SEED_FLAG = "__seeded__"

    def init_worker(self, timeout: float = 60.0):
        """Create tables; trainer 0 seeds the server with its initial
        params and raises a 'seeded' flag table, other trainers WAIT for
        the flag then pull — deterministic rank-0 init broadcast like the
        reference's pserver startup, no barrier-count guessing."""
        for n in self._params:
            val = to_numpy(self._scope.get(n)).astype(np.float32)
            self._shapes[n] = val.shape
            flat = val.reshape(val.shape[0], -1) if val.ndim > 1 else val.reshape(1, -1)
            self._client.create_table(
                self._table(n), flat.shape[1], initializer="zeros",
                optimizer="sgd", lr=1.0,
            )
            self._snap[n] = val.copy()
        flag = self._table(self._SEED_FLAG)
        self._client.create_table(flag, 1, initializer="zeros", optimizer="sgd", lr=1.0)
        if self._trainer_id == 0:
            for n in self._params:
                val = self._snap[n]
                flat = val.reshape(val.shape[0], -1) if val.ndim > 1 else val.reshape(1, -1)
                ids = np.arange(flat.shape[0], dtype=np.int64)
                self._client.push_sparse(self._table(n), ids, -flat)  # row -= 1*(-v)
            self._client.push_sparse(flag, np.zeros(1, np.int64), -np.ones((1, 1), np.float32))
        else:
            deadline = time.time() + timeout
            while True:
                rows = self._client.pull_sparse(flag, np.zeros(1, np.int64))
                if rows is not None and float(rows[0, 0]) > 0:
                    break
                if time.time() > deadline:
                    raise RuntimeError("geo-SGD: trainer 0 never seeded the server")
                time.sleep(0.05)
            self.pull_all()
            for n in self._params:
                self._snap[n] = to_numpy(self._scope.get(n)).astype(np.float32)
        return self

    def pull_all(self):
        """Install the server's params in the scope, as tensors on the
        scope's device in each param's own dtype."""
        for n in self._params:
            shape = self._shapes[n]
            rows = shape[0] if len(shape) > 1 else 1
            ids = np.arange(rows, dtype=np.int64)
            flat = self._client.pull_sparse(self._table(n), ids)
            cur = self._scope.get(n)
            self._scope.set(n, torch.from_numpy(flat.reshape(shape)).to(cur.dtype))

    def step(self):
        """Call after each local train step; every sync_every steps the
        delta goes up and the merged params come down."""
        self._step += 1
        if self._step % self._every:
            return False
        for n in self._params:
            cur = to_numpy(self._scope.get(n)).astype(np.float32)
            delta = (cur - self._snap[n]) / self._n
            flat = delta.reshape(delta.shape[0], -1) if delta.ndim > 1 else delta.reshape(1, -1)
            ids = np.arange(flat.shape[0], dtype=np.int64)
            self._client.push_sparse(self._table(n), ids, -flat)  # row += delta
        self.pull_all()
        for n in self._params:
            self._snap[n] = to_numpy(self._scope.get(n)).astype(np.float32)
        return True
