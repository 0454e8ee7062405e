"""Parameter server for sparse tables (host-side, over TCP).

The port's own copy of the JAX package's ``distributed/ps.py``
(reference: the PS stack in paddle/fluid/operators/distributed/ — gRPC
SendRecvService (send_recv.proto.in:19-33 SendVariable/GetVariable/
PrefetchVariable), request_handler_impl.cc (server-side optimize),
parameter_prefetch.cc (row-wise sparse lookup), listen_and_serv_op.cc).

Role: huge sparse embedding tables whose rows live on host-CPU servers
sharded by id; trainers prefetch a batch's rows before the step and push
the rows' sparse gradients after it (BASELINE.md DeepFM config).

Wire format, byte for byte the JAX package's: length-framed messages of
a JSON header plus raw ndarray payload bytes — the gRPC+protobuf tensor
serde analog (reference: sendrecvop_utils.cc / variable_response.cc).  No
pickle: nothing on the wire can execute code, dtypes are whitelisted, and
message size is bounded, so an exposed port is a data-plane risk only
(like the reference's unauthenticated gRPC PS).  numpy has no bfloat16:
a ``bfloat16`` payload decodes to float32 (its bits shifted into the high
half of each float32, exact), and a ``torch.bfloat16`` tensor encodes as
a ``bfloat16`` payload of its own bits.  ``pull_sparse`` and
``pull_dense`` carry the JAX package's ``ps.pull`` fault point,
``push_sparse`` and ``push_dense`` its ``ps.push``.
"""
from __future__ import annotations

import json
import socket
import socketserver
import struct
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch.faults.retry import RetryPolicy

__all__ = ["ParameterServer", "PSClient", "shard_ids"]

# bound per-message allocation (framing is attacker-controlled input)
_MAX_MSG = int(1 << 31)
_ALLOWED_DTYPES = {
    "float32", "float64", "float16", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64", "bool",
}


def _encode_msg(obj) -> bytes:
    """dict/list/scalars + ndarrays -> JSON header || payload bytes."""
    payloads: List[bytes] = []

    def conv(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            if t.dtype != torch.bfloat16:
                return conv(t.numpy())
            payloads.append(t.view(torch.int16).numpy().tobytes())
            return {"__nd__": len(payloads) - 1, "dtype": "bfloat16",
                    "shape": list(t.shape)}
        if isinstance(x, np.ndarray):
            x = np.ascontiguousarray(x)
            if x.dtype.name not in _ALLOWED_DTYPES:
                raise TypeError("dtype %s not wire-safe" % x.dtype)
            payloads.append(x.tobytes())
            return {"__nd__": len(payloads) - 1, "dtype": x.dtype.name,
                    "shape": list(x.shape)}
        if isinstance(x, np.integer):
            return int(x)
        if isinstance(x, np.floating):
            return float(x)
        if isinstance(x, dict):
            return {str(k): conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        raise TypeError("%r not wire-safe" % type(x))

    header = json.dumps({"m": conv(obj), "p": [len(b) for b in payloads]}).encode()
    return struct.pack("<I", len(header)) + header + b"".join(payloads)


def _decode_msg(data: bytes):
    """Every malformation raises ValueError — the one exception type the
    server/client treat as 'corrupt frame from the peer'."""
    try:
        (hlen,) = struct.unpack_from("<I", data, 0)
        if hlen > len(data) - 4:
            raise ValueError("corrupt message header")
        meta = json.loads(data[4 : 4 + hlen].decode())
        sizes = meta["p"]
        if not isinstance(sizes, list):
            raise ValueError("corrupt payload index")
        views = []
        mv = memoryview(data)  # zero-copy payload slicing
        off = 4 + hlen
        for n in sizes:
            if not isinstance(n, int) or n < 0 or off + n > len(data):
                raise ValueError("corrupt message payload")
            views.append(mv[off : off + n])
            off += n

        def conv(x):
            if isinstance(x, dict):
                if "__nd__" in x:
                    dtype = str(x["dtype"])
                    if dtype not in _ALLOWED_DTYPES:
                        raise ValueError("dtype %s not wire-safe" % dtype)
                    idx = int(x["__nd__"])
                    if not 0 <= idx < len(views):
                        raise ValueError("corrupt payload reference")
                    shape = [int(d) for d in x["shape"]]
                    if dtype == "bfloat16":
                        bits = np.frombuffer(views[idx], "<u2").astype(np.uint32) << 16
                        return bits.view(np.float32).reshape(shape)
                    return np.frombuffer(views[idx], np.dtype(dtype)).reshape(shape)
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, list):
                return [conv(v) for v in x]
            return x

        return conv(meta["m"])
    except ValueError:
        raise
    except Exception as e:  # struct.error, KeyError, json/unicode errors...
        raise ValueError("corrupt message: %s" % e) from e


def _send_msg(sock: socket.socket, obj) -> None:
    data = _encode_msg(obj)
    sock.sendall(struct.pack("<Q", len(data)) + data)


def _recv_msg(sock: socket.socket):
    hdr = b""
    while len(hdr) < 8:
        chunk = sock.recv(8 - len(hdr))
        if not chunk:
            raise ConnectionError("peer closed")
        hdr += chunk
    (n,) = struct.unpack("<Q", hdr)
    if n > _MAX_MSG:
        raise ValueError("message of %d bytes exceeds limit" % n)
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return _decode_msg(bytes(buf))


def shard_ids(ids: np.ndarray, n_shards: int) -> List[np.ndarray]:
    """Round-robin id sharding (reference: split_ids_op.cc / ps_dispatcher
    RoundRobin)."""
    return [np.where(ids % n_shards == s)[0] for s in range(n_shards)]


class _Table:
    """One sparse table shard: id -> row, with lazy-initialized rows and
    a simple optimizer (sgd | adagrad) applied server-side on push —
    the reference's per-grad optimize sub-blocks (listen_and_serv)."""

    def __init__(self, dim: int, initializer: str = "uniform", seed: int = 0,
                 optimizer: str = "sgd", lr: float = 0.1):
        self.dim = dim
        self.rows: Dict[int, np.ndarray] = {}
        self.moments: Dict[int, np.ndarray] = {}
        self.initializer = initializer
        self.optimizer = optimizer
        self.lr = lr
        self._rng = np.random.RandomState(seed)
        self._lock = threading.Lock()

    def _init_row(self) -> np.ndarray:
        if self.initializer == "zeros":
            return np.zeros(self.dim, np.float32)
        return self._rng.uniform(-0.05, 0.05, self.dim).astype(np.float32)

    def pull(self, ids: Sequence[int]) -> np.ndarray:
        with self._lock:
            out = np.empty((len(ids), self.dim), np.float32)
            for i, idx in enumerate(ids):
                row = self.rows.get(int(idx))
                if row is None:
                    row = self.rows[int(idx)] = self._init_row()
                out[i] = row
            return out

    def push(self, ids: Sequence[int], grads: np.ndarray) -> None:
        with self._lock:
            for idx, g in zip(ids, grads):
                idx = int(idx)
                row = self.rows.get(idx)
                if row is None:
                    row = self.rows[idx] = self._init_row()
                if self.optimizer == "adagrad":
                    m = self.moments.get(idx)
                    if m is None:
                        m = self.moments[idx] = np.zeros(self.dim, np.float32)
                    m += g * g
                    row -= self.lr * g / (np.sqrt(m) + 1e-6)
                else:
                    row -= self.lr * g


class _DenseParam:
    """One dense parameter served by the legacy PS path (reference:
    listen_and_serv_op.cc:109 RunSyncLoop — the server owns the master
    copy AND the optimizer state, trainers send grads and recv params).

    Sync mode: pushes for round ``version`` accumulate until all
    ``n_trainers`` arrive, then the mean grad feeds the server-side
    optimizer exactly once and ``version`` bumps; ``pull(min_version)``
    blocks on that bump — the reference's per-step recv barrier.
    Async mode (Hogwild): every push applies immediately.
    """

    _OPTS = ("sgd", "momentum", "adagrad", "adam")

    def __init__(self, shape, optimizer: str = "sgd", attrs: Optional[dict] = None,
                 n_trainers: int = 1, sync: bool = True):
        if optimizer not in self._OPTS:
            raise ValueError(
                "dense PS optimizer %r not in %s" % (optimizer, self._OPTS))
        self.shape = tuple(int(s) for s in shape)
        self.value: Optional[np.ndarray] = None  # set by seed (trainer 0)
        self.optimizer = optimizer
        self.attrs = dict(attrs or {})
        self.n_trainers = max(1, int(n_trainers))
        self.sync = bool(sync)
        self.version = 0
        self._acc: Optional[np.ndarray] = None
        self._acc_count = 0
        self._state: Dict[str, np.ndarray] = {}
        self._cv = threading.Condition()

    def seed(self, value: np.ndarray) -> bool:
        """First writer wins (trainer 0 broadcast init); returns whether
        this call seeded."""
        with self._cv:
            if self.value is not None:
                return False
            v = np.asarray(value, np.float32).reshape(self.shape)
            self.value = v.copy()
            self._cv.notify_all()
            return True

    def _optimize(self, grad: np.ndarray, lr: float) -> None:
        # numpy mirror of ops/optimizer_ops.py kernels — the server is
        # host-side by design, so the update must not touch the chip
        p, s = self.value, self._state
        if self.optimizer == "sgd":
            p -= lr * grad
        elif self.optimizer == "momentum":
            mu = float(self.attrs.get("mu", 0.9))
            v = s.setdefault("velocity", np.zeros_like(p))
            v *= mu
            v += grad
            if self.attrs.get("use_nesterov", False):
                p -= (grad + mu * v) * lr
            else:
                p -= lr * v
        elif self.optimizer == "adagrad":
            eps = float(self.attrs.get("epsilon", 1e-6))
            m = s.setdefault("moment", np.zeros_like(p))
            m += grad * grad
            p -= lr * grad / (np.sqrt(m) + eps)
        elif self.optimizer == "adam":
            b1 = float(self.attrs.get("beta1", 0.9))
            b2 = float(self.attrs.get("beta2", 0.999))
            eps = float(self.attrs.get("epsilon", 1e-8))
            m = s.setdefault("m", np.zeros_like(p))
            v = s.setdefault("v", np.zeros_like(p))
            t = s.setdefault("t", np.zeros(()))
            t += 1
            m *= b1
            m += (1 - b1) * grad
            v *= b2
            v += (1 - b2) * grad * grad
            lr_t = lr * np.sqrt(1 - b2 ** float(t)) / (1 - b1 ** float(t))
            p -= lr_t * m / (np.sqrt(v) + eps)

    def push(self, grad: np.ndarray, lr: float, timeout: float = 60.0) -> int:
        grad = np.asarray(grad, np.float32).reshape(self.shape)
        with self._cv:
            if self.value is None:
                raise ValueError("dense param not seeded yet")
            if not self.sync:
                self._optimize(grad, lr)
                self.version += 1
                self._cv.notify_all()
                return self.version
            my_round = self.version
            if self._acc is None:
                self._acc = grad.copy()
            else:
                self._acc += grad
            self._acc_count += 1
            if self._acc_count == self.n_trainers:
                self._optimize(self._acc / self.n_trainers, lr)
                self._acc = None
                self._acc_count = 0
                self.version += 1
                self._cv.notify_all()
            return my_round + 1

    def pull(self, min_version: int = 0, timeout: float = 60.0) -> np.ndarray:
        import time as _time

        deadline = _time.monotonic() + timeout
        with self._cv:
            while self.value is None or self.version < min_version:
                remaining = deadline - _time.monotonic()
                if remaining <= 0 or not self._cv.wait(timeout=remaining):
                    raise ValueError(
                        "pull_dense timed out waiting for version %d (at %d)"
                        % (min_version, self.version))
            return self.value.copy()


class ParameterServer:
    """Sparse-table server (reference: listen_and_serv_op.cc:109 sync loop
    + request_handler_impl.cc handlers)."""

    def __init__(self, endpoint: str = "127.0.0.1:0"):
        host, port = endpoint.rsplit(":", 1)
        self._tables: Dict[str, _Table] = {}
        self._dense: Dict[str, _DenseParam] = {}
        self._tables_lock = threading.Lock()
        self._barrier_count = 0
        self._barrier_lock = threading.Lock()
        # rendezvous state for the host allreduce collective
        self._coll: Dict[str, dict] = {}
        self._coll_cv = threading.Condition()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        msg = _recv_msg(self.request)
                    except ValueError:
                        # corrupt/over-limit frame: drop the connection
                        # (protocol error from the peer, not a server bug)
                        return
                    except (ConnectionError, OSError):
                        return
                    # application errors go back to the caller as an error
                    # response (the gRPC status analog), not a dropped socket
                    try:
                        resp = outer._dispatch(msg)
                    except Exception as e:
                        resp = {"_error": "%s: %s" % (type(e).__name__, e)}
                    try:
                        _send_msg(self.request, resp)
                    except (ConnectionError, OSError):
                        return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, int(port)), Handler)
        self.endpoint = "%s:%d" % self._server.server_address
        self._thread: Optional[threading.Thread] = None

    # --- server ops ---
    def create_table(self, name: str, dim: int, **kwargs):
        # idempotent AND race-free: concurrent trainers joining must not
        # wipe rows another already trained/seeded (reference: pserver
        # tables are created once by the transpiled startup program)
        with self._tables_lock:
            existing = self._tables.get(name)
            if existing is not None:
                if existing.dim != dim:
                    raise ValueError(
                        "table %r exists with dim %d != %d" % (name, existing.dim, dim)
                    )
                return
            self._tables[name] = _Table(dim, **kwargs)

    def _dispatch(self, msg):
        op = msg["op"]
        if op == "pull":
            return {"rows": self._tables[msg["table"]].pull(msg["ids"])}
        if op == "push":
            self._tables[msg["table"]].push(msg["ids"], msg["grads"])
            return {"ok": True}
        if op == "create_table":
            self.create_table(msg["table"], msg["dim"], **msg.get("kwargs", {}))
            return {"ok": True}
        if op == "tables":
            # table directory for chunked checkpointing ("moments": rows
            # with live optimizer state — adagrad accumulators — so a
            # checkpoint knows whether a moment dump is needed at all)
            return {
                "tables": {
                    n: {"dim": t.dim, "size": len(t.rows),
                        "moments": len(t.moments)}
                    for n, t in self._tables.items()
                }
            }
        if op == "assign":
            # checkpoint RESTORE: set rows by VALUE, bypassing the
            # optimizer (push applies -lr*grad; a restored row must land
            # exactly as saved).  An optional "moments" payload restores
            # the adagrad accumulators the same way, so a resumed sparse
            # optimizer continues with the exact per-row step sizes it
            # died with instead of restarting from zero
            t = self._tables[msg["table"]]
            rows = np.asarray(msg["rows"], np.float32)
            moments = msg.get("moments")
            if moments is not None:
                moments = np.asarray(moments, np.float32)
            with t._lock:
                for k, idx in enumerate(np.asarray(msg["ids"]).reshape(-1)):
                    t.rows[int(idx)] = np.array(rows[k], np.float32)
                    if moments is not None:
                        t.moments[int(idx)] = np.array(
                            moments[k], np.float32)
            return {"ok": True}
        if op == "pull_moments":
            # checkpoint SAVE: optimizer accumulators for the given ids,
            # zeros where absent (zero IS adagrad's initial state, so
            # the dump stays exact and id-aligned with the row pull)
            t = self._tables[msg["table"]]
            ids = np.asarray(msg["ids"]).reshape(-1)
            with t._lock:
                out = np.zeros((len(ids), t.dim), np.float32)
                for i, idx in enumerate(ids):
                    m = t.moments.get(int(idx))
                    if m is not None:
                        out[i] = m
            return {"rows": out}
        if op == "keys":
            # paged, sorted key listing so huge shards fit the wire cap
            t = self._tables[msg["table"]]
            start = int(msg.get("start", 0))
            limit = msg.get("limit")
            with t._lock:
                ids = np.fromiter(t.rows.keys(), np.int64, len(t.rows))
            ids.sort()
            page = ids[start : start + int(limit)] if limit is not None else ids[start:]
            return {"ids": page, "total": int(len(ids))}
        if op == "create_dense":
            with self._tables_lock:
                existing = self._dense.get(msg["name"])
                if existing is not None:
                    if existing.shape != tuple(msg["shape"]):
                        raise ValueError(
                            "dense param %r exists with shape %s != %s"
                            % (msg["name"], existing.shape, msg["shape"]))
                else:
                    self._dense[msg["name"]] = _DenseParam(
                        msg["shape"], optimizer=msg.get("optimizer", "sgd"),
                        attrs=msg.get("attrs"), n_trainers=msg.get("n_trainers", 1),
                        sync=msg.get("sync", True))
            return {"ok": True}
        if op == "seed_dense":
            return {"seeded": self._dense[msg["name"]].seed(msg["value"])}
        if op == "push_dense":
            v = self._dense[msg["name"]].push(msg["grad"], float(msg.get("lr", 0.1)))
            return {"version": v}
        if op == "pull_dense":
            d = self._dense[msg["name"]]
            val = d.pull(int(msg.get("min_version", 0)),
                         timeout=float(msg.get("timeout", 60.0)))
            return {"value": val, "version": d.version}
        if op == "allreduce":
            # blocking sum-allreduce rendezvous: nranks callers post
            # tensors under one key; all get the sum (the TCP collective
            # the reference's dygraph NCCLParallelContext bootstraps —
            # here the host ring IS the transport, a Gloo analog)
            key = str(msg["key"])
            nranks = int(msg["nranks"])
            arr = np.asarray(msg["value"], np.float32)
            import time as _time

            deadline = _time.monotonic() + 60.0
            with self._coll_cv:
                ent = self._coll.get(key)
                if ent is None:
                    ent = self._coll[key] = {"sum": arr.copy(), "count": 1, "left": nranks}
                else:
                    ent["sum"] = ent["sum"] + arr
                    ent["count"] += 1
                self._coll_cv.notify_all()
                while ent["count"] < nranks:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0 or not self._coll_cv.wait(timeout=remaining):
                        # drop OUR partial entry so a retry starts clean —
                        # but never a fresh entry later arrivals recreated
                        if self._coll.get(key) is ent:
                            del self._coll[key]
                        raise ValueError("allreduce %r timed out" % key)
                out = ent["sum"]
                ent["left"] -= 1
                if ent["left"] == 0:
                    self._coll.pop(key, None)
            return {"sum": out}
        if op == "barrier":  # counted barrier (rpc_server.cc analog)
            with self._barrier_lock:
                self._barrier_count += 1
                return {"count": self._barrier_count}
        if op == "stats":
            return {n: len(t.rows) for n, t in self._tables.items()}
        raise ValueError("unknown PS op %r" % op)

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class PSClient:
    """Trainer-side client (reference: distributed/grpc_client.cc +
    parameter_prefetch.cc).  Ids shard across servers round-robin."""

    def __init__(self, endpoints: Sequence[str]):
        self.endpoints = list(endpoints)
        self._socks: List[Optional[socket.socket]] = [None] * len(self.endpoints)

    # connect retry: peers start concurrently and the server process may
    # still be booting (real rendezvous semantics; a refused connection
    # fails instantly otherwise) — deadline-bounded, jittered backoff
    CONNECT_TIMEOUT_S = 60.0

    def _sock(self, i) -> socket.socket:
        if self._socks[i] is None:
            import time

            host, port = self.endpoints[i].rsplit(":", 1)
            budget = RetryPolicy(
                max_attempts=None, base_delay_s=0.2, multiplier=1.5,
                max_delay_s=2.0,
            ).budget(deadline=time.monotonic() + self.CONNECT_TIMEOUT_S,
                     op="ps.connect")
            self._socks[i] = budget.call(
                lambda: socket.create_connection((host, int(port)),
                                                 timeout=30),
                retryable=(ConnectionRefusedError,))
        return self._socks[i]

    def _call(self, i, msg):
        s = self._sock(i)
        _send_msg(s, msg)
        resp = _recv_msg(s)
        if isinstance(resp, dict) and "_error" in resp:
            raise RuntimeError(
                "PS %s: %s" % (self.endpoints[i], resp["_error"])
            )
        return resp

    def create_table(self, name: str, dim: int, **kwargs):
        for i in range(len(self.endpoints)):
            self._call(i, {"op": "create_table", "table": name, "dim": dim, "kwargs": kwargs})

    def pull_sparse(self, table: str, ids: np.ndarray) -> np.ndarray:
        """Row lookup for a flat id array -> [len(ids), dim]."""
        if _faults.active is not None:  # disarmed: one is-None gate
            _faults.active.faultpoint("ps.pull", table=table)
        ids = np.asarray(ids).reshape(-1)
        n = len(self.endpoints)
        parts = shard_ids(ids, n)
        out = None
        for i, pos in enumerate(parts):
            if len(pos) == 0:
                continue
            rows = self._call(i, {"op": "pull", "table": table, "ids": ids[pos]})["rows"]
            if out is None:
                out = np.empty((len(ids), rows.shape[1]), np.float32)
            out[pos] = rows
        return out

    def push_sparse(self, table: str, ids: np.ndarray, grads: np.ndarray) -> None:
        if _faults.active is not None:  # disarmed: one is-None gate
            _faults.active.faultpoint("ps.push", table=table)
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads).reshape(len(ids), -1)
        # de-duplicate ids, summing grads (reference merge_ids_op)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), grads.shape[1]), np.float32)
        np.add.at(merged, inv, grads)
        parts = shard_ids(uniq, len(self.endpoints))
        for i, pos in enumerate(parts):
            if len(pos) == 0:
                continue
            self._call(i, {"op": "push", "table": table, "ids": uniq[pos], "grads": merged[pos]})

    def barrier(self):
        for i in range(len(self.endpoints)):
            self._call(i, {"op": "barrier"})

    # ---- dense legacy PS (reference: send_op/recv_op around the step) ----
    def shard_for(self, name: str) -> int:
        """Dense params dispatch whole to one server by name hash (the
        reference slices big vars into blocks; whole-param placement keeps
        the optimizer update atomic per param)."""
        import zlib

        return zlib.crc32(name.encode()) % len(self.endpoints)

    def create_dense(self, name: str, shape, optimizer: str = "sgd",
                     attrs: Optional[dict] = None, n_trainers: int = 1,
                     sync: bool = True):
        self._call(self.shard_for(name), {
            "op": "create_dense", "name": name, "shape": list(shape),
            "optimizer": optimizer, "attrs": attrs or {},
            "n_trainers": n_trainers, "sync": sync,
        })

    def seed_dense(self, name: str, value: np.ndarray) -> bool:
        r = self._call(self.shard_for(name),
                       {"op": "seed_dense", "name": name,
                        "value": np.asarray(value, np.float32)})
        return bool(r["seeded"])

    def push_dense(self, name: str, grad: np.ndarray, lr: float) -> int:
        if _faults.active is not None:  # disarmed: one is-None gate
            _faults.active.faultpoint("ps.push", param=name)
        r = self._call(self.shard_for(name),
                       {"op": "push_dense", "name": name,
                        "grad": np.asarray(grad, np.float32), "lr": float(lr)})
        return int(r["version"])

    def pull_dense(self, name: str, min_version: int = 0, timeout: float = 60.0):
        if _faults.active is not None:  # disarmed: one is-None gate
            _faults.active.faultpoint("ps.pull", param=name)
        r = self._call(self.shard_for(name),
                       {"op": "pull_dense", "name": name,
                        "min_version": int(min_version), "timeout": timeout})
        return np.asarray(r["value"], np.float32)

    # stay well under _MAX_MSG per frame (header + payload slack)
    _SAVE_BYTES_PER_CHUNK = 256 << 20

    def save(self, chunk_rows: Optional[int] = None,
             include_moments: bool = False):
        """Checkpoint every table across all shards (reference:
        checkpoint_notify_op.cc / RequestCheckpoint).  Keys page and rows
        stream in chunks sized by the row width, so any shard checkpoints
        within the wire-frame cap.  Returns {table: (ids[N], rows[N, dim])}.

        ``include_moments=True`` additionally dumps the server-side
        optimizer accumulators (adagrad moments) for any table that has
        them, id-aligned with the row dump: values become
        ``(ids, rows, moments_or_None)`` 3-tuples, and a restore through
        :meth:`load_tables` is then EXACT for sparse optimizers (the
        per-row step sizes resume, not restart)."""
        out: Dict[str, List] = {}
        # one directory pass up front: a table whose moments live on ANY
        # shard dumps moments from EVERY shard (zeros where absent), so
        # the concatenated dump stays id-aligned across shards
        shard_tables = [
            self._call(i, {"op": "tables"})["tables"]
            for i in range(len(self.endpoints))
        ]
        has_moments = set()
        if include_moments:
            for tables in shard_tables:
                for name, info in tables.items():
                    if int(info.get("moments", 0)) > 0:
                        has_moments.add(name)
        for i in range(len(self.endpoints)):
            for name, info in shard_tables[i].items():
                dim = max(1, int(info["dim"]))
                rows_per_chunk = chunk_rows or max(
                    1, self._SAVE_BYTES_PER_CHUNK // (dim * 4)
                )
                keys_per_page = max(1, self._SAVE_BYTES_PER_CHUNK // 8)
                id_pages = []
                start = 0
                while True:
                    resp = self._call(
                        i, {"op": "keys", "table": name, "start": start, "limit": keys_per_page}
                    )
                    page = resp["ids"]
                    if len(page):
                        id_pages.append(page)
                    start += len(page)
                    if start >= resp["total"] or len(page) == 0:
                        break
                ids = np.concatenate(id_pages) if id_pages else np.zeros(0, np.int64)
                chunks = []
                mchunks = []
                for s in range(0, len(ids), rows_per_chunk):
                    part = ids[s : s + rows_per_chunk]
                    chunks.append(
                        self._call(i, {"op": "pull", "table": name, "ids": part})["rows"]
                    )
                    if name in has_moments:
                        mchunks.append(self._call(
                            i, {"op": "pull_moments", "table": name,
                                "ids": part})["rows"])
                rows = (
                    np.concatenate(chunks)
                    if chunks
                    else np.zeros((0, dim), np.float32)
                )
                out.setdefault(name, [[], [], []])
                out[name][0].append(ids)
                out[name][1].append(rows)
                if name in has_moments:
                    out[name][2].append(
                        np.concatenate(mchunks) if mchunks
                        else np.zeros((0, dim), np.float32))
        state = {}
        for n, v in out.items():
            ids = np.concatenate(v[0]) if v[0] else np.zeros(0, np.int64)
            rows = (np.concatenate(v[1]) if v[1]
                    else np.zeros((0, 0), np.float32))
            if not include_moments:
                state[n] = (ids, rows)
            else:
                moments = np.concatenate(v[2]) if v[2] else None
                state[n] = (ids, rows, moments)
        return state

    def load_tables(self, state, chunk_rows: Optional[int] = None):
        """Restore a :meth:`save` dump: create any missing table and
        ASSIGN the saved rows by value (the server-side ``assign`` op
        bypasses the optimizer — a restored row lands exactly as saved;
        table optimizer config comes from whoever creates the tables,
        normally the program binding).  Values may be ``(ids, rows)``
        pairs or ``(ids, rows, moments)`` triples from
        ``save(include_moments=True)`` — a moments array restores the
        adagrad accumulators by value too, making SIGKILL-resume exact
        for sparse optimizers.  Rows stream in wire-cap-sized chunks
        like :meth:`save`."""
        for name, value in state.items():
            if len(value) == 3:
                ids, rows, moments = value
            else:
                ids, rows = value
                moments = None
            ids = np.asarray(ids, np.int64).reshape(-1)
            rows = np.asarray(rows, np.float32).reshape(len(ids), -1)
            if moments is not None:
                moments = np.asarray(moments, np.float32).reshape(
                    len(ids), -1)
            if not len(ids):
                continue
            dim = rows.shape[1]
            self.create_table(name, dim)
            per_chunk = chunk_rows or max(
                1, self._SAVE_BYTES_PER_CHUNK // (dim * 4))
            parts = shard_ids(ids, len(self.endpoints))
            for i, pos in enumerate(parts):
                if len(pos) == 0:
                    continue
                for s in range(0, len(pos), per_chunk):
                    sel = pos[s:s + per_chunk]
                    msg = {"op": "assign", "table": name,
                           "ids": ids[sel], "rows": rows[sel]}
                    if moments is not None:
                        msg["moments"] = moments[sel]
                    self._call(i, msg)

    def close(self):
        for s in self._socks:
            if s is not None:
                s.close()
        self._socks = [None] * len(self.endpoints)
