"""Wire transports: the ABC seam + the stdlib-HTTP implementation (the
port's copy of the JAX package's ``serving/wire/http.py``).

``Transport`` is the deliberate narrow waist between the serving client
surface and the bytes on the network: one ``request()`` that moves a
``(meta, arrays)`` message each way plus headers.  The HTTP transport
below implements it with nothing beyond ``http.client`` (POST bodies in
the ``codec`` framing, keep-alive via one pooled connection per calling
thread); a gRPC transport later implements the same four methods and
slots in behind ``RemoteClient``/``FleetBalancer`` untouched.

Failure typing is the transport's contract (the fleet's requeue state
machine routes on it):

* socket timeout            -> ``DeadlineExceeded``   (not retryable)
* refused/reset/half-close  -> ``BackendUnavailable`` (retryable: the
  process died — the balancer re-routes to a survivor)
* malformed response body   -> ``WireProtocolError``
* typed serving errors travel IN-BAND (response meta ``error`` field)
  and are re-raised by the caller, never guessed from status codes.
"""
from __future__ import annotations

import abc
import http.client
import socket
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch.serving.errors import BackendUnavailable, DeadlineExceeded
from paddle_tpu_torch.serving.wire import codec
from paddle_tpu_torch.serving.wire.metrics import (
    WIRE_BYTES_RECEIVED,
    WIRE_BYTES_SENT,
    WIRE_REQUESTS,
)

__all__ = ["Transport", "HttpTransport", "CONTENT_TYPE"]

CONTENT_TYPE = "application/x-paddle-tpu-wire"

_REQS = WIRE_REQUESTS.labels(role="client")
_SENT = WIRE_BYTES_SENT.labels(role="client")
_RECV = WIRE_BYTES_RECEIVED.labels(role="client")


class Transport(abc.ABC):
    """One bidirectional message exchange with a remote serving process.

    Implementations must be safe for concurrent ``request()`` calls from
    multiple threads (the fleet balancer and ``infer_many`` fan out)."""

    @abc.abstractmethod
    def request(self, path: str, meta: Dict[str, object],
                arrays: Sequence[np.ndarray] = (),
                timeout_s: Optional[float] = None,
                headers: Optional[Dict[str, str]] = None,
                ) -> Tuple[Dict[str, object], List[np.ndarray]]:
        """POST one message, return the response message.  ``timeout_s``
        bounds the whole exchange."""

    def stream(self, path: str, meta: Dict[str, object],
               arrays: Sequence[np.ndarray] = (),
               timeout_s: Optional[float] = None,
               headers: Optional[Dict[str, str]] = None):
        """POST one message, iterate RESPONSE messages as the peer
        produces them (the streaming-decode path: each yielded
        ``(meta, arrays)`` is one codec message read incrementally off
        the response body; the message carrying ``meta['final']`` ends
        the stream).  Optional: a transport that cannot stream raises —
        callers degrade to :meth:`request`."""
        raise NotImplementedError(
            "%s does not support streaming responses"
            % type(self).__name__)

    @abc.abstractmethod
    def get_json(self, path: str,
                 timeout_s: Optional[float] = None) -> Dict[str, object]:
        """GET a JSON control document (health/status surfaces)."""

    def get_text(self, path: str,
                 timeout_s: Optional[float] = None) -> str:
        """GET a plain-text document (the ``/metrics`` exposition — the
        federation scraper's fetch).  Optional: a transport that cannot
        serve raw text raises — the scraper just skips the backend."""
        raise NotImplementedError(
            "%s does not support text GETs" % type(self).__name__)

    @abc.abstractmethod
    def close(self) -> None:
        """Release pooled connections (idempotent)."""

    @property
    @abc.abstractmethod
    def address(self) -> Tuple[str, int]:
        """The remote ``(host, port)`` this transport targets."""


class _CountingReader:
    """File-like over an HTTPResponse that feeds the received-bytes
    counter as the codec pulls frames off the stream."""

    __slots__ = ("_resp", "_counter")

    def __init__(self, resp, counter):
        self._resp = resp
        self._counter = counter

    def read(self, n: int) -> bytes:
        data = self._resp.read(n)
        if data:
            self._counter.inc(len(data))
        return data


class HttpTransport(Transport):
    """stdlib ``http.client`` transport with per-thread keep-alive.

    Each calling thread owns one pooled ``HTTPConnection`` (HTTP/1.1
    keep-alive: steady-state requests reuse the TCP connection — no
    per-request handshake on the hot path); a connection that errors is
    torn down so the next call redials."""

    def __init__(self, host: str, port: int,
                 timeout_s: float = 30.0,
                 max_frame_bytes: int = codec.DEFAULT_MAX_FRAME_BYTES):
        self._host = str(host)
        self._port = int(port)
        self._timeout_s = float(timeout_s)
        self._max_frame_bytes = int(max_frame_bytes)
        self._tls = threading.local()
        self._closed = False

    # ------------------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return (self._host, self._port)

    def _conn(self, timeout_s: Optional[float]) -> http.client.HTTPConnection:
        if timeout_s is not None and timeout_s <= 0:
            # a 0/negative socket timeout means NON-BLOCKING mode, whose
            # BlockingIOError would masquerade as a dead backend — an
            # exhausted deadline is typed before it touches the socket
            raise DeadlineExceeded(
                "deadline exhausted before the wire exchange to %s:%d"
                % self.address)
        conn = getattr(self._tls, "conn", None)
        if conn is None:
            conn = http.client.HTTPConnection(
                self._host, self._port,
                timeout=timeout_s if timeout_s is not None else self._timeout_s)
            self._tls.conn = conn
        else:
            conn.timeout = (
                timeout_s if timeout_s is not None else self._timeout_s)
            if conn.sock is not None:
                conn.sock.settimeout(conn.timeout)
        return conn

    def _drop_conn(self) -> None:
        conn = getattr(self._tls, "conn", None)
        self._tls.conn = None
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass

    # ------------------------------------------------------------------
    def request(self, path: str, meta: Dict[str, object],
                arrays: Sequence[np.ndarray] = (),
                timeout_s: Optional[float] = None,
                headers: Optional[Dict[str, str]] = None,
                ) -> Tuple[Dict[str, object], List[np.ndarray]]:
        body = codec.encode_message(meta, arrays)
        hdrs = {"Content-Type": CONTENT_TYPE}
        if headers:
            hdrs.update(headers)
        # hot-path: begin wire_request (client side of the hop: one POST
        # over the pooled keep-alive connection; the only waits are
        # socket I/O bounded by the timeout)
        if _faults.active is not None:  # disarmed: one is-None gate
            act = _faults.active.faultpoint(
                "wire.send", backend="%s:%d" % self.address)
            if act is not None:
                body = act.corrupt(body)
        conn = self._conn(timeout_s)
        try:
            conn.request("POST", path, body=body, headers=hdrs)
            resp = conn.getresponse()
            payload = resp.read()
        except socket.timeout as e:
            self._drop_conn()
            raise DeadlineExceeded(
                "wire request to %s:%d timed out" % self.address) from e
        except (ConnectionError, http.client.HTTPException, OSError) as e:
            self._drop_conn()
            raise BackendUnavailable(
                "backend %s:%d unreachable: %r" % (self._host, self._port, e)
            ) from e
        _REQS.inc()
        _SENT.inc(len(body))
        _RECV.inc(len(payload))
        rmeta, rarrays = codec.decode_message(
            payload, max_frame_bytes=self._max_frame_bytes)
        # hot-path: end wire_request
        return rmeta, rarrays

    def stream(self, path: str, meta: Dict[str, object],
               arrays: Sequence[np.ndarray] = (),
               timeout_s: Optional[float] = None,
               headers: Optional[Dict[str, str]] = None):
        """POST, then yield ``(meta, arrays)`` response messages as the
        server produces them (chunked transfer; ``http.client`` decodes
        the chunk framing transparently, the codec reads message by
        message).  The message carrying ``meta['final']`` ends the
        stream; an abandoned or failed stream DROPS the pooled
        connection — a half-read response body can never desync the
        next request on this thread's socket."""
        body = codec.encode_message(meta, arrays)
        hdrs = {"Content-Type": CONTENT_TYPE}
        if headers:
            hdrs.update(headers)
        if _faults.active is not None:  # disarmed: one is-None gate
            act = _faults.active.faultpoint(
                "wire.send", backend="%s:%d" % self.address)
            if act is not None:
                body = act.corrupt(body)
        conn = self._conn(timeout_s)
        try:
            conn.request("POST", path, body=body, headers=hdrs)
            resp = conn.getresponse()
        except socket.timeout as e:
            self._drop_conn()
            raise DeadlineExceeded(
                "wire stream to %s:%d timed out" % self.address) from e
        except (ConnectionError, http.client.HTTPException, OSError) as e:
            self._drop_conn()
            raise BackendUnavailable(
                "backend %s:%d unreachable: %r" % (self._host, self._port, e)
            ) from e
        _REQS.inc()
        _SENT.inc(len(body))
        return self._stream_messages(resp, conn)

    def _stream_messages(self, resp, conn):
        """Generator reading codec messages off one response body.  The
        connection stays pooled only after a CLEAN finish (final message
        seen, body drained); every other exit path drops it."""
        clean = False
        try:
            while True:
                try:
                    rmeta, rarrays = codec.read_message(
                        _CountingReader(resp, _RECV),
                        max_frame_bytes=self._max_frame_bytes)
                except socket.timeout as e:
                    raise DeadlineExceeded(
                        "wire stream from %s:%d timed out"
                        % self.address) from e
                except (ConnectionError, http.client.HTTPException,
                        OSError) as e:
                    raise BackendUnavailable(
                        "backend %s:%d died mid-stream: %r"
                        % (self._host, self._port, e)) from e
                final = bool(rmeta.get("final"))
                if final:
                    # drain + mark clean BEFORE yielding: consumers stop
                    # at the final message without advancing the
                    # generator again, so post-yield code would only run
                    # under GeneratorExit and every stream would drop
                    # its pooled connection
                    resp.read()  # drain the terminator for keep-alive
                    clean = True
                yield rmeta, rarrays
                if final:
                    return
        finally:
            if not clean:
                # this generator may be close()d from ANY thread (the
                # fleet's abandoned-stream GC finalizer) — _drop_conn
                # only clears the CALLING thread's pool slot, so close
                # the very connection the stream was reading; the
                # owning thread's pooled handle then auto-reopens on
                # its next request instead of reusing a half-read
                # socket
                if getattr(self._tls, "conn", None) is conn:
                    self._tls.conn = None
                try:
                    conn.close()
                except Exception:
                    pass

    def get_json(self, path: str,
                 timeout_s: Optional[float] = None) -> Dict[str, object]:
        import json

        conn = self._conn(timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = resp.read()
        except socket.timeout as e:
            self._drop_conn()
            raise DeadlineExceeded(
                "wire GET %s on %s:%d timed out"
                % ((path,) + self.address)) from e
        except (ConnectionError, http.client.HTTPException, OSError) as e:
            self._drop_conn()
            raise BackendUnavailable(
                "backend %s:%d unreachable: %r" % (self._host, self._port, e)
            ) from e
        if resp.status != 200:
            raise BackendUnavailable(
                "GET %s on %s:%d -> HTTP %d"
                % (path, self._host, self._port, resp.status))
        try:
            return json.loads(payload.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            from paddle_tpu_torch.serving.errors import WireProtocolError

            raise WireProtocolError("undecodable JSON from %s: %s"
                                    % (path, e)) from e

    def get_text(self, path: str,
                 timeout_s: Optional[float] = None) -> str:
        conn = self._conn(timeout_s)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            payload = resp.read()
        except socket.timeout as e:
            self._drop_conn()
            raise DeadlineExceeded(
                "wire GET %s on %s:%d timed out"
                % ((path,) + self.address)) from e
        except (ConnectionError, http.client.HTTPException, OSError) as e:
            self._drop_conn()
            raise BackendUnavailable(
                "backend %s:%d unreachable: %r" % (self._host, self._port, e)
            ) from e
        if resp.status != 200:
            raise BackendUnavailable(
                "GET %s on %s:%d -> HTTP %d"
                % (path, self._host, self._port, resp.status))
        return payload.decode("utf-8", errors="replace")

    def close(self) -> None:
        self._closed = True
        self._drop_conn()
