"""RemoteClient: the in-process ``Client`` surface over a wire hop (the
port's copy of the JAX package's ``serving/wire/client.py``).

Keeps the transport-agnostic contract the serving layer promised: the
same ``infer`` / ``infer_named`` / ``infer_many`` / ``infer_stream``
signatures (streaming rides chunked codec messages on one response),
the same typed errors (``ServerOverloaded`` / ``DeadlineExceeded`` /
``ServerClosed`` re-raised from the response's in-band error channel,
``BackendUnavailable`` / ``WireProtocolError`` for transport/framing
failures), and the same per-request trace-id minting — now carried
across the process boundary in a W3C ``traceparent`` header, with the
server's retained span tree merged back into the local flight recorder
so ``/tracez`` shows ONE tree per request spanning both processes.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.serving import errors as _errors
from paddle_tpu_torch.serving.admission import PRIORITY_NORMAL
from paddle_tpu_torch.serving.errors import DeadlineExceeded, ServingError
from paddle_tpu_torch.serving.wire.codec import format_traceparent
from paddle_tpu_torch.serving.wire.http import HttpTransport, Transport

__all__ = ["RemoteClient", "raise_in_band_error", "wire_call",
           "wire_stream_open", "flight_report"]

# the response meta "error" field names a type from serving.errors (or
# the validation builtin); an unknown name degrades to the base
# ServingError (typed, never a crash)
_ERROR_TYPES = {
    name: getattr(_errors, name)
    for name in _errors.__all__
}
_ERROR_TYPES["ValueError"] = ValueError


def flight_report(fr, tid: str, sid: str, t0: float, dur: float,
                  err: Optional[BaseException],
                  server_spans: Sequence[Dict] = (), **extra) -> None:
    """Merge one wire request into the LOCAL flight recorder: the
    client-side span plus the server-side tree the response carried
    (one cross-process record under one trace id).  Mirrors the
    in-process client's retention policy: errors other than a deadline
    are recorded only when the request came back with server spans or
    was already retained — a storm of shed/unreachable requests must
    not flood the bounded ring and evict the slow tail."""
    span = {
        "name": "serving/client_infer", "cat": "client", "id": sid,
        "ts": _spans.wall_ts(t0), "dur": dur,
        "tid": threading.get_ident(), "trace_ids": [tid],
    }
    if err is not None:
        span["error"] = True
    spans = [span] + [dict(s) for s in server_spans]
    status = ("ok" if err is None else
              "deadline" if isinstance(err, _errors.DeadlineExceeded)
              else "error")
    if fr.get_record(tid) is not None:
        for s in spans:
            fr.add_span(tid, s)
        return
    if err is not None and status == "error" and not server_spans:
        return
    fr.consider(tid, dur, status, spans, **extra)


def raise_in_band_error(meta: Dict[str, object]) -> None:
    """Re-raise the typed serving error a response meta carries (no-op
    for a success meta).  A ``retry_after_ms`` hint in the meta (the
    server's computed overload backoff) is re-attached to the raised
    error so the fleet's retry pacing can honor it."""
    name = meta.get("error")
    if not name:
        return
    etype = _ERROR_TYPES.get(str(name), ServingError)
    err = etype(str(meta.get("message") or name))
    retry_ms = meta.get("retry_after_ms")
    if retry_ms is not None:
        try:
            err.retry_after_ms = float(retry_ms)
        except (TypeError, ValueError):
            pass  # a malformed hint never masks the typed error
    load = meta.get("load")
    if isinstance(load, dict):
        # a typed error still carries the server's load report: the
        # balancer's least-loaded routing learns from sheds too
        err.load = load
    raise err


def wire_call(transport: Transport, feed_names: Sequence[str],
              arrays: Sequence[np.ndarray], timeout_ms: Optional[float],
              tid: str, extra_meta: Optional[Dict[str, object]] = None,
              priority: Optional[int] = None,
              ) -> Tuple[Dict[str, object], List[np.ndarray]]:
    """One traced ``/infer`` exchange (shared by ``RemoteClient`` and
    the fleet balancer): records the client-side ``wire/request`` span,
    sends its id as the ``traceparent`` parent so the server's request
    span is its child, and asks for the server-side span tree whenever a
    local sink could use it.  ``timeout_ms`` is the REMAINING deadline
    at send time (the server sheds <= 0 at admission); ``priority`` is
    the admission class carried in the request meta."""
    fr = _flight.get()
    rec = _spans.recording() or fr is not None
    meta: Dict[str, object] = {"feed_names": list(feed_names)}
    if timeout_ms is not None:
        meta["timeout_ms"] = float(timeout_ms)
    if priority is not None:
        meta["priority"] = int(priority)
    if extra_meta:
        meta.update(extra_meta)
    # hot-path: begin wire_dispatch (trace gates + the transport POST;
    # the request path must not add blocking work beyond the socket)
    timeout_s = (
        float(timeout_ms) / 1e3 if timeout_ms is not None else None)
    if not rec:
        rmeta, routs = transport.request(
            "/infer", meta, arrays, timeout_s=timeout_s)
        raise_in_band_error(rmeta)
        return rmeta, routs
    sid = _spans.new_span_id()
    headers = {"traceparent": format_traceparent(tid, sid),
               "X-Wire-Spans": "1"}
    t0 = time.perf_counter()
    err: Optional[BaseException] = None
    try:
        with _spans.trace_context((tid,)):
            with _spans.parent_scope(sid):
                rmeta, routs = transport.request(
                    "/infer", meta, arrays, timeout_s=timeout_s,
                    headers=headers)
        raise_in_band_error(rmeta)
        return rmeta, routs
    except BaseException as e:  # noqa: BLE001 — observed, re-raised
        err = e
        raise
    finally:
        with _spans.trace_context((tid,)):
            _spans.record_span(
                "wire/request", t0, time.perf_counter() - t0, cat="wire",
                span_id=sid, error=err is not None,
                backend="%s:%d" % transport.address)
    # hot-path: end wire_dispatch


def wire_stream_open(transport: Transport, feed_names: Sequence[str],
                     arrays: Sequence[np.ndarray],
                     timeout_ms: Optional[float], tid: str,
                     extra_meta: Optional[Dict[str, object]] = None,
                     priority: Optional[int] = None):
    """Open one ``/infer_stream`` exchange and read its FIRST message
    (shared by ``RemoteClient`` and the fleet balancer): a pre-stream
    failure — unreachable backend, admission shed, expired deadline —
    surfaces typed AT THIS CALL, before the caller commits to the
    stream, which is what lets the fleet requeue to a survivor.
    Returns ``(iterator, first_message)``; subsequent messages come off
    the iterator, each either a token chunk or the ``final`` meta (a
    mid-stream error travels in-band on the final message)."""
    meta: Dict[str, object] = {"feed_names": list(feed_names)}
    if timeout_ms is not None:
        meta["timeout_ms"] = float(timeout_ms)
    if priority is not None:
        meta["priority"] = int(priority)
    if extra_meta:
        meta.update(extra_meta)
    timeout_s = (
        float(timeout_ms) / 1e3 if timeout_ms is not None else None)
    headers = {"traceparent": format_traceparent(tid, _spans.new_span_id())}
    it = transport.stream("/infer_stream", meta, arrays,
                          timeout_s=timeout_s, headers=headers)
    first = next(iter(it), None)
    if first is None:
        raise _errors.WireProtocolError(
            "stream closed before the first message")
    raise_in_band_error(first[0])
    return it, first


def pump_stream_messages(it, first, counter: List[int]):
    """The one client/fleet stream-consumption protocol: yield token
    chunks off a wire message iterator (``yield from`` this), re-raising
    in-band typed errors, and RETURN the ``final`` meta message.
    ``counter``: one-element list incremented per chunk, so the caller's
    accounting survives an abandoned (closed mid-yield) generator."""
    rmeta, rarrays = first
    while True:
        raise_in_band_error(rmeta)
        if rmeta.get("final"):
            return rmeta
        counter[0] += 1
        yield rarrays[0]
        nxt = next(it, None)
        if nxt is None:
            raise _errors.WireProtocolError(
                "stream ended without a final message")
        rmeta, rarrays = nxt


class RemoteClient:
    """Client for ONE remote ``ServingProcess``.

    ``address``: ``(host, port)`` (an ``HttpTransport`` is built over
    it) or any ``Transport`` instance — the gRPC seam.  Endpoint shape
    (feed/fetch names) is discovered from ``/healthz`` on first use."""

    def __init__(self, address, timeout_s: float = 30.0):
        if isinstance(address, Transport):
            self._transport = address
        else:
            host, port = address
            self._transport = HttpTransport(host, port, timeout_s=timeout_s)
        self._shape_lock = threading.Lock()
        self._feed_names: Optional[List[str]] = None
        self._fetch_names: Optional[List[str]] = None
        self._pool = None  # lazy persistent executor (infer_many)

    def _executor(self):
        """Persistent worker pool for scatter/gather: long-lived threads
        mean the transport's PER-THREAD keep-alive connections are
        actually reused across infer_many calls (fresh threads per call
        would redial every request)."""
        with self._shape_lock:
            if self._pool is None:
                import concurrent.futures

                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="wire-client")
            return self._pool

    # ------------------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self._transport.address

    def _endpoint_shape(self) -> Tuple[List[str], List[str]]:
        with self._shape_lock:
            if self._feed_names is None:
                doc = self._transport.get_json("/healthz")
                self._feed_names = [str(n) for n in doc["input_names"]]
                self._fetch_names = [str(n) for n in doc["output_names"]]
            return self._feed_names, self._fetch_names

    def healthz(self) -> Dict[str, object]:
        return self._transport.get_json("/healthz")

    # -- admin observability surfaces (tooling/test conveniences) ------
    def statusz(self) -> Dict[str, object]:
        return self._transport.get_json("/statusz")

    def tracez(self) -> Dict[str, object]:
        return self._transport.get_json("/tracez")

    def sloz(self) -> Dict[str, object]:
        return self._transport.get_json("/sloz")

    def eventz(self) -> Dict[str, object]:
        return self._transport.get_json("/eventz")

    def metrics_text(self) -> str:
        """The raw ``/metrics`` exposition (what a scraper sees)."""
        return self._transport.get_text("/metrics")

    def warmup(self, timeout_s: float = 600.0) -> int:
        """Trigger the remote server's bucket-ladder warmup; returns the
        count its ``warmup()`` reports (the warm-up passes it ran)."""
        meta, _ = self._transport.request(
            "/warmup", {}, (), timeout_s=timeout_s)
        raise_in_band_error(meta)
        return int(meta.get("compiles", 0))

    def _normalize(self, feed) -> Tuple[List[str], List[np.ndarray]]:
        names, _ = self._endpoint_shape()
        if not isinstance(feed, dict):
            feed = dict(zip(names, feed))
        if set(feed) != set(names):
            raise ValueError(
                "feed names %s != endpoint inputs %s"
                % (sorted(feed), sorted(names)))
        return names, [feed[n] for n in names]

    # ------------------------------------------------------------------
    def infer(self, feed, timeout_ms: Optional[float] = None,
              trace_id: Optional[str] = None,
              priority: int = PRIORITY_NORMAL,
              precision: Optional[str] = None) -> List[np.ndarray]:
        """Submit one request over the wire and block for its outputs
        (ordered like the endpoint's fetch list).  Same deadline /
        overload / closed error types as the in-process client, plus
        ``BackendUnavailable`` when the remote process is gone.

        ``precision`` rides the request meta to the server's
        mixed-precision dispatch (``"fp32"`` = per-request opt-out of
        the endpoint's policy default); an unknown dtype re-raises the
        server's typed ValueError.

        ``priority`` (``serving.admission.PRIORITY_*``, lower = more
        important) rides the request meta into the server's priority
        shedding.  The deadline is anchored at THIS call's entry: what
        goes over the wire is the remaining budget at send time, so
        work done inside the call (endpoint-shape discovery on first
        use, feed normalization) debits the caller's clock and the
        server sheds already-expired work at admission instead of
        dispatching it.  (``infer_many`` pool waits happen before the
        per-request ``infer`` starts, so each request's budget starts
        when its worker picks it up.)"""
        tid = trace_id or monitor.new_trace_id()
        self.last_trace_id = tid
        deadline = (
            time.monotonic() + float(timeout_ms) / 1e3
            if timeout_ms is not None else None)
        names, arrays = self._normalize(feed)
        remaining_ms = self._remaining_ms(deadline)
        extra = {"precision": str(precision)} if precision is not None else None
        fr = _flight.get()
        rec = _spans.recording() or fr is not None
        if not rec:
            _, routs = wire_call(
                self._transport, names, arrays, remaining_ms, tid,
                priority=priority, extra_meta=extra)
            return routs
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        sid = _spans.new_span_id()
        # the capture buffer collects this thread's wire/request span so
        # the flight record carries the hop, not just its endpoints
        cap: List[Dict] = []
        extra_spans: List[Dict] = []
        try:
            with _spans.trace_context((tid,)):
                with _spans.parent_scope(sid):
                    with _spans.capture(cap):
                        rmeta, routs = wire_call(
                            self._transport, names, arrays, remaining_ms,
                            tid, priority=priority, extra_meta=extra)
            extra_spans = list(rmeta.get("spans") or ())
            return routs
        except BaseException as e:  # noqa: BLE001 — observed, re-raised
            err = e
            raise
        finally:
            dur = time.perf_counter() - t0
            with _spans.trace_context((tid,)):
                _spans.record_span(
                    "serving/client_infer", t0, dur, cat="client",
                    span_id=sid, error=err is not None)
            if fr is not None:
                flight_report(fr, tid, sid, t0, dur, err,
                              cap + extra_spans)

    @staticmethod
    def _remaining_ms(deadline: Optional[float]) -> Optional[float]:
        """Remaining budget at send time.  Already-expired fails fast
        HERE, typed — never burns a wire exchange on dead work."""
        if deadline is None:
            return None
        remaining = (deadline - time.monotonic()) * 1e3
        if remaining <= 0:
            raise DeadlineExceeded(
                "deadline exhausted before the wire send")
        return remaining

    def infer_named(self, feed, timeout_ms: Optional[float] = None,
                    trace_id: Optional[str] = None,
                    priority: int = PRIORITY_NORMAL) -> Dict[str, np.ndarray]:
        """``infer()``, but keyed by the endpoint's output names."""
        _, fetch_names = self._endpoint_shape()
        return dict(zip(fetch_names,
                        self.infer(feed, timeout_ms, trace_id=trace_id,
                                   priority=priority)))

    def infer_many(self, feeds, timeout_ms: Optional[float] = None,
                   priority: int = PRIORITY_NORMAL
                   ) -> List[List[np.ndarray]]:
        """Issue every request concurrently (so the remote batcher can
        coalesce them into shared batches) and gather results in order.
        Each request gets its own trace id (``last_trace_ids``)."""
        tids = [monitor.new_trace_id() for _ in feeds]
        self.last_trace_ids = tids
        futures = [
            self._executor().submit(
                self.infer, f, timeout_ms, trace_id=t, priority=priority)
            for f, t in zip(feeds, tids)
        ]
        return [f.result() for f in futures]

    def infer_stream(self, feed, timeout_ms: Optional[float] = None,
                     trace_id: Optional[str] = None,
                     priority: int = PRIORITY_NORMAL,
                     max_new_tokens: Optional[int] = None,
                     speculative: Optional[bool] = None):
        """Stream generated-token chunks from a remote decode endpoint
        (``serving.decode.DecodeServer`` behind a ``ServingProcess``):
        each yielded 1-D int32 array is one chunk, received over the
        wire as its own codec message on the chunked response body —
        the first arrives as soon as the server's scheduler completes
        the request's first tick, long before the sequence finishes.

        Pre-stream failures (unreachable backend, admission shed,
        expired deadline, a non-streaming endpoint) raise typed AT THIS
        CALL; a mid-stream failure re-raises typed from the iterator.
        Every chunk carries the one trace id (``last_trace_id``); the
        final message's meta lands in ``last_stream_final`` (chunk
        count, output names, the server's load report).  Abandoning the
        iterator drops the pooled connection — and the server, seeing
        the peer gone, aborts the decode so its slot frees."""
        tid = trace_id or monitor.new_trace_id()
        self.last_trace_id = tid
        deadline = (
            time.monotonic() + float(timeout_ms) / 1e3
            if timeout_ms is not None else None)
        names, arrays = self._normalize(feed)
        remaining_ms = self._remaining_ms(deadline)
        extra = {}
        if max_new_tokens is not None:
            extra["max_new_tokens"] = int(max_new_tokens)
        if speculative is not None:
            # decode tier 2: ask the endpoint to draft-and-verify this
            # stream (greedy-exact — same tokens, fewer target steps)
            extra["speculative"] = bool(speculative)
        it, first = wire_stream_open(
            self._transport, names, arrays, remaining_ms, tid,
            extra_meta=extra, priority=priority)
        return self._stream_chunks(it, first, tid)

    def _stream_chunks(self, it, first, tid: str):
        t0 = time.perf_counter()
        sid = _spans.new_span_id() if _spans.recording() else None
        err: Optional[BaseException] = None
        counter = [0]
        try:
            self.last_stream_final = yield from pump_stream_messages(
                it, first, counter)
            return
        except GeneratorExit:
            raise  # abandoned: neutral, not a stream failure
        except BaseException as e:  # noqa: BLE001 — observed, re-raised
            err = e
            raise
        finally:
            # abandoning mid-stream closes the transport iterator, which
            # drops the (desynced) pooled connection
            close = getattr(it, "close", None)
            if close is not None:
                close()
            if sid is not None:
                with _spans.trace_context((tid,)):
                    _spans.record_span(
                        "serving/client_stream", t0,
                        time.perf_counter() - t0, cat="client",
                        span_id=sid, chunks=counter[0],
                        error=err is not None,
                        backend="%s:%d" % self._transport.address)

    def close(self) -> None:
        with self._shape_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
        self._transport.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
