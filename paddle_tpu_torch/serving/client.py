"""In-process client helper over InferenceServer and DecodeServer (the
port's ``serving/client.py``).

The test-and-bench-facing convenience surface: blocking single calls,
scatter/gather for many requests, named-output dicts, and token streams
from a decode server.  Its remote twin over a wire hop, with the same
signatures and errors, is ``serving.wire.RemoteClient``.

Request-scoped tracing: every ``infer*`` call mints a trace id (or
accepts one via ``trace_id=``), propagates it through submit() into the
batcher/replica/executor span chain, and — when a flight recorder is
installed — reports the client-side span (submit -> result, the
latency the caller actually saw) so a tail-sampled record shows the
full client->device chain under one id.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Dict, List, Optional

import numpy as np

from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.serving.admission import PRIORITY_NORMAL
from paddle_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ServerClosed,
    ServingError,
)

__all__ = ["Client"]


class Client:
    def __init__(self, server):
        self._server = server
        self._fetch_names = list(server._predictor.get_output_names())

    def infer(self, feed, timeout_ms: Optional[float] = None,
              trace_id: Optional[str] = None,
              priority: int = PRIORITY_NORMAL,
              precision: Optional[str] = None) -> List[np.ndarray]:
        """Submit one request and block for its outputs (list ordered
        like the predictor's fetch list).  ``priority`` is the admission
        class (``serving.admission.PRIORITY_*``, lower = more
        important): under overload the server sheds low priority first.
        ``precision`` picks the variant on a mixed-precision endpoint
        (``"fp32"`` opts this request out of the policy default; both are
        warm, so neither choice builds anything).
        ``trace_id`` joins the call to an existing trace; by default a
        fresh id is minted — read it back via ``last_trace_id``."""
        tid = trace_id or monitor.new_trace_id()
        self.last_trace_id = tid
        kw = {"precision": precision} if precision is not None else {}
        fr = _flight.get()
        rec = _spans.recording() or fr is not None
        if not rec:
            return self._server.submit(
                feed, timeout_ms=timeout_ms, trace_id=tid,
                priority=priority, **kw).result()
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        sid = _spans.new_span_id()
        try:
            with _spans.trace_context((tid,)):
                with _spans.parent_scope(sid):
                    return self._server.submit(
                        feed, timeout_ms=timeout_ms, trace_id=tid,
                        parent_span=sid, priority=priority, **kw).result()
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
                self._flight_report(fr, tid, sid, t0, dur, err)

    @staticmethod
    def _flight_report(fr, tid: str, sid: str, t0: float, dur: float,
                       err: Optional[BaseException]) -> None:
        """Attach the client-side span to the request's tail-sampled
        record — or, for a deadline the server never got to observe
        (the future timed out client-side), create the record.  Other
        client-side errors (shed at admission, validation, server
        closed) are deliberately NOT retained: terminal server failures
        are recorded server-side, and an overload storm of rejected
        requests must not flood the bounded ring and evict the slow
        traces tail sampling exists to keep."""
        span = {
            "name": "serving/client_infer", "cat": "client", "id": sid,
            "ts": _spans.wall_ts(t0), "dur": dur,
            "tid": threading.get_ident(), "trace_ids": [tid],
        }
        if err is not None:
            span["error"] = True
        if fr.add_span(tid, span):
            return
        if err is not None and not isinstance(err, DeadlineExceeded):
            return
        fr.consider(
            tid, dur,
            "deadline" if isinstance(err, DeadlineExceeded) else "ok",
            [span])

    def infer_stream(self, feed, timeout_ms: Optional[float] = None,
                     trace_id: Optional[str] = None,
                     priority: int = PRIORITY_NORMAL,
                     max_new_tokens: Optional[int] = None):
        """Submit one decode prompt and iterate generated-token chunks
        (1-D int32 arrays) as the continuous-batching scheduler produces
        them — the first chunk arrives as soon as the request's first
        multi-step tick completes, long before the sequence finishes.

        Only a streaming endpoint (``serving.decode.DecodeServer``)
        supports this; a request-batching ``InferenceServer`` raises
        ``ServingError`` immediately.  Admission errors (shed, expired,
        closed) raise AT THIS CALL, not at first iteration; mid-stream
        failures re-raise typed from the iterator.  Abandoning the
        iterator aborts the decode so its slot frees for queued work.
        Every chunk belongs to one trace id (``last_trace_id``)."""
        if not getattr(self._server, "supports_streaming", False):
            raise ServingError(
                "endpoint does not stream (not a decode server); use "
                "infer() or serve the model with serving.decode")
        tid = trace_id or monitor.new_trace_id()
        self.last_trace_id = tid
        sid = _spans.new_span_id() if _spans.recording() else None
        kw = {}
        if max_new_tokens is not None:
            kw["max_new_tokens"] = int(max_new_tokens)
        with _spans.trace_context((tid,)):
            req = self._server.submit(
                feed, timeout_ms=timeout_ms, trace_id=tid,
                parent_span=sid, priority=priority, **kw)
        gen = self._stream_chunks(req, tid, sid)
        # a generator abandoned BEFORE its first next() never enters its
        # body, so _stream_chunks' finally can't abort the decode and
        # the slot would keep generating for a gone caller — a GC
        # finalizer covers that window (req.fail is a no-op once done,
        # so a normally-finished stream makes this inert)
        weakref.finalize(gen, Client._abort_unstarted, req)
        return gen

    @staticmethod
    def _abort_unstarted(req):
        if not req.done():
            req.fail(ServerClosed("stream consumer went away"))

    @staticmethod
    def _stream_chunks(req, tid: str, sid: Optional[str]):
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        chunks = 0
        try:
            for chunk in req.stream():
                chunks += 1
                yield chunk
        except GeneratorExit:
            raise  # abandoned: neutral, not a stream failure
        except BaseException as e:  # noqa: BLE001 — observed, re-raised
            err = e
            raise
        finally:
            if not req.done():
                if err is not None:
                    # a client-side typed failure (e.g. stream()'s own
                    # DeadlineExceeded) is the request's terminal error
                    req.fail(err)
                else:
                    # consumer walked away mid-stream: abort the decode
                    # so the slot frees for queued work at the next tick
                    req.fail(ServerClosed("stream consumer went away"))
            if sid is not None:
                with _spans.trace_context((tid,)):
                    _spans.record_span(
                        "serving/client_stream", t0,
                        time.perf_counter() - t0, cat="client",
                        span_id=sid, chunks=chunks, error=err is not None)

    def infer_named(self, feed, timeout_ms: Optional[float] = None,
                    trace_id: Optional[str] = None,
                    priority: int = PRIORITY_NORMAL) -> Dict[str, np.ndarray]:
        """infer(), but keyed by the endpoint's output names."""
        return dict(zip(self._fetch_names,
                        self.infer(feed, timeout_ms, trace_id=trace_id,
                                   priority=priority)))

    def infer_many(self, feeds, timeout_ms: Optional[float] = None,
                   priority: int = PRIORITY_NORMAL) -> List[List[np.ndarray]]:
        """Submit every feed first (so they can coalesce into shared
        batches), then gather all results in order.  Each request gets
        its own trace id (``last_trace_ids`` after the call)."""
        tids = [monitor.new_trace_id() for _ in feeds]
        futures = [
            self._server.submit(f, timeout_ms=timeout_ms, trace_id=t,
                                priority=priority)
            for f, t in zip(feeds, tids)
        ]
        self.last_trace_ids = tids
        return [f.result() for f in futures]
