"""ServingProcess: one InferenceServer behind the wire transport (the
port's copy of the JAX package's ``serving/wire/server.py``).

The process-boundary half of cross-host serving: an HTTP front door
over one ``InferenceServer`` (which keeps its whole in-process story —
dynamic batching, bucket ladder, replica fleet, zero-recompile warmup),
exposing

* ``POST /infer``     — one request in the ``codec`` framing (meta
  carries ``feed_names``/``timeout_ms``; arrays positional), response
  carries ``output_names`` + output arrays.  Typed serving errors
  travel in-band (``error``/``message`` meta fields + a mapped status
  code) so the remote client re-raises the exact error type the
  in-process client would have seen.
* ``POST /warmup``    — fleet-wide warmup hook: builds every bucket
  rung on every replica, returns ``warmup()``'s count as ``compiles``.
* ``GET  /healthz``   — liveness + endpoint shape (input/output names):
  the balancer's health-check and discovery surface.
* ``GET  /metrics`` ``/statusz`` ``/tracez`` — the same admin surface
  ``InferenceServer.start_admin()`` serves, on the wire port.
  ``/statusz`` also carries ``hand_kernels``: this process's hand-kernel
  launch tally by dtype (``kernels.launch_counts_by_dtype()``), the only
  view a parent has of the kernels a serving child launched.
* ``POST /quitquitquit`` — graceful drain + exit (rolling replacement).

Tracing across the hop: a request carrying a W3C ``traceparent`` header
joins the client's trace — its trace id flows through the batcher →
replica → executor span chain, the server-side request span records the
client's wire span as its REMOTE PARENT, and (when this process has a
flight recorder installed) the retained server-side span tree is
returned in the response meta so the client-side recorder merges ONE
cross-process tree per request.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional, Tuple

from paddle_tpu_torch import monitor
from paddle_tpu_torch.monitor import events as _events
from paddle_tpu_torch.monitor import flight as _flight
from paddle_tpu_torch.monitor import slo as _slo
from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.serving.errors import (
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    WireProtocolError,
)
from paddle_tpu_torch.serving.wire import codec
from paddle_tpu_torch.serving.wire.http import CONTENT_TYPE
from paddle_tpu_torch.serving.wire.metrics import (
    WIRE_BYTES_RECEIVED,
    WIRE_BYTES_SENT,
    WIRE_REQUESTS,
)

__all__ = ["ServingProcess", "error_status"]

_REQS = WIRE_REQUESTS.labels(role="server")
_SENT = WIRE_BYTES_SENT.labels(role="server")
_RECV = WIRE_BYTES_RECEIVED.labels(role="server")

# /infer's grace poll for the flight recorder to finish filing the
# request's span tree after its future completed: the replica finalizer
# completes futures a few microseconds before it files the record, so a
# handful of short polls close the race — and a request the recorder
# chose NOT to retain (slow_ms tail sampling) gives up after the same
# small bound instead of stalling the response (tracing-only path)
_SPAN_MERGE_POLLS = 10
_SPAN_MERGE_POLL_S = 0.002

# typed error -> HTTP status (the in-band meta "error" field is the
# authoritative type channel; the status code is for generic tooling)
_STATUS = (
    (ServerOverloaded, 429),
    (DeadlineExceeded, 504),
    (ServerClosed, 503),
    (WireProtocolError, 400),
    (ValueError, 400),
    (ServingError, 500),
)


def error_status(exc: BaseException) -> int:
    for etype, status in _STATUS:
        if isinstance(exc, etype):
            return status
    return 500


class ServingProcess:
    """Bind an ``InferenceServer`` to a wire port.

    ``start()`` serves on a daemon thread and returns the bound address
    (``port=0`` = ephemeral); ``serve_forever()`` blocks the calling
    thread instead (the ``launch.py`` child main).  ``stop()`` closes
    the HTTP front door and then stops the wrapped server."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 max_frame_bytes: int = codec.DEFAULT_MAX_FRAME_BYTES,
                 max_body_bytes: Optional[int] = None):
        self.server = server
        self._host = host
        self._port = int(port)
        self._max_frame_bytes = int(max_frame_bytes)
        # whole-body cap: a codec MESSAGE may span several frames (one
        # per feed array), so the body bound is a multiple of the
        # per-frame bound, not equal to it
        self._max_body_bytes = (
            int(max_body_bytes) if max_body_bytes is not None
            else 4 * self._max_frame_bytes + 65536)
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._shutdown_cb = None  # launch.py hooks /quitquitquit

    # ------------------------------------------------------------------
    @property
    def address(self) -> Optional[Tuple[str, int]]:
        return self._httpd.server_address if self._httpd is not None else None

    def _bind(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sp = self

        class _WireHandler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"  # keep-alive for pooled clients

            def log_message(self, *args):
                pass  # scrapes/requests stay out of stderr

            # -- plumbing ------------------------------------------------
            def _send(self, status: int, body: bytes, ctype: str,
                      extra_headers=None) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, doc, status: int = 200) -> None:
                self._send(status,
                           json.dumps(doc, sort_keys=True,
                                      default=str).encode("utf-8"),
                           "application/json")

            def _send_message(self, meta, arrays=(), status: int = 200,
                              extra_headers=None) -> None:
                body = codec.encode_message(meta, arrays)
                _SENT.inc(len(body))
                self._send(status, body, CONTENT_TYPE,
                           extra_headers=extra_headers)

            def _read_body(self) -> bytes:
                length = int(self.headers.get("Content-Length") or 0)
                if length > sp._max_body_bytes:
                    # reject WITHOUT reading — and drop the keep-alive
                    # connection, since the unread body would desync the
                    # next request on this socket
                    self.close_connection = True
                    raise WireProtocolError(
                        "request body of %d bytes exceeds the %d-byte "
                        "wire bound" % (length, sp._max_body_bytes))
                body = self.rfile.read(length)
                _RECV.inc(len(body))
                return body

            def _drain_body(self) -> None:
                """Consume a control POST's body so the HTTP/1.1
                keep-alive connection stays in sync for the client's
                next pooled request (an unread body would be parsed as
                the next request line)."""
                try:
                    self._read_body()
                except WireProtocolError:
                    pass  # close_connection already set

            # -- GET surfaces (health + admin) ---------------------------
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/healthz":
                        self._send_json(sp.healthz())
                    elif path == "/metrics":
                        om = "application/openmetrics-text" in (
                            self.headers.get("Accept") or "")
                        text, ctype = monitor.expose(openmetrics=om)
                        self._send(200, text.encode("utf-8"), ctype)
                    elif path == "/statusz":
                        self._send_json(sp.statusz())
                    elif path == "/tracez":
                        self._send_json(sp.server.tracez())
                    elif path == "/sloz":
                        self._send_json(_slo.sloz())
                    elif path == "/eventz":
                        self._send_json(_events.eventz())
                    else:
                        self.send_error(404, "unknown path")
                except Exception as e:  # noqa: BLE001 — typed to the peer
                    self._send_json({"error": type(e).__name__,
                                     "message": str(e)}, status=500)

            # -- POST surfaces (infer + control) -------------------------
            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path == "/infer":
                    self._do_infer()
                elif path == "/infer_stream":
                    self._do_infer_stream()
                elif path == "/warmup":
                    self._drain_body()
                    try:
                        compiles = sp.server.warmup()
                        self._send_message({"compiles": int(compiles)})
                    except Exception as e:  # noqa: BLE001
                        self._send_message(
                            {"error": type(e).__name__, "message": str(e)},
                            status=500)
                elif path == "/quitquitquit":
                    self._drain_body()
                    self._send_message({"ok": True, "draining": True})
                    threading.Thread(
                        target=sp._quit, name="wire-quit", daemon=True
                    ).start()
                else:
                    self.send_error(404, "unknown path")

            def _decode_infer_body(self):
                meta, arrays = codec.decode_message(
                    self._read_body(),
                    max_frame_bytes=sp._max_frame_bytes)
                feed_names = meta.get("feed_names")
                if (not isinstance(feed_names, list)
                        or len(feed_names) != len(arrays)):
                    raise WireProtocolError(
                        "feed_names/arrays mismatch: %r names, %d arrays"
                        % (feed_names, len(arrays)))
                return meta, dict(zip(feed_names, arrays))

            def _send_error_message(self, e: BaseException) -> None:
                """The one-message typed-error response (shared by
                /infer and a pre-stream /infer_stream failure)."""
                emeta = {"error": type(e).__name__, "message": str(e),
                         "load": sp._load_meta()}
                headers = None
                retry_ms = getattr(e, "retry_after_ms", None)
                if retry_ms is not None:
                    # the in-band channel carries the exact hint; the
                    # HTTP Retry-After header (whole seconds, ceil'd
                    # to stay >= the hint) is for generic tooling
                    emeta["retry_after_ms"] = float(retry_ms)
                    headers = {"Retry-After":
                               str(int(-(-float(retry_ms) // 1000)))}
                emeta["final"] = True  # a stream reader ends here too
                try:
                    self._send_message(
                        emeta, status=error_status(e),
                        extra_headers=headers)
                except Exception:
                    pass  # peer already gone; nothing to report to

            def _do_infer(self):
                _REQS.inc()
                try:
                    meta, feed = self._decode_infer_body()
                    rmeta, routs = sp._infer(
                        feed, meta.get("timeout_ms"),
                        traceparent=self.headers.get("traceparent"),
                        want_spans=self.headers.get("X-Wire-Spans") == "1",
                        priority=meta.get("priority"),
                        precision=meta.get("precision"))
                except BaseException as e:  # noqa: BLE001 — typed to the peer
                    self._send_error_message(e)
                    return
                self._send_message(rmeta, routs)

            # -- streaming (continuous-batching decode endpoints) --------
            def _write_chunk(self, payload: bytes) -> None:
                self.wfile.write(b"%x\r\n" % len(payload))
                self.wfile.write(payload)
                self.wfile.write(b"\r\n")

            def _do_infer_stream(self):
                """One decode request, answered as a CHUNKED stream of
                codec messages: one message per token chunk as the
                scheduler produces it (meta carries the trace id + a
                chunk sequence number), then one ``final`` message
                (completion, or the typed mid-stream error).  A
                pre-stream failure answers exactly like ``/infer`` —
                one typed-error message the stream reader also
                understands (``final`` set)."""
                _REQS.inc()
                try:
                    meta, feed = self._decode_infer_body()
                    req, tid = sp._submit_stream(
                        feed, meta,
                        traceparent=self.headers.get("traceparent"))
                except BaseException as e:  # noqa: BLE001 — typed to the peer
                    self._send_error_message(e)
                    return
                # headers commit here: everything after — including a
                # mid-stream failure — travels inside the chunked body
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                t0 = time.perf_counter()
                seq = 0
                err: Optional[BaseException] = None
                try:
                    try:
                        for tokens in req.stream():
                            payload = codec.encode_message(
                                {"trace_id": tid, "seq": seq}, (tokens,))
                            self._write_chunk(payload)
                            _SENT.inc(len(payload))
                            seq += 1
                    except BaseException as e:  # noqa: BLE001 — in-band
                        err = e
                    fmeta: Dict[str, object] = {
                        "final": True, "trace_id": tid, "chunks": seq,
                        "output_names":
                            list(sp.server._predictor.get_output_names()),
                        "load": sp._load_meta()}
                    if err is not None:
                        fmeta["error"] = type(err).__name__
                        fmeta["message"] = str(err)
                        retry_ms = getattr(err, "retry_after_ms", None)
                        if retry_ms is not None:
                            fmeta["retry_after_ms"] = float(retry_ms)
                    payload = codec.encode_message(fmeta)
                    self._write_chunk(payload)
                    _SENT.inc(len(payload))
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    # the peer hung up mid-stream: abandon the decode so
                    # its slot frees for queued work, and drop the (now
                    # desynced) connection
                    req.fail(ServerClosed("stream consumer went away"))
                    self.close_connection = True
                finally:
                    with _spans.trace_context((tid,)):
                        _spans.record_span(
                            "wire/server_stream", t0,
                            time.perf_counter() - t0, cat="wire",
                            chunks=seq, error=err is not None,
                            server=sp.server.name)

        class _QuietServer(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # a peer dropping its pooled connection (reset between
                # keep-alive requests, an abandoned stream) is a normal
                # event, not a server error worth a stderr traceback
                import sys

                etype = sys.exc_info()[0]
                if etype is not None and issubclass(
                        etype, (ConnectionError, BrokenPipeError)):
                    return
                super().handle_error(request, client_address)

        with self._lock:
            if self._httpd is None:
                self._httpd = _QuietServer(
                    (self._host, self._port), _WireHandler)
            return self._httpd

    # ------------------------------------------------------------------
    def healthz(self) -> Dict[str, object]:
        """Liveness + endpoint discovery: the balancer health-checks
        this and the remote client reads the feed/fetch names from it."""
        import os

        srv = self.server
        m = srv.metrics()
        return {
            "ok": srv.num_replicas > 0,
            "pid": os.getpid(),
            "server": srv.name,
            "warmed_up": bool(m.get("warmed_up")),
            "live_replicas": srv.num_replicas,
            "queue_depth": m.get("queue_depth"),
            "admit_limit": m.get("admit_limit"),
            "brownout_level": m.get("brownout_level"),
            "max_batch_size": srv.max_batch_size,
            "streaming": bool(getattr(srv, "supports_streaming", False)),
            # decode tier 2 discovery: the balancer's affinity routing
            # and the bench read whether this endpoint retains prefix KV
            # and/or carries a draft model (None on non-decode servers)
            "prefix_cache": (
                srv.prefix_cache.stats()
                if getattr(srv, "prefix_cache", None) is not None else None),
            "speculative_k": getattr(srv, "speculative_k", None),
            # a sharded backend is one MODEL-PARALLEL GROUP of devices
            # behind one address — the balancer routes to groups exactly
            # like single-chip replicas (in-flight accounting, warmup,
            # retirement unchanged)
            "sharded": bool(getattr(srv._predictor, "sharded", False)),
            # a pipelined backend is one pp-GROUP behind one address:
            # the balancer and bench read the stage count + structural
            # bubble ratio here (None on unpipelined endpoints)
            "pipeline": (
                srv._predictor.pipeline_stats()
                if callable(getattr(srv._predictor, "pipeline_stats",
                                    None)) else None),
            # mixed-precision discovery: the policy dtype this endpoint
            # serves by default (None = plain fp32) and every dtype a
            # request may ask for — clients and the bench read this
            # instead of guessing
            "precision": (getattr(srv, "_default_dtype", "fp32")
                          if getattr(srv, "_default_dtype", "fp32") != "fp32"
                          else None),
            "precision_dtypes": list(
                getattr(srv, "_precision_dtypes", ["fp32"])),
            # storage-dtype discovery: the decode pool's KV dtype and
            # the bound mesh tables' row dtype (None where the surface
            # doesn't apply) — fleet_top renders these as the dtype
            # column and capacity planners read them with the byte
            # gauges
            "kv_dtype": getattr(srv, "kv_dtype", None),
            "row_dtype": self._row_dtype(srv),
            "input_names": list(srv._feed_names),
            "output_names": list(srv._predictor.get_output_names()),
        }

    def statusz(self) -> Dict[str, object]:
        """The wrapped server's ``statusz()`` plus ``hand_kernels``, the
        hand-kernel launches of this process by dtype since its last
        ``kernels.reset_launch_counts()`` (diagnostic data only)."""
        from paddle_tpu_torch import kernels

        doc = dict(self.server.statusz())
        doc["hand_kernels"] = kernels.launch_counts_by_dtype()
        return doc

    @staticmethod
    def _row_dtype(srv) -> Optional[str]:
        """Row storage dtype of the served program's bound mesh tables
        (``bind_mesh_tables``), None when it has none."""
        program = getattr(getattr(srv, "_predictor", None),
                          "_program", None)
        runtime = getattr(program, "_mesh_tables", None)
        return getattr(runtime, "row_dtype", None)

    # ------------------------------------------------------------------
    def _infer(self, feed, timeout_ms, traceparent: Optional[str],
               want_spans: bool, priority=None, precision=None):
        """Bridge one wire request into the in-process server: install
        the remote trace context, submit, wait, and (tracing on) hand
        the server-side span tree back for the client-side merge.
        ``timeout_ms`` is the REMAINING deadline the client computed at
        send time; an already-expired one is shed typed at admission
        (``admission_expired_total``) by ``InferenceServer.submit``.
        ``priority`` rides the request meta into priority shedding;
        ``precision`` into the mixed-precision variant dispatch."""
        parsed = codec.parse_traceparent(traceparent)
        tid = parsed[0] if parsed else monitor.new_trace_id()
        remote_parent = parsed[1] if parsed else None
        kw = {}
        if priority is not None:
            kw["priority"] = int(priority)
        if precision is not None:
            kw["precision"] = str(precision)
        fr = _flight.get()
        rec = _spans.recording() or fr is not None
        if not rec:
            outs = self.server.submit(
                feed, timeout_ms=timeout_ms, trace_id=tid, **kw).result()
            return self._result_meta(tid), outs

        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        sid = _spans.new_span_id()
        try:
            with _spans.trace_context((tid,)):
                # this request span is the server-side root: its parent
                # is the CLIENT's wire span (from traceparent), and the
                # spans recorded downstream (queue wait via the request's
                # parent_span, batch/executor via the replica thread)
                # hang off it or off the batch tree
                with _spans.parent_scope(sid):
                    outs = self.server.submit(
                        feed, timeout_ms=timeout_ms, trace_id=tid,
                        parent_span=sid, **kw).result()
        except BaseException as e:  # noqa: BLE001 — observed, re-raised
            err = e
            raise
        finally:
            dur = time.perf_counter() - t0
            with _spans.trace_context((tid,)):
                _spans.record_span(
                    "wire/server_request", t0, dur, cat="wire",
                    span_id=sid, parent=remote_parent,
                    error=err is not None, server=self.server.name)
        meta = self._result_meta(tid)
        if want_spans and fr is not None:
            # the handler's own request span, as an explicit dict: the
            # batch pipeline files the OTHER server-side spans into the
            # flight record, but this one closes right here
            wire_span = {
                "name": "wire/server_request", "cat": "wire", "id": sid,
                "ts": _spans.wall_ts(t0), "dur": dur,
                "tid": threading.get_ident(), "trace_ids": [tid],
                "args": {"server": self.server.name},
            }
            if remote_parent:
                wire_span["parent"] = remote_parent
            # only requests tail sampling RETAINS are worth the grace
            # poll (this path is success-only — errors re-raised above);
            # a fast request under slow_ms will never grow a record, and
            # stalling its response would tax exactly the requests
            # sampling was built to leave untouched
            if dur * 1e3 >= fr.slow_ms:
                spans = self._collect_spans(fr, tid) or []
            else:
                rec_now = fr.get_record(tid)  # one check, no poll
                spans = (rec_now.get("spans") or []) if rec_now else []
            fr.add_span(tid, wire_span)  # local /tracez completeness
            meta["spans"] = list(spans) + [wire_span]
        return meta, outs

    def _submit_stream(self, feed, meta, traceparent: Optional[str]):
        """Bridge one wire stream request into the decode server:
        install the remote trace context and submit WITHOUT waiting —
        the handler streams the request's chunks as the scheduler
        produces them.  Returns ``(request, trace_id)``; every chunk
        message carries that one id, so the stream is a single trace
        end to end."""
        srv = self.server
        if not getattr(srv, "supports_streaming", False):
            raise ServingError(
                "endpoint %r does not stream (not a decode server)"
                % srv.name)
        parsed = codec.parse_traceparent(traceparent)
        tid = parsed[0] if parsed else monitor.new_trace_id()
        kw = {}
        if meta.get("priority") is not None:
            kw["priority"] = int(meta["priority"])
        if meta.get("max_new_tokens") is not None:
            kw["max_new_tokens"] = int(meta["max_new_tokens"])
        if meta.get("speculative"):
            kw["speculative"] = True
        with _spans.trace_context((tid,)):
            req = srv.submit(
                feed, timeout_ms=meta.get("timeout_ms"), trace_id=tid,
                **kw)
        return req, tid

    def _load_meta(self) -> Dict[str, object]:
        """The per-response load report (queue depth + adaptive admit
        limit + brownout level): the balancer folds it into least-loaded
        routing so a backlogged server stops attracting traffic even
        when its in-flight count looks fine from the outside."""
        load = getattr(self.server, "load", None)
        return load() if callable(load) else {}

    def _result_meta(self, tid: str) -> Dict[str, object]:
        return {"trace_id": tid,
                "output_names": list(self.server._predictor.get_output_names()),
                "load": self._load_meta()}

    @staticmethod
    def _collect_spans(fr, tid: str):
        """The retained server-side span tree for ``tid``, or None when
        the recorder didn't keep this request (see _SPAN_MERGE_POLLS)."""
        for i in range(_SPAN_MERGE_POLLS):
            rec = fr.get_record(tid)
            if rec is not None:
                return rec.get("spans") or []
            time.sleep(_SPAN_MERGE_POLL_S)
        return None

    def _quit(self) -> None:
        """Graceful exit for rolling replacement: drain, then unblock
        ``serve_forever``/the launch main."""
        try:
            self.stop(drain=True)
        finally:
            cb = self._shutdown_cb
            if cb is not None:
                cb()

    # ------------------------------------------------------------------
    def start(self) -> Tuple[str, int]:
        """Serve on a background thread; returns the bound address."""
        httpd = self._bind()
        if self._thread is None:
            self._thread = threading.Thread(
                target=httpd.serve_forever,
                name="wire-%s" % self.server.name, daemon=True)
            self._thread.start()
        return httpd.server_address

    def serve_forever(self) -> None:
        """Bind and serve on the CALLING thread (child-process main)."""
        self._bind().serve_forever()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Close the front door first (stop admitting wire requests),
        then stop the wrapped server — in-flight requests finish under
        ``drain=True``."""
        with self._lock:
            httpd, self._httpd = self._httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            # clear the serve thread too, or a later start() would bind
            # a fresh listener that nothing serves (connections accepted
            # into the backlog would hang)
            thread.join(timeout=5.0)
        self.server.stop(drain=drain, timeout=timeout)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop(drain=exc == (None, None, None))
        return False
