"""Wire message codec: length-prefixed JSON + npy frames (the port's
copy of the JAX package's ``serving/wire/codec.py``: the frames are byte
for byte the same, so either package's client talks to either package's
server).

One wire message is::

    b"PTW1"                          magic (protocol/version)
    [b"J"][u32 len][json bytes]      exactly one meta frame, first
    [b"A"][u32 len][npy bytes] ...   zero or more array frames, in order
    [b"E"][u32 0]                    end frame

msgpack-free by design: the only dependencies are ``struct``, ``json``
and ``numpy.lib.format`` (the ``.npy`` serialization — dtype, shape and
byte order travel in the payload, so arbitrary dtype/shape/contiguity
round-trips exactly; pickle is never enabled).  Every read is BOUNDED:
a frame longer than ``max_frame_bytes``, more frames than
``max_frames``, a torn length prefix, or a missing end frame raises a
typed ``WireProtocolError`` instead of wedging the reader on a
malformed peer.

W3C ``traceparent`` helpers live here too — they are wire-format
encoding exactly like the frames: ``00-<32hex trace>-<16hex parent>-01``
carries the request's trace id and the client-side parent span id
across the process boundary, so the flight recorder can merge one span
tree per request (``monitor.spans`` parent ids).
"""
from __future__ import annotations

import io
import json
import re
import struct
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from paddle_tpu_torch.monitor import spans as _spans
from paddle_tpu_torch.serving.errors import WireProtocolError
from paddle_tpu_torch.serving.wire.metrics import WIRE_CODEC_SECONDS

__all__ = [
    "MAGIC", "DEFAULT_MAX_FRAME_BYTES", "DEFAULT_MAX_FRAMES",
    "encode_message", "decode_message", "read_message",
    "format_traceparent", "parse_traceparent",
]

MAGIC = b"PTW1"
_KIND_META = b"J"
_KIND_ARRAY = b"A"
_KIND_END = b"E"
_HEADER = struct.Struct("!cI")  # frame kind + payload length (network order)

DEFAULT_MAX_FRAME_BYTES = 1 << 28   # 256 MiB per frame
DEFAULT_MAX_FRAMES = 4096           # meta + arrays + end

_ENC = WIRE_CODEC_SECONDS.labels(op="encode")
_DEC = WIRE_CODEC_SECONDS.labels(op="decode")


def _codec_exemplar() -> Optional[Dict[str, str]]:
    """Exemplar linking a codec observation to the request being
    encoded/decoded: the calling thread's active trace context (a
    tuple read — free when no request attribution is live), so
    ``/metrics?openmetrics`` tails point into ``/tracez`` here exactly
    like the executor and serving-latency histograms."""
    ids = _spans.current_trace_ids()
    return {"trace_id": ids[0]} if ids else None


def encode_message(meta: Dict[str, object],
                   arrays: Sequence[np.ndarray] = ()) -> bytes:
    """Serialize one message.  ``meta`` must be JSON-serializable;
    ``arrays`` are positional (callers carry names in the meta — e.g.
    ``feed_names``/``output_names``).  Object-dtype arrays are refused
    (they would need pickle, which never crosses the wire)."""
    t0 = time.perf_counter()
    # hot-path: begin wire_encode (per-message serialization on the
    # request path; no blocking device sync, no sleeps)
    buf = io.BytesIO()
    buf.write(MAGIC)
    payload = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    buf.write(_HEADER.pack(_KIND_META, len(payload)))
    buf.write(payload)
    for arr in arrays:
        if getattr(arr, "dtype", None) is not None and arr.dtype.hasobject:
            raise WireProtocolError(
                "object-dtype arrays cannot cross the wire (no pickle)")
        abuf = io.BytesIO()
        try:
            np.lib.format.write_array(abuf, arr, allow_pickle=False)
        except (TypeError, ValueError) as e:
            raise WireProtocolError("unencodable array: %s" % e) from e
        payload = abuf.getvalue()
        buf.write(_HEADER.pack(_KIND_ARRAY, len(payload)))
        buf.write(payload)
    buf.write(_HEADER.pack(_KIND_END, 0))
    out = buf.getvalue()
    # hot-path: end wire_encode
    _ENC.observe(time.perf_counter() - t0, exemplar=_codec_exemplar())
    return out


def _read_exact(f, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes (bounded by the caller's frame checks);
    EOF mid-read is a typed truncation error, never a hang or a short
    silent result."""
    chunks: List[bytes] = []
    got = 0
    while got < n:
        chunk = f.read(n - got)
        if not chunk:
            raise WireProtocolError(
                "truncated %s: wanted %d bytes, got %d" % (what, n, got))
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


def read_message(f, max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                 max_frames: int = DEFAULT_MAX_FRAMES,
                 ) -> Tuple[Dict[str, object], List[np.ndarray]]:
    """Read one message from a binary file-like.  Every frame length is
    validated BEFORE its payload is read, so an adversarial length
    prefix costs nothing; a stream that ends before the end frame, or
    exceeds the frame/count bounds, raises ``WireProtocolError``."""
    t0 = time.perf_counter()
    # hot-path: begin wire_decode (per-message parse on the request path)
    magic = _read_exact(f, len(MAGIC), "magic")
    if magic != MAGIC:
        raise WireProtocolError("bad magic %r (want %r)" % (magic, MAGIC))
    meta: Optional[Dict[str, object]] = None
    arrays: List[np.ndarray] = []
    for _ in range(max_frames):
        kind, length = _HEADER.unpack(
            _read_exact(f, _HEADER.size, "frame header"))
        if kind == _KIND_END:
            if length != 0:
                raise WireProtocolError(
                    "end frame carries length %d" % length)
            if meta is None:
                raise WireProtocolError("message has no meta frame")
            break
        if length > max_frame_bytes:
            raise WireProtocolError(
                "oversized frame: %d bytes exceeds the %d-byte bound"
                % (length, max_frame_bytes))
        payload = _read_exact(f, length, "frame payload")
        if kind == _KIND_META:
            if meta is not None:
                raise WireProtocolError("duplicate meta frame")
            try:
                meta = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, ValueError) as e:
                raise WireProtocolError("undecodable meta: %s" % e) from e
            if not isinstance(meta, dict):
                raise WireProtocolError(
                    "meta frame must hold a JSON object, got %s"
                    % type(meta).__name__)
        elif kind == _KIND_ARRAY:
            try:
                arrays.append(np.lib.format.read_array(
                    io.BytesIO(payload), allow_pickle=False))
            except (ValueError, OSError) as e:
                raise WireProtocolError("undecodable array: %s" % e) from e
        else:
            raise WireProtocolError("unknown frame kind %r" % kind)
    else:
        raise WireProtocolError(
            "message exceeds %d frames without an end frame" % max_frames)
    # hot-path: end wire_decode
    _DEC.observe(time.perf_counter() - t0, exemplar=_codec_exemplar())
    return meta, arrays


def decode_message(data: bytes,
                   max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES,
                   max_frames: int = DEFAULT_MAX_FRAMES,
                   ) -> Tuple[Dict[str, object], List[np.ndarray]]:
    """``read_message`` over an in-memory buffer; trailing garbage after
    the end frame is rejected (one body, one message)."""
    buf = io.BytesIO(data)
    meta, arrays = read_message(buf, max_frame_bytes, max_frames)
    if buf.read(1):
        raise WireProtocolError("trailing bytes after end frame")
    return meta, arrays


# ---------------------------------------------------------------------------
# W3C trace context (https://www.w3.org/TR/trace-context/)
# ---------------------------------------------------------------------------
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def format_traceparent(trace_id: str, parent_span_id: str) -> str:
    """Render the ``traceparent`` header for one hop.  The repo's
    16-hex Dapper-style trace ids are left-padded to the W3C 32-hex
    field; the parent id is the CLIENT-side wire span's id, so the
    server records its request span as that span's child."""
    return "00-%s-%s-01" % (
        str(trace_id).rjust(32, "0")[:32],
        str(parent_span_id).rjust(16, "0")[:16])


def parse_traceparent(header: Optional[str]) -> Optional[Tuple[str, str]]:
    """``(trace_id, parent_span_id)`` from a ``traceparent`` header, or
    None when absent/malformed (a bad header degrades to a fresh local
    trace — never an error: trace plumbing must not fail requests).  A
    32-hex trace id that is a left-padded 16-hex repo id is returned in
    its native 16-hex form so both processes key the same record."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    _, trace32, parent, _ = m.groups()
    if trace32 == "0" * 32 or parent == "0" * 16:
        return None  # the spec's all-zero ids are invalid
    trace = trace32[16:] if trace32[:16] == "0" * 16 else trace32
    return trace, parent
