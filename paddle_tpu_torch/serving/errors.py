"""Typed serving errors (own copy of the JAX package's ``serving/errors.py``).

The admission-control / deadline / lifecycle contract is error-typed so
callers can distinguish "retry later" (ServerOverloaded), "client gave
up" (DeadlineExceeded), and "stop sending" (ServerClosed) without
string-matching — the Clipper/Orca-style front-end contract the
reference stack leaves to the external serving system.
"""
from __future__ import annotations

__all__ = [
    "ServingError",
    "ServerOverloaded",
    "DeadlineExceeded",
    "ServerClosed",
    "WireProtocolError",
    "BackendUnavailable",
    "RelaunchFailed",
]


class ServingError(RuntimeError):
    """Base class for all serving-layer errors."""


class ServerOverloaded(ServingError):
    """Admission control shed this request: the bounded request queue is
    at its (adaptive) limit and no lower-priority entry could be evicted
    to make room, or the brownout ladder is shedding this priority
    class.  The request was NOT enqueued (or was evicted before any
    work ran); back off and retry.

    ``retry_after_ms`` is the server's computed backoff hint (EWMA queue
    wait scaled by the overload ratio).  It rides the wire as response
    meta (and an HTTP ``Retry-After`` header), and the fleet balancer's
    retry pacing honors it — a shedding backend is not re-dispatched to
    before the hint elapses."""

    def __init__(self, message: str = "server overloaded",
                 retry_after_ms: "float | None" = None):
        super().__init__(message)
        self.retry_after_ms = (
            float(retry_after_ms) if retry_after_ms is not None else None)


class DeadlineExceeded(ServingError, TimeoutError):
    """The request's deadline expired before a result was produced —
    either while queued (the server sheds it instead of running stale
    work) or while the client waited on the future."""


class ServerClosed(ServingError):
    """The server is shutting down (or already stopped) and no longer
    admits new requests."""


class WireProtocolError(ServingError):
    """A wire message violated the framing/codec contract (bad magic,
    truncated frame, oversized frame, unknown frame kind, undecodable
    payload).  Raised by the codec's BOUNDED reads, so a malformed or
    malicious peer surfaces as a typed per-request failure instead of
    wedging a server process on an unbounded read."""


class BackendUnavailable(ServingError):
    """The wire transport could not complete the exchange with the
    remote process (connection refused/reset, half-written response —
    the process died or the network dropped).  The RETRYABLE failure
    class: the front-end balancer re-routes the request to a surviving
    backend, exactly as the in-process fleet requeues a batch off a dead
    replica thread."""


class RelaunchFailed(ServingError):
    """The supervisor gave up reviving a crash-looping serving child:
    every relaunch attempt inside its capped-backoff budget failed.  The
    backend stays retired; an operator (or a replacement launch) has to
    intervene — the supervisor will not relaunch-storm a child that
    cannot come up."""
