"""paddle_tpu_torch.serving.wire — cross-host serving (the port of the JAX
package's ``serving/wire/``; the frames are byte for byte its frames).

The network edge over the in-process serving stack: the same
batching/bucketing/zero-recompile server, now reachable across the
process (and host) boundary.

* ``codec`` — msgpack-free length-prefixed JSON+npy message framing
  with BOUNDED reads (typed ``WireProtocolError`` on malformed peers)
  and the W3C ``traceparent`` helpers;
* ``Transport`` / ``HttpTransport`` (``http.py``) — the transport ABC
  seam (gRPC slots in later) and the stdlib-HTTP implementation with
  per-thread keep-alive;
* ``RemoteClient`` (``client.py``) — the in-process ``Client`` surface
  over a wire hop: same signatures, same typed errors, trace ids
  carried in ``traceparent`` and the server-side span tree merged into
  the local flight recorder;
* ``ServingProcess`` (``server.py``) — one ``InferenceServer`` behind
  the wire: ``/infer`` + ``/warmup`` + ``/healthz`` + the admin surface
  (``/metrics`` ``/statusz`` ``/tracez``) + ``/quitquitquit``;
* ``launch_server`` / ``ServerHandle`` (``launch.py``) — child-process
  spawning with a race-free ready handshake;
* ``FleetBalancer`` (``fleet.py``) — the front-end: least-loaded
  routing over N serving processes, retirement + requeue-to-survivor
  (accepted requests never drop), active health checks, fleet-wide
  warmup, rolling replica replacement.

Quickstart::

    from paddle_tpu_torch.serving import wire

    fleet = wire.FleetBalancer.from_launch(model_dir, n=4)
    fleet.warmup()                      # every rung, every process
    out, = fleet.infer({"x": rows})     # least-loaded backend
    fleet.rolling_replace()             # zero-downtime restart
    fleet.stop(shutdown_backends=True)
"""
from paddle_tpu_torch.serving.errors import BackendUnavailable, WireProtocolError
from paddle_tpu_torch.serving.wire import codec, metrics
from paddle_tpu_torch.serving.wire.client import RemoteClient
from paddle_tpu_torch.serving.wire.codec import (
    decode_message,
    encode_message,
    format_traceparent,
    parse_traceparent,
)
from paddle_tpu_torch.serving.wire.fleet import FleetBalancer
from paddle_tpu_torch.serving.wire.http import HttpTransport, Transport
from paddle_tpu_torch.serving.wire.launch import ServerHandle, launch_server
from paddle_tpu_torch.serving.wire.server import ServingProcess

__all__ = [
    "codec", "metrics",
    "encode_message", "decode_message",
    "format_traceparent", "parse_traceparent",
    "Transport", "HttpTransport",
    "RemoteClient", "ServingProcess",
    "ServerHandle", "launch_server",
    "FleetBalancer",
    "WireProtocolError", "BackendUnavailable",
]
