"""Dynamic-batching inference serving over AnalysisPredictor, and
continuous-batching decode (the port of the JAX package's ``serving/``).

* ``InferenceServer`` + ``Client`` — one or more predictor replicas
  behind one queue, bucketed batches, deadlines, overload shedding, the
  brownout ladder (``BrownoutController``), precision variants, the
  ladder autotuner, the admin HTTP surface, graceful drain;
* ``serving.decode`` (lazy module) — ``DecodeServer``: token-level
  continuous batching over the KV slot pool (``serving.kv_pool``, CUDA
  graphs on the card), with the prefix KV cache, speculative decode and
  the int8 KV cache, streamed through ``Client.infer_stream``;
* ``serving.wire`` (lazy subpackage) — the cross-host tier: the codec,
  ``ServingProcess``, ``RemoteClient``, ``launch_server`` and the
  ``FleetBalancer`` over serving child processes;
* ``EmbeddingRowCache`` — the hot-id embedding row cache in front of the
  parameter server's lookups (brownout's cache-only rung);
* ``ServingMetrics`` — the per-server view over ``monitor``'s registry.

Quickstart::

    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    server = serving.InferenceServer(pred, max_batch_size=16)
    server.warmup()            # every rung and dtype on every replica
    out, = serving.Client(server).infer({"x": rows})
    server.stop(drain=True)
"""
from paddle_tpu_torch.serving.admission import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AdmissionQueue,
    BrownoutController,
)
from paddle_tpu_torch.serving.batching import DynamicBatcher, ServingRequest
from paddle_tpu_torch.serving.bucketing import BucketPolicy
from paddle_tpu_torch.serving.client import Client
from paddle_tpu_torch.serving.embedding_cache import EmbeddingRowCache
from paddle_tpu_torch.serving.errors import (
    BackendUnavailable,
    DeadlineExceeded,
    ServerClosed,
    ServerOverloaded,
    ServingError,
    WireProtocolError,
)
from paddle_tpu_torch.serving.metrics import ServingMetrics
from paddle_tpu_torch.serving.server import InferenceServer

__all__ = [
    "InferenceServer",
    "Client",
    "DynamicBatcher",
    "ServingRequest",
    "BucketPolicy",
    "AdmissionQueue",
    "BrownoutController",
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_LOW",
    "ServingMetrics",
    "EmbeddingRowCache",
    "ServingError",
    "ServerOverloaded",
    "DeadlineExceeded",
    "ServerClosed",
    "WireProtocolError",
    "BackendUnavailable",
    "decode",
    "wire",
]


def __getattr__(name):
    # the wire subpackage and the decode module are imported lazily: the
    # request-batching path does not pay their import (and their metric
    # registrations) unless the process uses them
    if name in ("wire", "decode"):
        import importlib

        mod = importlib.import_module("paddle_tpu_torch.serving." + name)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
