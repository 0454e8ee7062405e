"""Dynamic-batching inference serving over AnalysisPredictor, and
continuous-batching decode (the port of the JAX package's ``serving/``).

* ``InferenceServer`` (one replica) + ``Client`` — bucketed batches,
  deadlines, overload shedding, graceful drain;
* ``serving.decode`` (lazy module) — ``DecodeServer``: token-level
  continuous batching over the KV slot pool (``serving.kv_pool``, CUDA
  graphs on the card), with the prefix KV cache, speculative decode and
  the int8 KV cache, streamed through ``Client.infer_stream``;
* ``ServingMetrics`` — the per-server view over ``monitor``'s registry.

The wire layer (``serving.wire``, ``RemoteClient``) and
``EmbeddingRowCache`` come with the request-batching server's remainder
(ROADMAP A8b).

Quickstart::

    pred = create_paddle_predictor(AnalysisConfig(model_dir))
    server = serving.InferenceServer(pred, max_batch_size=16)
    server.warmup()            # runs every bucket rung once
    out, = serving.Client(server).infer({"x": rows})
    server.stop(drain=True)
"""
from paddle_tpu_torch.serving.admission import (
    PRIORITY_HIGH,
    PRIORITY_LOW,
    PRIORITY_NORMAL,
    AdmissionQueue,
)
from paddle_tpu_torch.serving.batching import DynamicBatcher, ServingRequest
from paddle_tpu_torch.serving.bucketing import BucketPolicy
from paddle_tpu_torch.serving.client import Client
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
    "PRIORITY_HIGH",
    "PRIORITY_NORMAL",
    "PRIORITY_LOW",
    "ServingMetrics",
    "ServingError",
    "ServerOverloaded",
    "DeadlineExceeded",
    "ServerClosed",
    "WireProtocolError",
    "BackendUnavailable",
    "decode",
]


def __getattr__(name):
    # the decode module is imported lazily: the request-batching path
    # does not pay the decode scheduler's import (and its metric
    # registrations) unless the process uses it
    if name == "decode":
        import importlib

        mod = importlib.import_module("paddle_tpu_torch.serving." + name)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
