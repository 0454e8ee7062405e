"""Dynamic-batching inference serving over AnalysisPredictor (port of
the JAX package's ``serving/``, one replica).

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
    "ServingError",
    "ServerOverloaded",
    "DeadlineExceeded",
    "ServerClosed",
    "WireProtocolError",
    "BackendUnavailable",
]
