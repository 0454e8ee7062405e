"""Distributed runtime: the parameter server (reference:
paddle/fluid/operators/distributed/, gRPC/BRPC parameter-server RPC).

The port's own copies of the JAX package's ``distributed/ps.py``,
``communicator.py`` and ``lookup.py``.  The process launcher
(``launch.py``) comes with the multi-device slice (ROADMAP A10).
"""
from paddle_tpu_torch.distributed.communicator import Communicator, GeoSGD  # noqa: F401
from paddle_tpu_torch.distributed.lookup import bind_distributed_tables  # noqa: F401
from paddle_tpu_torch.distributed.ps import ParameterServer, PSClient  # noqa: F401
