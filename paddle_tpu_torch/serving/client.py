"""In-process client helper over InferenceServer (port of the JAX
package's ``serving/client.py``: blocking single calls, scatter/gather
for many requests).  Request tracing comes with
the port's monitor slice."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from paddle_tpu_torch.serving.admission import PRIORITY_NORMAL

__all__ = ["Client"]


class Client:
    def __init__(self, server):
        self._server = server

    def infer(self, feed, timeout_ms: Optional[float] = None,
              priority: int = PRIORITY_NORMAL) -> List[np.ndarray]:
        """Submit one request and block for its outputs (list ordered
        like the predictor's fetch list)."""
        return self._server.submit(feed, timeout_ms=timeout_ms, priority=priority).result()

    def infer_many(self, feeds, timeout_ms: Optional[float] = None,
                   priority: int = PRIORITY_NORMAL) -> List[List[np.ndarray]]:
        """Submit every feed first (so they can coalesce into shared
        batches), then gather all results in order."""
        futures = [self._server.submit(f, timeout_ms=timeout_ms, priority=priority)
                   for f in feeds]
        return [f.result() for f in futures]
