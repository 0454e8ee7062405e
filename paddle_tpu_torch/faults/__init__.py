"""Fault tolerance: the shared retry policy (``faults/retry.py``) and its
counter (``faults/metrics.py``), the port's copies of the JAX package's.
The fault points (``faultpoint``, the ``ps.pull`` / ``ps.push`` /
``reader.prefetch`` sites) and the training checkpoints come with the
observability and faults slice (ROADMAP A9)."""
from paddle_tpu_torch.faults.retry import RetryBudget, RetryPolicy  # noqa: F401
