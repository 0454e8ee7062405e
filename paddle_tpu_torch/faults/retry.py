"""Shared retry policy: exponential backoff, full jitter, deadline-debited
budgets.

The reference stack retried RPCs with a bounded loop and a deadline
(grpc_client.cc); this repo grew three ad-hoc copies of that loop (the
fleet balancer's requeue countdown, the Communicator's push retry, the
PSClient connect loop).  ``RetryPolicy`` replaces them with one
semantics:

* **Exponential backoff with full jitter** — attempt *k* may sleep up
  to ``base * multiplier**(k-1)`` (capped at ``max_delay_s``), and the
  actual sleep is drawn uniformly from ``[0, that]`` ("full jitter",
  the AWS-architecture result: decorrelated retries don't re-storm the
  server that just failed).
* **A budget per request, debited against the remaining deadline** —
  ``policy.budget(deadline=...)`` hands out retries only while both the
  attempt count AND the caller's deadline have room; a retry whose
  backoff could not complete before the deadline is refused outright
  (fail fast with the real error, never burn the caller's last
  milliseconds sleeping).
* **Accounting** — every granted retry increments
  ``retry_attempts_total{op=...}`` after its backoff sleep.

Usage::

    policy = RetryPolicy(max_attempts=4, base_delay_s=0.05)
    budget = policy.budget(deadline=deadline, op="ps.pull")
    while True:
        try:
            return call()
        except TransientError:
            if not budget.backoff():
                raise
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional

from paddle_tpu_torch.faults.metrics import RETRY_ATTEMPTS

__all__ = ["RetryPolicy", "RetryBudget"]


class RetryPolicy:
    """Immutable retry shape; :meth:`budget` mints per-request state.

    ``max_attempts``: total call attempts allowed (1 = never retry);
    ``None`` = unbounded by count (deadline-bounded callers only).
    ``sleep``: injectable for tests (defaults to ``time.sleep``).
    ``seed``: seeds the jitter draw — chaos tests replay exactly.
    """

    def __init__(self, max_attempts: Optional[int] = 3,
                 base_delay_s: float = 0.05,
                 multiplier: float = 2.0,
                 max_delay_s: float = 2.0,
                 jitter: bool = True,
                 seed: Optional[int] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_attempts is not None and max_attempts < 1:
            raise ValueError("max_attempts must be >= 1 or None")
        self.max_attempts = max_attempts
        self.base_delay_s = float(base_delay_s)
        self.multiplier = float(multiplier)
        self.max_delay_s = float(max_delay_s)
        self.jitter = bool(jitter)
        self._seed = seed
        self._sleep = sleep

    def delay_bound(self, attempt: int) -> float:
        """Max sleep before retry number ``attempt`` (1-based)."""
        return min(self.max_delay_s,
                   self.base_delay_s * self.multiplier ** (attempt - 1))

    def budget(self, deadline: Optional[float] = None,
               op: str = "retry") -> "RetryBudget":
        """Per-request retry state.  ``deadline``: ``time.monotonic()``
        value the whole request must finish by."""
        return RetryBudget(self, deadline, op)


class RetryBudget:
    """The mutable half: one request's remaining retries.

    Not thread-safe — a budget belongs to one request on one thread,
    exactly like the deadline it debits against.
    """

    __slots__ = ("policy", "deadline", "op", "attempts", "_rng")

    def __init__(self, policy: RetryPolicy, deadline: Optional[float],
                 op: str):
        self.policy = policy
        self.deadline = deadline
        self.op = op
        self.attempts = 1  # the initial call is attempt #1
        self._rng = (random.Random(policy._seed)
                     if policy._seed is not None else random)

    def remaining_s(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return self.deadline - time.monotonic()

    def backoff(self) -> bool:
        """One failed attempt: sleep the jittered backoff and grant a
        retry (True), or refuse (False) because the attempt budget is
        spent or the remaining deadline cannot absorb the backoff —
        the caller re-raises its real error."""
        p = self.policy
        if p.max_attempts is not None and self.attempts >= p.max_attempts:
            return False
        delay = p.delay_bound(self.attempts)
        if p.jitter:
            delay = self._rng.uniform(0.0, delay)
        remaining = self.remaining_s()
        if remaining is not None and delay >= remaining:
            return False  # the deadline has no room for this retry
        if delay > 0:
            p._sleep(delay)
        self.attempts += 1
        RETRY_ATTEMPTS.labels(op=self.op).inc()
        return True

    def call(self, fn, retryable=(Exception,)):
        """Run ``fn`` under this budget: retry on ``retryable``, re-raise
        the last error when the budget refuses."""
        while True:
            try:
                return fn()
            except retryable:
                if not self.backoff():
                    raise
