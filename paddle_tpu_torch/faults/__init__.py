"""Deterministic, process-global fault injection.

The port's copy of the JAX package's ``faults/``: the plans, their
``PADDLE_TPU_FAULTS`` grammar and their counters are the same, and the
shared retry policy (``faults/retry.py``) rides along.

The reference stack's fault-tolerance story (bounded RPC retry with
deadlines in grpc_client.cc, checkpoint-notify for PS tables, trainer
restart from persistables) was only ever exercised by real outages; the
rebuild injects the failures on purpose.  A **fault point**
is a named site in a real code path::

    # at the site (hot path: one is-None gate when disarmed)
    from paddle_tpu_torch import faults as _faults
    ...
    if _faults.active is not None:
        _faults.active.faultpoint("wire.send")

and a **plan** is a seeded, declarative list of what each point should
do when hit: raise a typed error, sleep, corrupt bytes (the caller
applies the returned action), drop the first N hits then heal, or
SIGKILL a child process whose pid the site passes.  Armed via the API
(:func:`arm` / :func:`armed`) or the ``PADDLE_TPU_FAULTS`` env var so a
launched child process can arrive pre-armed::

    PADDLE_TPU_FAULTS="wire.send=corrupt,times=2;ps.pull=delay:0.05"

Contracts the rest of the framework relies on:

* **Disarmed cost is one is-None gate.**  ``faults.active`` is a plain
  module attribute, ``None`` unless a plan is armed; no function call,
  no lock, no lookup happens on the disarmed path
  (``paddle_tpu_torch.tools.check_hot_path`` still holds).
* **Determinism.**  Every probabilistic decision draws from a
  ``random.Random`` seeded from ``(plan seed, point name)``; two plans
  with the same seed fire identically.  Counters (``after``/``times``)
  are exact, under one lock.
* **Observability.**  Every fired injection increments
  ``faults_injected_total{point=...}`` and the plan's own
  ``triggers()`` dict, so a chaos test can assert exactly what landed.

The catalog of fault points threaded through the framework lives in
the README's port section ("Fault tolerance"); ``python -m
paddle_tpu_torch.tools.check_fault_points`` holds source, docs, and the
tests to the same set.
"""
from __future__ import annotations

import os
import random
import re
import signal
import threading
import time
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.faults.metrics import FAULTS_INJECTED

__all__ = [
    "FaultSpec", "FaultAction", "FaultPlan",
    "arm", "disarm", "armed", "arm_from_env", "parse_plan",
    "active",
]

# the one global the gates check: None = disarmed (never a stale plan)
active: Optional["FaultPlan"] = None

_POINT_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")

_MODES = ("error", "delay", "corrupt", "kill")


def _resolve_error(name: str):
    """Error-type lookup for ``error:`` specs: the typed serving errors
    first, then a small builtin whitelist — never eval."""
    from paddle_tpu_torch.serving import errors as _serr

    if hasattr(_serr, name):
        return getattr(_serr, name)
    builtin = {
        "RuntimeError": RuntimeError,
        "ValueError": ValueError,
        "ConnectionError": ConnectionError,
        "ConnectionResetError": ConnectionResetError,
        "TimeoutError": TimeoutError,
        "OSError": OSError,
        "IOError": IOError,
    }
    if name in builtin:
        return builtin[name]
    raise ValueError("unknown fault error type %r" % name)


class FaultSpec:
    """One declarative injection: WHAT happens at WHICH point, WHEN.

    ``mode``: ``error`` (raise ``error_type``), ``delay`` (sleep
    ``delay_s`` then continue), ``corrupt`` (return a
    :class:`FaultAction` the site applies to its bytes), ``kill``
    (SIGKILL the pid the site passed as context).
    ``after``: skip the first N hits of the point (arm mid-traffic).
    ``times``: fire at most N times, then heal (drop-N-then-heal).
    ``prob``: fire with this seeded probability per eligible hit.
    """

    __slots__ = ("point", "mode", "error_type", "delay_s", "after",
                 "times", "prob", "message", "hits", "fired")

    def __init__(self, point: str, mode: str,
                 error: str = "BackendUnavailable",
                 delay_s: float = 0.0,
                 after: int = 0, times: Optional[int] = None,
                 prob: float = 1.0, message: Optional[str] = None):
        if not _POINT_RE.match(point):
            raise ValueError("invalid fault point name %r" % point)
        if mode not in _MODES:
            raise ValueError("fault mode %r not in %s" % (mode, _MODES))
        self.point = point
        self.mode = mode
        self.error_type = _resolve_error(error) if mode == "error" else None
        self.delay_s = float(delay_s)
        self.after = int(after)
        self.times = None if times is None else int(times)
        self.prob = float(prob)
        self.message = message
        self.hits = 0   # eligible matches seen (post-`after`)
        self.fired = 0  # injections actually delivered

    def __repr__(self):
        return ("FaultSpec(%s=%s, after=%d, times=%s, prob=%g, "
                "hits=%d, fired=%d)" % (
                    self.point, self.mode, self.after, self.times,
                    self.prob, self.hits, self.fired))


class FaultAction:
    """A caller-applied injection (mode=``corrupt``): the site hands its
    outbound bytes through :meth:`corrupt` and sends the mangled copy —
    simulating on-the-wire corruption without touching the socket."""

    __slots__ = ("spec", "_rng")

    def __init__(self, spec: FaultSpec, rng: random.Random):
        self.spec = spec
        self._rng = rng

    def corrupt(self, data: bytes) -> bytes:
        """Flip the leading byte (framing magic — the corruption is
        GUARANTEED to be detectable as a protocol violation, never a
        silent payload mutation) plus a seeded handful elsewhere."""
        if not data:
            return data
        buf = bytearray(data)
        buf[0] ^= 0xFF
        for _ in range(min(4, len(buf) // 256)):
            i = self._rng.randrange(len(buf))
            buf[i] ^= 0xFF
        return bytes(buf)


class FaultPlan:
    """An armed set of :class:`FaultSpec` — what :data:`active` points at.

    ``faultpoint(name, **ctx)`` is the single entry every site calls
    once its is-None gate passed: it matches the specs for ``name`` in
    order, applies deterministic ``after``/``times``/``prob`` arming,
    then performs the injection (sleep, raise, kill) or returns the
    :class:`FaultAction` for caller-applied modes.  Returns ``None``
    when nothing fired.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.seed = int(seed)
        self._specs: Dict[str, List[FaultSpec]] = {}
        for s in specs:
            self._specs.setdefault(s.point, []).append(s)
        self._rngs: Dict[str, random.Random] = {
            point: random.Random((self.seed, point).__repr__())
            for point in self._specs
        }
        self._lock = threading.Lock()

    @property
    def points(self) -> List[str]:
        return sorted(self._specs)

    def triggers(self) -> Dict[str, int]:
        """Fired-injection counts per point (the plan-local view of
        ``faults_injected_total``)."""
        with self._lock:
            return {
                point: sum(s.fired for s in specs)
                for point, specs in self._specs.items()
            }

    # ------------------------------------------------------------------
    def faultpoint(self, name: str, **ctx) -> Optional[FaultAction]:
        """One hit of fault point ``name``.  May sleep, raise, or kill;
        returns a :class:`FaultAction` for caller-applied modes."""
        specs = self._specs.get(name)
        if not specs:
            return None
        rng = self._rngs[name]
        action: Optional[FaultAction] = None
        to_raise = None
        delay = 0.0
        kill_pid = None
        with self._lock:
            for s in specs:
                s.hits += 1
                if s.hits <= s.after:
                    continue
                if s.times is not None and s.fired >= s.times:
                    continue  # healed
                if s.prob < 1.0 and rng.random() >= s.prob:
                    continue
                s.fired += 1
                FAULTS_INJECTED.labels(point=name).inc()
                if s.mode == "delay":
                    delay += s.delay_s
                elif s.mode == "error":
                    to_raise = s.error_type(
                        s.message
                        or "injected fault at %r (%s)"
                        % (name, s.error_type.__name__))
                elif s.mode == "corrupt":
                    action = FaultAction(s, rng)
                elif s.mode == "kill":
                    kill_pid = ctx.get("pid")
        if delay > 0:
            time.sleep(delay)
        if kill_pid is not None:
            try:
                os.kill(int(kill_pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass  # already gone: the failure it simulates anyway
        if to_raise is not None:
            raise to_raise
        return action


# ---------------------------------------------------------------------------
# arming
# ---------------------------------------------------------------------------
def arm(specs, seed: int = 0) -> FaultPlan:
    """Install ``specs`` (FaultSpec list, spec-string, or a prebuilt
    plan) as the process-global plan and return it."""
    global active
    if isinstance(specs, FaultPlan):
        plan = specs
    elif isinstance(specs, str):
        plan = parse_plan(specs, seed=seed)
    else:
        plan = FaultPlan(list(specs), seed=seed)
    active = plan
    return plan


def disarm() -> None:
    """Remove the global plan (the gates go back to one is-None check)."""
    global active
    active = None


class _Armed:
    """``with faults.armed("..."):`` — arm for a scope, always disarm."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return self.plan

    def __exit__(self, *exc):
        disarm()
        return False


def armed(specs, seed: int = 0) -> _Armed:
    """Context-manager form of :func:`arm` (tests: injection can never
    leak past the ``with`` block, even on assertion failure)."""
    return _Armed(arm(specs, seed=seed))


# ---------------------------------------------------------------------------
# the PADDLE_TPU_FAULTS grammar
# ---------------------------------------------------------------------------
def parse_plan(text: str, seed: int = 0) -> FaultPlan:
    """``point=mode[:arg][,key=val...]`` entries joined by ``;``.

    * ``wire.send=error:ConnectionError,times=2``
    * ``ps.pull=delay:0.05,after=3``
    * ``wire.send=corrupt,times=1`` / ``fleet.dispatch=kill,after=10``
    * a ``seed=N`` entry sets the plan seed (env arming determinism).
    """
    specs: List[FaultSpec] = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if entry.startswith("seed="):
            seed = int(entry[5:])
            continue
        point, _, rhs = entry.partition("=")
        if not rhs:
            raise ValueError("fault entry %r has no '=mode'" % entry)
        parts = rhs.split(",")
        mode, _, arg = parts[0].partition(":")
        kw: Dict[str, object] = {}
        if mode == "error" and arg:
            kw["error"] = arg
        elif mode == "delay":
            kw["delay_s"] = float(arg or 0.01)
        elif arg:
            raise ValueError("mode %r takes no ':' argument" % mode)
        for opt in parts[1:]:
            k, _, v = opt.partition("=")
            k = k.strip()
            if k == "times":
                kw["times"] = int(v)
            elif k == "after":
                kw["after"] = int(v)
            elif k == "prob":
                kw["prob"] = float(v)
            elif k == "message":
                kw["message"] = v
            else:
                raise ValueError("unknown fault option %r" % k)
        specs.append(FaultSpec(point.strip(), mode.strip(), **kw))
    return FaultPlan(specs, seed=seed)


def arm_from_env(env: Optional[Dict[str, str]] = None) -> Optional[FaultPlan]:
    """Arm from ``PADDLE_TPU_FAULTS`` (``PADDLE_TPU_FAULTS_SEED`` sets
    the seed); returns the plan or None when the var is unset/empty.
    Called once at import so a launched child arrives pre-armed."""
    env = env if env is not None else os.environ
    text = env.get("PADDLE_TPU_FAULTS", "").strip()
    if not text:
        return None
    seed = int(env.get("PADDLE_TPU_FAULTS_SEED", "0"))
    return arm(parse_plan(text, seed=seed))


arm_from_env()

from paddle_tpu_torch.faults.retry import RetryBudget, RetryPolicy  # noqa: E402,F401
