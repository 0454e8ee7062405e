"""Launch and manage serving child processes (the port's copy of the JAX
package's ``serving/wire/launch.py``).

``launch_server()`` spawns ``python -m paddle_tpu_torch.serving.wire.launch``
as a detached child: the child loads the saved inference model on its
place (``cuda:0`` unless the caller asks for the CPU), builds an
``InferenceServer`` (optionally multi-replica), binds a
``ServingProcess`` on an ephemeral port, and announces readiness by
printing one ``WIRE_READY {json}`` line on stdout — the parent learns
the bound port without a port-assignment race.  The returned
``ServerHandle`` is the management surface the fleet balancer (and
tests) drive: health probes, graceful shutdown (``/quitquitquit``
drain), and hard kill (the lost-process failure mode the requeue
machinery must survive).

This is the reference stack's ``fluid.distributed.launch`` idea applied
to serving: processes, not threads, are the unit of replication, so a
crash takes out one ladder of cached entries and graphs — not the fleet.

Kernels: each child loads the hand kernels from
``paddle_tpu_torch/_build/``.  On a tree where they are not built yet,
every child that finds no library compiles its own copy (``nvcc``,
inside ``ready_timeout_s``; ``kernels/build.py`` writes to a per-pid
temporary file and renames it, so concurrent children stay correct).
Build them once in the parent first (``kernels.build.build()``) to
launch warm.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["ServerHandle", "launch_server", "relaunch", "Supervisor",
           "main"]

READY_PREFIX = "WIRE_READY "


class ServerHandle:
    """One launched serving child: its process + wire address."""

    def __init__(self, proc: subprocess.Popen, host: str, port: int,
                 name: str, spec: Optional[Dict[str, object]] = None):
        self.proc = proc
        self.host = host
        self.port = int(port)
        self.name = name
        self.spec = dict(spec or {})  # relaunch recipe (rolling replace)

    # ------------------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def poll(self) -> Optional[int]:
        return self.proc.poll()

    def healthz(self, timeout_s: float = 5.0) -> Dict[str, object]:
        from paddle_tpu_torch.serving.wire.http import HttpTransport

        t = HttpTransport(self.host, self.port, timeout_s=timeout_s)
        try:
            return t.get_json("/healthz", timeout_s=timeout_s)
        finally:
            t.close()

    def warmup(self, timeout_s: float = 600.0) -> int:
        from paddle_tpu_torch.serving.wire.client import raise_in_band_error
        from paddle_tpu_torch.serving.wire.http import HttpTransport

        t = HttpTransport(self.host, self.port, timeout_s=timeout_s)
        try:
            meta, _ = t.request("/warmup", {}, (), timeout_s=timeout_s)
            raise_in_band_error(meta)
            return int(meta.get("compiles", 0))
        finally:
            t.close()

    # ------------------------------------------------------------------
    def shutdown(self, timeout_s: float = 30.0) -> Optional[int]:
        """Graceful: ask the child to drain and exit; escalate to
        terminate/kill only when the deadline passes."""
        from paddle_tpu_torch.serving.errors import ServingError
        from paddle_tpu_torch.serving.wire.http import HttpTransport

        if self.proc.poll() is None:
            t = HttpTransport(self.host, self.port, timeout_s=5.0)
            try:
                t.request("/quitquitquit", {}, (), timeout_s=5.0)
            except ServingError:
                pass  # already gone/unreachable: fall through to wait
            finally:
                t.close()
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.terminate()
            try:
                return self.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                self.kill()
                return self.proc.wait(timeout=5.0)

    def terminate(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()

    def kill(self) -> None:
        """Hard kill — the crash the balancer's requeue path must eat."""
        if self.proc.poll() is None:
            self.proc.kill()

    def wait(self, timeout_s: Optional[float] = None) -> Optional[int]:
        return self.proc.wait(timeout=timeout_s)


def _drain_stdout(proc: subprocess.Popen) -> None:
    """Keep reading the child's stdout after READY so a chatty child
    can never block on a full pipe (stderr has its own bounded
    collector from launch time)."""
    try:
        for _ in proc.stdout:
            pass
    except Exception:
        pass


def launch_server(
    model_dir: str,
    host: str = "127.0.0.1",
    port: int = 0,
    name: str = "wire",
    replicas: int = 1,
    max_batch_size: int = 32,
    batch_timeout_ms: float = 5.0,
    queue_capacity: int = 256,
    warmup: bool = False,
    flight_slow_ms: Optional[float] = None,
    ready_timeout_s: float = 180.0,
    env: Optional[Dict[str, str]] = None,
    pipeline_stages: Optional[int] = None,
    place: Optional[str] = None,
    target_queue_wait_ms: Optional[float] = None,
) -> ServerHandle:
    """Spawn one serving child process and wait for its READY line.

    ``flight_slow_ms``: install a flight recorder in the child at this
    tail-sampling threshold (0 retains everything) — required for the
    cross-process span merge; omitted, the child pays zero tracing rent.
    A child that exits (or stays silent) before READY raises with its
    captured stderr tail, never hangs the parent.

    ``place``: where the child serves — ``None`` (the default) is the
    card, ``cuda:0``, and a child that cannot get it exits before READY,
    so this call raises with its stderr tail (the child never falls back
    to the CPU); ``"cpu"`` serves on the CPU
    (``AnalysisConfig.disable_gpu()``, or ``load_decode_endpoint(place=
    CPUPlace())`` for a decode endpoint).

    ``target_queue_wait_ms``: the child ``InferenceServer``'s AIMD
    queue-wait target (its default when None), so that a child can be
    configured as an in-process server it is compared with.

    ``pipeline_stages`` (a ``PipelinePredictor`` group inside the child)
    comes with ROADMAP A10 part 3 and raises here, before anything is spawned."""
    if pipeline_stages is not None:
        raise NotImplementedError(
            "launch_server(pipeline_stages=) serves a PipelinePredictor, which "
            "comes with ROADMAP A10 part 3 (the pipelined programs)")
    if place not in (None, "cpu", "cuda:0"):
        raise ValueError("place must be None, 'cuda:0' or 'cpu', got %r" % (place,))
    spec = {
        "model_dir": model_dir, "host": host, "port": port, "name": name,
        "replicas": replicas, "max_batch_size": max_batch_size,
        "batch_timeout_ms": batch_timeout_ms,
        "queue_capacity": queue_capacity, "warmup": warmup,
        "flight_slow_ms": flight_slow_ms,
        "place": place, "target_queue_wait_ms": target_queue_wait_ms,
    }
    argv = [
        sys.executable, "-m", "paddle_tpu_torch.serving.wire.launch",
        "--model-dir", model_dir, "--host", host, "--port", str(port),
        "--name", name, "--replicas", str(replicas),
        "--max-batch-size", str(max_batch_size),
        "--batch-timeout-ms", str(batch_timeout_ms),
        "--queue-capacity", str(queue_capacity),
    ]
    if warmup:
        argv.append("--warmup")
    if flight_slow_ms is not None:
        argv += ["--flight-slow-ms", str(flight_slow_ms)]
    if place is not None:
        argv += ["--place", place]
    if target_queue_wait_ms is not None:
        argv += ["--target-queue-wait-ms", str(target_queue_wait_ms)]
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    # the child must import paddle_tpu_torch from THIS checkout (it is not
    # installed); prepend, never clobber, any caller PYTHONPATH
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    prev = child_env.get("PYTHONPATH")
    child_env["PYTHONPATH"] = (
        repo_root + os.pathsep + prev if prev else repo_root)
    proc = subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=child_env)
    # stderr drains from the FIRST moment on its own thread into a
    # bounded tail buffer: a child whose model load logs more than the
    # OS pipe buffer pre-READY must not deadlock on a full pipe (and
    # the tail is the diagnostic the failure path reports)
    err_tail: List[str] = []

    def _collect_stderr():
        try:
            for line in proc.stderr:
                err_tail.append(line)
                if len(err_tail) > 200:
                    del err_tail[:100]
        except Exception:
            pass

    threading.Thread(target=_collect_stderr, name="wire-stderr",
                     daemon=True).start()
    # the READY scan runs on a thread too: a silent/hung child must trip
    # the parent's DEADLINE, not park it on a blocking readline forever
    box: Dict[str, object] = {}
    seen = threading.Event()

    def _scan():
        try:
            for line in proc.stdout:
                if line.startswith(READY_PREFIX):
                    box["ready"] = json.loads(line[len(READY_PREFIX):])
                    seen.set()
                    return
                # pre-ready chatter (build logs etc.): ignore
        except Exception as e:  # noqa: BLE001 — surfaced via the waiter
            box["scan_error"] = repr(e)
        seen.set()  # EOF: the child died before READY — wake the waiter

    threading.Thread(target=_scan, name="wire-ready-scan",
                     daemon=True).start()
    if not seen.wait(ready_timeout_s):
        proc.kill()
        raise RuntimeError(
            "serving child %r never reported ready within %.0fs:\n%s"
            % (name, ready_timeout_s, "".join(err_tail)[-4000:]))
    ready = box.get("ready")
    if ready is None:
        # kill FIRST: the collected tail is already in memory, and a
        # blocking stderr read on a still-live child would hang here
        proc.kill()
        raise RuntimeError(
            "serving child %r failed before ready (rc=%s, scan=%s):\n%s"
            % (name, proc.poll(), box.get("scan_error"),
               "".join(err_tail)[-4000:]))
    threading.Thread(target=_drain_stdout, args=(proc,),
                     daemon=True).start()
    return ServerHandle(proc, ready["host"], ready["port"], name, spec=spec)


def relaunch(handle: ServerHandle, port: int = 0) -> ServerHandle:
    """Launch a FRESH child from an existing handle's recipe (rolling
    replacement; the new child gets its own ephemeral port)."""
    spec = dict(handle.spec)
    if not spec:
        raise ValueError(
            "handle %r carries no launch spec (constructed from a bare "
            "address?) — cannot relaunch" % handle.name)
    spec["port"] = port
    return launch_server(**spec)


class Supervisor:
    """Relaunch crash-looped serving children with capped backoff.

    The re-admission story's last resort: a retired backend whose
    PROCESS is gone cannot pass a half-open probe, so the balancer hands
    its handle here.  ``revive()`` retries :func:`relaunch` under a
    ``RetryPolicy`` budget (exponential backoff, capped at
    ``max_delay_s``, full jitter) and gives up with a typed
    ``RelaunchFailed`` after ``max_attempts`` — a child that dies on
    every boot must not be relaunch-stormed forever.  Every attempt
    (successful or not) increments
    ``wire_backend_relaunches_total{fleet=...}``.

    ``sleep`` is injectable so crash-loop tests run in milliseconds.
    """

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.5,
                 max_delay_s: float = 10.0, multiplier: float = 2.0,
                 fleet: str = "supervisor", sleep=None):
        import time as _time

        from paddle_tpu_torch.faults.retry import RetryPolicy

        self.fleet = fleet
        self._policy = RetryPolicy(
            max_attempts=max(1, int(max_attempts)),
            base_delay_s=base_delay_s, multiplier=multiplier,
            max_delay_s=max_delay_s,
            sleep=sleep if sleep is not None else _time.sleep)

    def revive(self, handle: ServerHandle, port: int = 0) -> ServerHandle:
        """A fresh, READY child from ``handle``'s launch spec, or a
        ``RelaunchFailed`` chaining the last boot error."""
        from paddle_tpu_torch.serving.errors import RelaunchFailed
        from paddle_tpu_torch.serving.wire.metrics import WIRE_BACKEND_RELAUNCHES

        relaunches = WIRE_BACKEND_RELAUNCHES.labels(fleet=self.fleet)
        budget = self._policy.budget(op="wire.relaunch")
        last: Exception
        while True:
            relaunches.inc()
            try:
                return relaunch(handle, port=port)
            except Exception as e:  # noqa: BLE001 — typed give-up below
                last = e
            if not budget.backoff():
                raise RelaunchFailed(
                    "giving up on child %r after %d relaunch attempt(s): %r"
                    % (handle.name, budget.attempts, last)) from last


# ---------------------------------------------------------------------------
# child-process main
# ---------------------------------------------------------------------------
def _place(name: Optional[str]):
    """The ``fluid`` place of a ``--place`` value (None: the card)."""
    if name == "cpu":
        from paddle_tpu_torch.framework import CPUPlace

        return CPUPlace()
    return None


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        description="paddle_tpu_torch serving child process")
    parser.add_argument("--model-dir", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--name", default="wire")
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--max-batch-size", type=int, default=32)
    parser.add_argument("--batch-timeout-ms", type=float, default=5.0)
    parser.add_argument("--queue-capacity", type=int, default=256)
    parser.add_argument("--warmup", action="store_true")
    parser.add_argument("--flight-slow-ms", type=float, default=None)
    parser.add_argument("--place", default=None,
                        help="cpu, or the card (cuda:0) when not given")
    parser.add_argument("--target-queue-wait-ms", type=float, default=None)
    args = parser.parse_args(argv)

    from paddle_tpu_torch import monitor
    from paddle_tpu_torch.serving.wire.server import ServingProcess

    # the endpoint-kind marker is checked WITHOUT importing
    # serving.decode (is_decode_endpoint is just this exists()):
    # non-decode children keep the package's lazy-import policy — no
    # decode metric families registered in processes that never stream
    if os.path.exists(os.path.join(args.model_dir, "decode.json")):
        # a decode endpoint dir (decode.json + weights) hosts the
        # continuous-batching scheduler instead of a request batcher;
        # slot/steps config comes from the saved endpoint
        from paddle_tpu_torch.serving.decode import load_decode_endpoint

        server = load_decode_endpoint(
            args.model_dir, place=_place(args.place),
            queue_capacity=args.queue_capacity,
            name=args.name,
        )
    else:
        from paddle_tpu_torch.inference import (
            AnalysisConfig,
            create_paddle_predictor,
        )
        from paddle_tpu_torch.serving.server import InferenceServer

        def config():
            cfg = AnalysisConfig(args.model_dir)
            if args.place == "cpu":
                cfg.disable_gpu()
            return cfg

        predictors = [
            create_paddle_predictor(config())
            for _ in range(max(1, args.replicas))
        ]
        kw = ({} if args.target_queue_wait_ms is None
              else {"target_queue_wait_ms": args.target_queue_wait_ms})
        server = InferenceServer(
            predictors,
            max_batch_size=args.max_batch_size,
            batch_timeout_ms=args.batch_timeout_ms,
            queue_capacity=args.queue_capacity,
            name=args.name,
            **kw,
        )
    if args.flight_slow_ms is not None:
        monitor.flight_recorder(slow_ms=args.flight_slow_ms)
    if args.warmup:
        server.warmup()
    sp = ServingProcess(server, host=args.host, port=args.port)
    host, port = sp.start()
    done = threading.Event()
    sp._shutdown_cb = done.set

    def _on_term(signum, frame):
        threading.Thread(target=sp._quit, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    print(READY_PREFIX + json.dumps(
        {"host": host, "port": port, "pid": os.getpid(),
         "name": args.name}), flush=True)
    done.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
