"""Multi-process launcher.

The port's own copy of the JAX package's ``distributed/launch.py``
(reference: python/paddle/distributed/launch.py:132-214): computes
``PADDLE_TRAINER_ENDPOINTS / PADDLE_TRAINER_ID / PADDLE_CURRENT_ENDPOINT /
PADDLE_TRAINERS_NUM`` and spawns ``--nproc_per_node`` worker processes,
each with ``FLAGS_selected_gpus`` set to its local rank, as Paddle's
launcher does.  The children inherit the parent's environment as it is:
the launcher hides no card from them, so every child takes the place its
script asks for (the port's entry points: ``cuda:0`` unless given the
CPU).  ``parallel.env.init_from_env`` builds a ``torch.distributed`` group
from these variables (trainer 0's endpoint hosts the rendezvous); a
parameter server serves on its ``PADDLE_CURRENT_ENDPOINT``.

Usage:  python -m paddle_tpu_torch.distributed.launch --nproc_per_node=2 \
            --started_port=6170 --log_dir=logs train.py --args
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
from typing import List

__all__ = ["launch", "start_procs"]


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description="paddle_tpu_torch distributed launcher")
    p.add_argument("--cluster_node_ips", type=str, default="127.0.0.1")
    p.add_argument("--node_ip", type=str, default="127.0.0.1")
    p.add_argument("--started_port", type=int, default=6170)
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def worker_envs(args) -> List[dict]:
    """The variables each local worker gets on top of the parent's
    environment (reference: launch.py:132)."""
    node_ips = [ip for ip in args.cluster_node_ips.split(",") if ip]
    node_id = node_ips.index(args.node_ip)
    n_local = args.nproc_per_node
    all_endpoints = ["%s:%d" % (ip, args.started_port + i) for ip in node_ips
                     for i in range(n_local)]
    envs = []
    for local_rank in range(n_local):
        rank = node_id * n_local + local_rank
        envs.append({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_CURRENT_ENDPOINT": all_endpoints[rank],
            "PADDLE_TRAINERS_NUM": str(len(all_endpoints)),
            "PADDLE_TRAINER_ENDPOINTS": ",".join(all_endpoints),
            "FLAGS_selected_gpus": str(local_rank),
        })
    return envs


def start_procs(args) -> List[subprocess.Popen]:
    """Start the local workers; with ``--log_dir`` each writes its output
    to ``workerlog.<rank>`` there."""
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for extra in worker_envs(args):
        env = dict(os.environ, **extra)
        cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
        out = None
        if args.log_dir:
            out = open(os.path.join(args.log_dir, "workerlog.%s" % extra["PADDLE_TRAINER_ID"]), "w")
        try:
            procs.append(subprocess.Popen(cmd, env=env, stdout=out, stderr=out))
        finally:
            if out is not None:
                out.close()  # the child holds its own descriptor
    return procs


def launch(argv=None):
    """reference: launch.py:214.  Starts the workers and waits for them;
    returns the first nonzero exit code, else 0.  SIGTERM is passed on to
    the workers."""
    args = _parse_args(argv)
    procs = start_procs(args)

    def terminate(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.terminate()

    signal.signal(signal.SIGTERM, terminate)
    rc = 0
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(launch())
