"""Trainer / DeviceWorker descriptors (reference: framework/trainer.h:38
TrainerBase/MultiTrainer/DistMultiTrainer/PipelineTrainer,
device_worker.h:103 Hogwild/Downpour/Section workers, trainer_desc.proto,
python/paddle/fluid/trainer_desc.py + trainer_factory.py).

The port's own copy of the JAX package's ``trainer_desc.py``.  The
reference's thread-pool of device workers interpreting ops is replaced
by one cached step (executor.py; a captured CUDA graph on the card), so
these descriptors configure HOW ``Executor.train_from_dataset`` drives
that step rather than spawning thread workers:

* ``Hogwild``     -> the cached step per batch.  On a dense-PS program
  it flips the PS round to async; the dense PS is not ported yet
  (ROADMAP A6b), so here it has nothing to flip.
* ``DownpourSGD`` -> the cached step + the distributed-table
  prefetch/push (executor._prefetch_distributed_tables), async through
  the Communicator.
* ``Section``     -> the pipelined program of a PipelineOptimizer with a
  ``cut_list``; without one ``train_from_dataset`` raises, as the JAX
  package does (the pipelined schedule is ROADMAP A10).
"""
from __future__ import annotations

from typing import List, Optional

__all__ = [
    "TrainerDesc", "MultiTrainer", "DistMultiTrainer", "PipelineTrainer",
    "DeviceWorker", "Hogwild", "DownpourSGD", "Section",
    "TrainerFactory",
]


class DeviceWorker:
    """Base device-worker descriptor (device_worker.h:103)."""

    worker_kind = "Hogwild"

    def __init__(self):
        self._fleet_desc = None
        self._program = None

    def _set_fleet_desc(self, desc):
        self._fleet_desc = desc

    def _set_program(self, program):
        self._program = program

    def _prepare(self, program):
        """Hook run by train_from_dataset before the loop — subclasses
        install their runtime behavior here."""


class Hogwild(DeviceWorker):
    """Lock-free shared-scope SGD worker (hogwild_worker.cc) — the
    cached step is race-free by construction; on a dense-PS
    trainer program Hogwild means ASYNC updates, so it flips the
    program's PS round to sync=False (each push applies immediately,
    no cross-trainer barrier — the hogwild contract)."""

    worker_kind = "Hogwild"

    def _prepare(self, program):
        ctx = getattr(program, "_dense_ps_ctx", None)
        if ctx is not None and ctx.get("sync"):
            if ctx.get("initialized"):
                raise ValueError(
                    "Hogwild worker on an already-initialized SYNC dense-PS "
                    "program — transpile with sync_mode=False instead"
                )
            ctx["sync"] = False


class DownpourSGD(DeviceWorker):
    """PS pull/push worker (downpour_worker.cc) — drives the
    distributed-lookup-table prefetch/push through the ASYNC
    Communicator (merge-before-send background thread), installing one
    on the program when none is bound (reference: downpour_worker.cc
    push_sparse via the communicator)."""

    worker_kind = "DownpourSGD"

    def __init__(self, max_merge: int = 20, capacity: int = 200):
        super().__init__()
        self.max_merge = int(max_merge)
        self.capacity = int(capacity)

    def _prepare(self, program):
        client = getattr(program, "_ps_client", None)
        if client is not None and getattr(program, "_ps_communicator", None) is None:
            from paddle_tpu_torch.distributed.communicator import Communicator

            program._ps_communicator = Communicator(
                client, max_merge=self.max_merge, capacity=self.capacity
            ).start()


class Section(DeviceWorker):
    """Pipeline stage worker (section_worker.cc:141) — maps to the
    compiled GPipe schedule (PipelineOptimizer with cut_list)."""

    worker_kind = "Section"

    def __init__(self, num_microbatches: int = 1):
        super().__init__()
        self.num_microbatches = num_microbatches

    def _prepare(self, program):
        plan = getattr(program, "_pipeline_plan", None)
        if plan is not None and self.num_microbatches > 1 and (
            int(plan["num_microbatches"]) != int(self.num_microbatches)
        ):
            raise ValueError(
                "Section worker num_microbatches=%d disagrees with the "
                "program's PipelineOptimizer plan (%d)"
                % (self.num_microbatches, plan["num_microbatches"])
            )


class TrainerDesc:
    """reference: trainer_desc.proto:21 + python trainer_desc.py."""

    def __init__(self):
        self._worker: DeviceWorker = Hogwild()
        self._fetch_vars: List = []
        self._fetch_info: List[str] = []
        self._print_period = 100
        self.thread_num = 1

    def set_device_worker(self, worker: DeviceWorker):
        self._worker = worker

    def set_fetch_var_and_info(self, fetch_vars, fetch_info, print_period):
        self._fetch_vars = list(fetch_vars or [])
        self._fetch_info = list(fetch_info or [])
        self._print_period = print_period

    def set_thread(self, n: int):
        # one compiled step serves all compute threads; n maps to the
        # host-side batch-prefetch depth in train_from_dataset (the
        # reference's reader threads feeding device workers)
        self.thread_num = n


class MultiTrainer(TrainerDesc):
    """Single-node multi-thread trainer (trainer.h:63) — one compiled
    step; thread_num is accepted for parity."""


class DistMultiTrainer(TrainerDesc):
    """PS-distributed trainer (trainer.h:81) — pair with DownpourSGD and
    bind_distributed_tables."""


class PipelineTrainer(TrainerDesc):
    """Pipeline trainer (trainer.h:95) — pair with Section and a
    PipelineOptimizer-cut program."""


class TrainerFactory:
    """reference: trainer_factory.cc + python trainer_factory.py."""

    _TRAINERS = {
        "MultiTrainer": MultiTrainer,
        "DistMultiTrainer": DistMultiTrainer,
        "PipelineTrainer": PipelineTrainer,
    }
    _WORKERS = {
        "Hogwild": Hogwild,
        "DownpourSGD": DownpourSGD,
        "Section": Section,
    }

    def create_trainer(self, opt_info: Optional[dict] = None) -> TrainerDesc:
        opt_info = opt_info or {}
        trainer = self._TRAINERS[opt_info.get("trainer", "MultiTrainer")]()
        kind = opt_info.get("device_worker", "Hogwild")
        if kind == "Section":
            worker = Section(num_microbatches=int(opt_info.get("num_microbatches", 1)))
        else:
            worker = self._WORKERS[kind]()
        trainer.set_device_worker(worker)
        return trainer
