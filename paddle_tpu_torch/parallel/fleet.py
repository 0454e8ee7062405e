"""Fleet: the unified distributed training API.

The port's counterpart of the JAX package's ``parallel/fleet.py``
(reference: python/paddle/fluid/incubate/fleet/base/fleet_base.py:37,
``Fleet`` and ``DistributedOptimizer``; base/role_maker.py:30-444, the role
makers; collective/__init__.py, the collective fleet).

Collective mode wraps the optimizer, so ``minimize`` appends the usual
backward and update ops and binds a ``CompiledProgram`` over a ``dp`` mesh
of the world's ranks (``parallel/mesh.py``: one rank a mesh device).
``build_hybrid_train_step`` reaches the 5D engine (``parallel/hybrid.py``)
with the user's optimizer.  A job's processes come from the launcher's
``PADDLE_*`` variables (``distributed/launch.py``); where ``init`` finds the
trainers on more than one host and ``PADDLE_TPU_DISTRIBUTED_INIT=1``, it
starts ``torch.distributed`` from them (``parallel/env.py``
``init_from_env``), where the JAX package calls
``jax.distributed.initialize``.
"""
from __future__ import annotations

import os
from typing import List, Optional

from paddle_tpu_torch import framework
from paddle_tpu_torch.parallel import env as penv
from paddle_tpu_torch.parallel import mesh as mesh_lib
from paddle_tpu_torch.parallel.compiled_program import CompiledProgram
from paddle_tpu_torch.parallel.strategy import DistributedStrategy

__all__ = [
    "Fleet",
    "fleet",
    "DistributedOptimizer",
    "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker",
    "UserDefinedCollectiveRoleMaker",
    "MPISymetricRoleMaker",
    "Role",
]


class Role:
    WORKER = 1
    SERVER = 2


class RoleMakerBase:
    def __init__(self):
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []
        self._role = Role.WORKER
        self._current_id = 0

    def is_worker(self):
        return self._role == Role.WORKER

    def is_server(self):
        return self._role == Role.SERVER

    def is_first_worker(self):
        return self.is_worker() and self._current_id == 0

    def worker_index(self):
        return self._current_id

    def server_index(self):
        return self._current_id

    def worker_num(self):
        return max(1, len(self._worker_endpoints))

    def server_num(self):
        return len(self._server_endpoints)

    def get_trainer_endpoints(self):
        return self._worker_endpoints

    def get_pserver_endpoints(self):
        return self._server_endpoints

    def generate_role(self):
        pass


class PaddleCloudRoleMaker(RoleMakerBase):
    """Reads the launcher's environment (reference: role_maker.py:328; the
    ``PADDLE_*`` contract kept verbatim so launch scripts port unchanged)."""

    def __init__(self, is_collective: bool = True):
        super().__init__()
        self._is_collective = is_collective
        self.generate_role()

    def generate_role(self):
        self._worker_endpoints = [
            e for e in os.getenv("PADDLE_TRAINER_ENDPOINTS", "").split(",") if e
        ]
        self._server_endpoints = [
            e for e in os.getenv("PADDLE_PSERVER_ENDPOINTS", "").split(",") if e
        ]
        role = os.getenv("TRAINING_ROLE", "TRAINER").upper()
        self._role = Role.SERVER if role == "PSERVER" else Role.WORKER
        self._current_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=Role.WORKER, worker_num=1, server_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = ["127.0.0.1:%d" % (6170 + i) for i in range(worker_num)]
        self._server_endpoints = server_endpoints or []


class UserDefinedCollectiveRoleMaker(RoleMakerBase):
    """reference: role_maker.py UserDefinedCollectiveRoleMaker: every rank
    a worker (collective mode), the endpoints given."""

    def __init__(self, current_id=0, worker_endpoints=None):
        super().__init__()
        self._current_id = current_id
        self._role = Role.WORKER
        self._worker_endpoints = list(worker_endpoints or ["127.0.0.1:6170"])


class MPISymetricRoleMaker(RoleMakerBase):
    """reference: role_maker.py:87 MPISymetricRoleMaker: even MPI ranks are
    workers, odd ones servers.  Needs mpi4py at ``generate_role()``; the
    launcher's environment (``PaddleCloudRoleMaker``) needs no MPI."""

    def __init__(self):
        super().__init__()
        self._generated = False

    def generate_role(self):
        try:
            from mpi4py import MPI  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "MPISymetricRoleMaker needs mpi4py (not in this image); "
                "use PaddleCloudRoleMaker (PADDLE_* env contract) instead"
            ) from e
        comm = MPI.COMM_WORLD
        rank = comm.Get_rank()
        self._role = Role.WORKER if rank % 2 == 0 else Role.SERVER
        self._current_id = rank // 2
        # each rank's routable host (reference: get_ip() a node), not
        # 127.0.0.1, which would point every endpoint at one host
        import socket

        host = socket.gethostbyname(MPI.Get_processor_name() or socket.gethostname())
        hosts = comm.allgather("%s:%d" % (host, 6170 + rank))
        self._worker_endpoints = hosts[0::2]
        self._server_endpoints = hosts[1::2]
        self._generated = True


class Fleet:
    """The collective-mode fleet singleton (reference: fleet_base.py:37)."""

    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._inited = False

    def init(self, role_maker: Optional[RoleMakerBase] = None):
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        self._role_maker.generate_role()
        self._inited = True
        # several hosts: start torch.distributed from the launcher's variables
        n_hosts = len({e.split(":")[0] for e in self._role_maker.get_trainer_endpoints()})
        if n_hosts > 1 and os.getenv("PADDLE_TPU_DISTRIBUTED_INIT", "0") == "1":
            penv.init_from_env()
        return self

    # --- introspection (the reference's API) ---
    def is_worker(self):
        return self._role_maker is None or self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker is not None and self._role_maker.is_server()

    def is_first_worker(self):
        return self._role_maker is None or self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_num(self):
        return self._role_maker.worker_num() if self._role_maker else 1

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints() if self._role_maker else []
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints() if self._role_maker else []
        return ",".join(eps) if to_string else eps

    def distributed_optimizer(self, optimizer, strategy: Optional[DistributedStrategy] = None):
        self._strategy = strategy or DistributedStrategy()
        return DistributedOptimizer(optimizer, self._strategy, self)

    # --- program lifecycle ---
    def init_worker(self):
        pass

    def init_server(self, *args, **kwargs):
        pass

    def run_server(self):
        pass

    def stop_worker(self):
        pass

    def save_inference_model(self, executor, dirname, feeded_var_names, target_vars,
                             main_program=None, export_for_deployment=True):
        from paddle_tpu_torch import io

        return io.save_inference_model(dirname, feeded_var_names, target_vars, executor, main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        from paddle_tpu_torch import io

        return io.save_persistables(executor, dirname, main_program)

    @property
    def main_program(self):
        return getattr(self, "_compiled_program", None) or framework.default_main_program()


class DistributedOptimizer:
    """reference: CollectiveOptimizer (incubate/fleet/collective/
    __init__.py:157).  ``minimize`` appends the usual backward and update
    ops, then binds a CompiledProgram over the strategy's mesh (a ``dp``
    mesh of the world's ranks where it names none), whose step reduces the
    gradients over ``dp``."""

    def __init__(self, optimizer, strategy: DistributedStrategy, fleet_: Fleet):
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet_

    def backward(self, *a, **k):
        return self._optimizer.backward(*a, **k)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        ops, pgs = self._optimizer.minimize(loss, startup_program, parameter_list, no_grad_set)
        strat = self._strategy
        if not strat.mesh_axes:
            strat.mesh_axes = {"dp": mesh_lib.world()[1]}
        compiled = CompiledProgram(loss.block.program).with_strategy(strat)
        self._fleet._compiled_program = compiled
        return ops, pgs

    def build_hybrid_train_step(self, mesh=None):
        """The 5D hybrid-parallel engine (``DistributedStrategy.hybrid``: a
        dict of HybridConfig kwargs) with this optimizer's registered
        kernel as its update.

        Returns ``(step, helpers)``: ``step(params, aux, tokens, labels) ->
        (loss, new_params, new_aux)`` on this rank's shards, and ``helpers``
        with ``init_params(seed)``, ``init_opt_state(params)``,
        ``place(params, tokens, labels)``, ``place_aux(aux)``,
        ``gather(shards)`` (full numpy arrays, collective), ``mesh`` and
        ``config``."""
        from paddle_tpu_torch.parallel import hybrid

        if not self._strategy.hybrid:
            raise ValueError(
                "build_hybrid_train_step needs DistributedStrategy.hybrid "
                "= dict of HybridConfig kwargs (dp/pp/tp/sp/ep + dims)"
            )
        cfg = hybrid.HybridConfig(**self._strategy.hybrid)
        step, place, mesh = hybrid.make_train_step(cfg, mesh=mesh, optimizer=self._optimizer)
        optimizer = self._optimizer

        class _Helpers:
            config = cfg

            @staticmethod
            def init_params(seed=0):
                return hybrid.init_params(cfg, seed=seed)

            @staticmethod
            def init_opt_state(params):
                return hybrid.init_opt_state(cfg, params, optimizer)

            @staticmethod
            def gather(shards):
                return hybrid.gather(cfg, mesh, shards)

        _Helpers.place = staticmethod(place)
        _Helpers.place_aux = staticmethod(step.place_aux)
        _Helpers.mesh = mesh
        return step, _Helpers


fleet = Fleet()
