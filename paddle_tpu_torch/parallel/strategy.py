"""BuildStrategy / ExecutionStrategy / DistributedStrategy parity objects.

The port's own copy of the JAX package's ``parallel/strategy.py``
(reference: paddle/fluid/framework/details/build_strategy.h and
python/paddle/fluid/incubate/fleet/collective/__init__.py:98).  Most of
the reference's knobs steer its hand-built pass pipeline (fuse allreduce,
hierarchical rings, memory reuse); the port runs the program's ops as they
are, so the fields are accepted for API parity and setting one after
construction WARNS that it is inert here.  The few that still mean
something (the mesh shape and ``sharding_specs``) steer the
``CompiledProgram``'s placements.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

__all__ = ["BuildStrategy", "ExecutionStrategy", "DistributedStrategy"]


class _WarnsOnInertKnobs:
    """Warn when a knob that steers nothing here is explicitly set."""

    _INERT: frozenset = frozenset()
    _init_done = False

    def __setattr__(self, name, value):
        if self._init_done and name in self._INERT:
            warnings.warn(
                "%s.%s is accepted for fluid API parity but has no effect "
                "in paddle_tpu_torch: the program's ops run as they are"
                % (type(self).__name__, name),
                stacklevel=2,
            )
        object.__setattr__(self, name, value)


class BuildStrategy(_WarnsOnInertKnobs):
    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    _INERT = frozenset({
        "fuse_elewise_add_act_ops", "fuse_all_reduce_ops",
        "fuse_all_optimizer_ops", "fuse_broadcast_ops", "memory_optimize",
        "enable_inplace", "enable_sequential_execution",
        "remove_unnecessary_lock", "use_hierarchical_allreduce",
        "hierarchical_allreduce_inter_nranks", "nccl_comm_num",
    })

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = True
        self.fuse_broadcast_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.nccl_comm_num = 1
        self._init_done = True


class ExecutionStrategy(_WarnsOnInertKnobs):
    class ExecutorType:
        Default = 0
        Experimental = 1

    _INERT = frozenset({
        "num_threads", "num_iteration_per_drop_scope",
        "use_thread_pool", "allow_op_delay",
    })

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_pool = False
        self.allow_op_delay = False
        self._init_done = True


class DistributedStrategy(BuildStrategy):
    """Fleet collective-mode strategy (reference:
    incubate/fleet/collective/__init__.py:98) extended with the mesh
    shape: axis name -> size. ``sharding_specs`` maps var names to
    PartitionSpec tuples for model-parallel params."""

    def __init__(self):
        super().__init__()
        # reopen: BuildStrategy.__init__ closed the init window
        object.__setattr__(self, "_init_done", False)
        self.mode = "collective"
        self.collective_mode = "grad_allreduce"  # or "local_sgd"
        self.local_sgd_steps = 1
        self.use_local_sgd = False
        self.use_dgc = False
        self.mesh_axes: Dict[str, int] = {}
        self.sharding_specs: Dict[str, tuple] = {}
        self.exec_strategy = ExecutionStrategy()
        self.use_amp = False
        self.num_microbatches = 1
        # 5D hybrid-parallel engine config (HybridConfig kwargs: dp/pp/tp/
        # sp/ep + model dims); consumed by
        # fleet.distributed_optimizer(...).build_hybrid_train_step()
        self.hybrid: Optional[Dict] = None
        self._init_done = True
