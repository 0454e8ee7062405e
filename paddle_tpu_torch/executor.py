"""Executor: runs a Program's global block on one device.

Port of the JAX package's ``executor.py``'s single-device ``Executor.run``
(reference: python/paddle/fluid/executor.py).  The JAX package keeps a
run plan per (program, feed and fetch names, steps) and one compiled
step per feed signature.  This executor keeps the same two caches, with
the same keys and counters (``jit_cache_stats``):

* a run plan (``_RunPlan``): the block analysis of which persistable
  vars the block reads and writes, and the feeds' dtypes;
* an entry (``_Entry``) per plan and feed signature (names, shapes,
  dtypes).  On the CPU an entry runs the block interpreter
  (``core/lowering.py``) op by op.  On a CUDA device an entry's first
  run on a thread is the interpreter too: it is the warm-up that a
  capture needs (PyTorch creates its cuBLAS handles per thread, and a
  capture cannot create one).  The next run on a warmed thread captures
  the step into a CUDA graph (``_Graph``) against the scope it runs on
  and replays it; every later run with that scope, on any thread,
  copies the feeds into the graph's feed buffers and replays.  Each
  scope gets a graph of its own: a graph reads and writes its scope's
  own tensors.  This is the counterpart of the JAX package's
  ``jax.jit`` of the step with its state donated.

Three kinds of run stay on the interpreter, decided from the plan and
the scope before the step runs: a plan with random ops (a startup
program: its generators live on the host, and are not registered with
a graph) or with ops that read a value on the host (``while``,
``conditional_block``, ``select_branch``: the predicate's read
synchronises the stream), at any depth of the control-flow bodies; a
run that creates scope state (a var it writes that the scope does not
hold yet, so there is no tensor to write it back into); and
``use_program_cache=False``.  A capture that fails raises.

With ``FLAGS_check_nan_inf`` set (``flags.py``), every run checks its
fetches and the state it wrote for nan and inf after the step, outside
the graph, on either path, and raises naming them: the counterpart of
the JAX package's check at its compiled step's boundary.  It costs one
host sync a run; with the flag off nothing is checked and nothing
syncs.

An entry's graphs are shared state (feed and output buffers): a lock
per entry holds from the feed copy to the read-out of the fetches, so
threads that run one bucket take turns.

``run(..., steps=N)`` runs N steps in one call and returns the last
step's fetches; with ``per_step_feed=True`` every feed carries a leading
``steps`` axis and step ``i`` reads slice ``i``.  ``use_program_cache=
False`` runs the interpreter eagerly and caches nothing: the caller's
explicit choice, and the reference the captured step is held against.

Distributed lookup tables (``embedding(is_distributed=True)``, bound to
parameter servers by ``distributed.bind_distributed_tables``): before
the step ``run`` uniques each table's ids, pads the unique count to a
power-of-two bucket (``pow2_id_bucket``) or the bound ladder, pulls the
rows from the servers (the tables concurrently, each on a client of its
own) and feeds them with the int32 ids-to-row map; after the step it
pushes the rows' gradients, fetched as host copies taken before the
entry's lock is released (a captured step's fetch buffers are
overwritten by its next replay): blocking through ``push_sparse``, or
queued on the program's ``Communicator`` in async mode.  Each bucket is
a feed signature, so an entry of its own.  The plan key leaves out the
prefetch's own feed names, so rows that ``train_from_dataset``'s
overlapped prefetch installed ahead of ``run`` share the plan and the
entry of the inline pull.  ``Executor.train_from_dataset`` loops a
dataset's batches through ``run``, with ``thread=N`` prefetch onto the
executor's device.

The dense parameter server (``transpiler.DistributeTranspiler``'s
"pserver" mode): a trainer program (``_dense_ps_ctx``) has no optimizer
updates.  Its first run creates the server-side parameters, trainer 0
seeds them with its initial values and every trainer pulls them.  Each
run fetches every parameter's gradient (hidden from the caller, a host
copy taken before the entry's lock is released), pushes them all, then
pulls every parameter into the scope: a new tensor that the next replay
copies into its graph's buffer.  In sync mode the pull waits for the
servers to apply all trainers' gradients of the step.  In async mode
(Hogwild) ``train_from_dataset`` overlaps each step's pull with the step
on a thread of its own; the next run installs what it pulled.  Running a
pserver program (``_pserver_ctx``) serves its share of the parameters
from this process's host memory and blocks; it returns before the scope
binds a device, so a pserver process makes no CUDA context.
"""
from __future__ import annotations

import collections
import gc
import itertools
import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import faults as _faults
from paddle_tpu_torch import flags, framework, kernels
from paddle_tpu_torch.core import lowering, registry
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.monitor import events as _mon_events
from paddle_tpu_torch.monitor import flight as _mon_flight
from paddle_tpu_torch.monitor import registry as _mon_registry
from paddle_tpu_torch.monitor import spans as _mon_spans
from paddle_tpu_torch.monitor import train as _mon_train
from paddle_tpu_torch.parallel import env as _penv
from paddle_tpu_torch.scope import Scope, global_scope, host_copy, to_numpy

__all__ = ["Executor", "AsyncExecutor", "pow2_id_bucket"]

# run-phase observability (the JAX package's, ``monitor/``).  The cache
# counters are COLLECT-ON-READ: every Executor's ``_cache_stats`` dict
# registers here at construction and the registry sums them when a
# consumer scrapes, so ``run`` pays nothing beyond the dict increments
# it already does.  The per-phase spans gate on ``_mon_spans.recording()``,
# one flag check each when no trace session is active.
_exec_stats_lock = threading.Lock()
_exec_stats: List[Dict[str, Any]] = []  # one _cache_stats dict per LIVE Executor
_exec_retired = {
    "hits": 0, "misses": 0, "runs": 0,
    "plan_hits": 0, "plan_misses": 0, "dispatch_overhead_s": 0.0,
    "plan_evictions": 0, "jit_evictions": 0,
    "ps_pull_overlap_s": 0.0, "ps_pull_wait_s": 0.0,
}  # folded-in dead executors


_exec_dead: "collections.deque[Dict[str, Any]]" = collections.deque()


def _retire_exec_stats(stats: Dict[str, Any]) -> None:
    # weakref.finalize callback: queue a dead executor's totals for the
    # next reader to fold into the retired base (the counters stay
    # monotonic).  It takes no lock: a garbage collection can run it in a
    # thread that already holds _exec_stats_lock, inside _sum_exec_stats.
    _exec_dead.append(stats)


def _sum_exec_stats(key: str):
    with _exec_stats_lock:
        while _exec_dead:
            stats = _exec_dead.popleft()
            try:
                _exec_stats.remove(stats)
            except ValueError:
                continue
            for k in _exec_retired:
                _exec_retired[k] += stats.get(k, 0)
        return _exec_retired[key] + sum(d.get(key, 0) for d in _exec_stats)


for _name, _key, _help in (
        ("executor_runs_total", "runs", "Executor.run invocations (all executors)"),
        ("executor_jit_cache_hits_total", "hits", "runs served by an existing compiled entry"),
        ("executor_jit_cache_misses_total", "misses",
         "newly built entries (a block lowering; on the card the next run captures it)"),
        ("executor_plan_cache_hits_total", "plan_hits",
         "runs served by a cached run plan (no per-run block re-analysis)"),
        ("executor_plan_cache_misses_total", "plan_misses",
         "run-plan builds (an O(n_ops) dataflow analysis each)"),
        ("executor_dispatch_overhead_seconds_total", "dispatch_overhead_s",
         "host-side run() seconds spent before the step ran"),
        ("executor_plan_cache_evictions_total", "plan_evictions",
         "run plans evicted by the LRU capacity bound"),
        ("executor_jit_cache_evictions_total", "jit_evictions",
         "compiled jit entries evicted by the LRU capacity bound"),
        ("executor_ps_pull_overlap_seconds_total", "ps_pull_overlap_s",
         "dense-PS pull seconds hidden behind device compute (overlapped "
         "pull thread; train_from_dataset async mode)"),
        ("executor_ps_pull_wait_seconds_total", "ps_pull_wait_s",
         "seconds run() blocked joining the overlapped dense-PS pull (the "
         "NOT-hidden remainder of the pull latency)")):
    # the names and help texts are the JAX package's, so one scrape
    # reads either package's executors alike
    _mon_registry.REGISTRY.counter_callback(
        _name, _help, fn=lambda _k=_key: _sum_exec_stats(_k))
# per-run distribution, observed only while a trace session is active;
# the always-on totals live in the callback counters above
_MON_DISPATCH_HIST = _mon_registry.REGISTRY.histogram(
    "executor_dispatch_overhead_seconds",
    "per-run host dispatch overhead (recorded under trace sessions)")
# per-step train-loop distribution, always on, with the epoch's trace id
# pinned as an OpenMetrics exemplar
_MON_TRAIN_STEP_HIST = _mon_registry.REGISTRY.histogram(
    "executor_train_step_seconds",
    "per-step train_from_dataset wall time (exemplar: epoch trace id)")

# cache bounds, as the JAX package's defaults: an ordinary workload never
# evicts; the bound is for programs built in a loop forever
_PLAN_CACHE_CAPACITY = 1024
_ENTRY_CACHE_CAPACITY = 512


def _as_fetch_name(f) -> str:
    return f.name if isinstance(f, framework.Variable) else str(f)


def pow2_id_bucket(n_unique: int) -> int:
    """The default sparse-prefetch unique-id bucket: the next power of
    two >= ``n_unique``, floored at 8 (the JAX package's one definition,
    which its tools size against)."""
    return max(8, 1 << max(0, int(n_unique) - 1).bit_length())


# program attributes of JAX package features that the port does not run
# yet: a program that carries one raises instead of training without it
_UNPORTED_PROGRAM_STATE = {
    "_mesh_tables": "mesh-resident tables (bind_mesh_tables; ROADMAP A10 part 4)",
    "_pipeline_plan": "the pipelined program (PipelineOptimizer cut_list; ROADMAP A10 part 3)",
}

# transient PS pull failures the overlap thread retries: the connection
# classes only (a PS in-band application error, RuntimeError from
# PSClient._call, is deterministic and surfaces)
_PS_PULL_RETRYABLE = (ConnectionError, OSError, TimeoutError)


def _host_ids(v) -> np.ndarray:
    """A feed's ids as a host array (a staged card tensor comes back)."""
    return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


class _RunPlan:
    """The block analysis of one plan key: the feed and fetch names, the
    persistable vars the block reads from the scope (``state_in``) and
    writes back (``state_out``), each feed's torch dtype, the op types
    that keep the plan on the interpreter (``eager_ops``: random ops, ops
    that read a value on the host, a loop or branch predicate, and
    collectives on a ring of more than one rank, which wait for their
    peers; at any depth of the control-flow bodies), ``n_push``: how many
    fetches after the caller's are prefetched rows' gradients that the
    run pushes, and ``n_dense``: how many after those are the dense-PS
    parameters' gradients that the run pushes; both are hidden from the
    caller."""

    __slots__ = ("feed_names", "fetch_names", "state_in", "state_out", "feed_dtypes",
                 "eager_ops", "n_push", "n_dense")

    def __init__(self, feed_names, fetch_names, state_in, state_out, feed_dtypes, eager_ops,
                 n_push=0, n_dense=0):
        self.feed_names = feed_names
        # the caller's, then the pushed rows' gradients, then the dense ones
        self.fetch_names = fetch_names
        self.state_in = state_in
        self.state_out = state_out
        self.feed_dtypes = feed_dtypes
        self.eager_ops = eager_ops
        self.n_push = n_push
        self.n_dense = n_dense


class _LRUCache:
    """Bounded mapping with least-recently-used eviction (the JAX
    package's ``_LRUCache``).  ``on_evict(value)`` sees each evicted value,
    so an evicted entry releases its CUDA graph."""

    __slots__ = ("_data", "capacity", "_on_evict")

    def __init__(self, capacity: int, on_evict=None):
        self._data: "collections.OrderedDict" = collections.OrderedDict()
        self.capacity = max(1, int(capacity))
        self._on_evict = on_evict

    def get(self, key, default=None):
        try:
            self._data.move_to_end(key)
        except KeyError:
            return default
        return self._data[key]

    def __setitem__(self, key, value):
        data = self._data
        data[key] = value
        data.move_to_end(key)
        while len(data) > self.capacity:
            _, old = data.popitem(last=False)
            if self._on_evict is not None:
                self._on_evict(old)

    def __len__(self):
        return len(self._data)

    def values(self):
        return list(self._data.values())

    def clear(self):
        self._data.clear()


class _Graph:
    """One step of an entry captured as a CUDA graph against one scope.

    The graph reads its state from that scope's own tensors (``bufs``,
    one per persistable var the block reads or writes) and writes each
    new value back into the same tensor with a ``copy_`` at the end of
    the graph: the in-place counterpart of the JAX package donating the
    state buffers to its compiled step.  Feeds are copied into ``feeds``,
    the graph's own buffers, before each replay; ``fetches`` are its
    output buffers, overwritten by each replay.  ``scope`` is a weak
    reference: a graph never keeps its scope alive."""

    __slots__ = ("scope", "graph", "bufs", "feeds", "fetches", "launches", "pool_bytes")

    def __init__(self, scope, graph, bufs, feeds, fetches, launches, pool_bytes):
        self.scope = weakref.ref(scope)
        self.graph: torch.cuda.CUDAGraph = graph
        self.bufs: Dict[str, torch.Tensor] = bufs
        self.feeds: Dict[str, torch.Tensor] = feeds
        self.fetches: list = fetches
        self.launches: Dict = launches
        self.pool_bytes: int = pool_bytes


class _Entry:
    """One cached step: the interpreter over the block and, on a CUDA
    device, its captured graphs, one per scope (keyed by ``id(scope)``
    and checked against the graph's weak reference, since an id is
    reused once its scope is gone)."""

    __slots__ = ("fn", "warmed", "graphs", "lock")

    def __init__(self, fn):
        self.fn = fn
        self.warmed = threading.local()  # .done: this thread has run the entry
        self.graphs: Dict[int, _Graph] = {}
        self.lock = threading.Lock()

    def graph_for(self, scope: Scope) -> Optional[_Graph]:
        """This scope's graph, after releasing the graphs of scopes that
        are gone."""
        for k, g in list(self.graphs.items()):
            if g.scope() is None:
                g.graph.reset()
                del self.graphs[k]
        g = self.graphs.get(id(scope))
        return g if g is not None and g.scope() is scope else None

    def release(self) -> None:
        with self.lock:  # not while another thread replays
            for g in self.graphs.values():
                g.graph.reset()
            self.graphs = {}


def _check_nan_inf(named) -> None:
    """Raise naming each floating tensor of ``named`` ((name, tensor)
    pairs) that holds a nan or an inf; one host sync for all of them."""
    named = [(n, t) for n, t in named if t.is_floating_point()]
    if not named:
        return
    finite = torch.stack([torch.isfinite(t).all() for _, t in named]).tolist()
    bad = [n for (n, _), ok in zip(named, finite) if not ok]
    if bad:
        raise RuntimeError("nan/inf detected in %s (FLAGS_check_nan_inf=1)" % bad)


def _eager(fn, state, feeds, scope, steps, per_step_feed):
    """``steps`` runs of the interpreter, each writing its new state to
    the scope; the last run's fetches."""
    fetches = []
    for i in range(steps):
        feed = {n: v[i] for n, v in feeds.items()} if per_step_feed else feeds
        with torch.no_grad():
            fetches, new_state = fn(state, feed)
        state = {**state, **new_state}
        scope.vars.update(new_state)
    return fetches


class Executor:
    """``Executor()`` and ``Executor(CUDAPlace(0))`` run on ``cuda:0``
    and raise when there is no CUDA device; ``Executor(CPUPlace())``
    runs on the CPU."""

    # crash-resume bookkeeping of the last train_from_dataset call
    last_resume_step = None
    last_restore_path = None
    last_restore_fallbacks = 0
    last_restore_stats = None
    last_checkpoints = ()
    last_train_trace_id = None
    # training control tower (monitor/train.py): ``_train_ledger`` arms
    # run()'s phase charges while train_from_dataset runs with a ledger
    # (one is-None gate otherwise); the last epoch's ledger, watchdog and
    # step-log path stay readable for /trainz
    _train_ledger = None
    _train_admin = None
    _train_admin_thread = None
    last_train_ledger = None
    last_train_watchdog = None
    last_train_log = None

    def __init__(self, place: Optional[framework.Place] = None,
                 plan_cache_capacity: Optional[int] = None,
                 jit_cache_capacity: Optional[int] = None,
                 reshard_on_gather: Optional[bool] = None):
        self.place = place if place is not None else framework.default_cuda_place()
        self.device: torch.device = framework.device_of(place)
        # an uncompiled run over a compiled run's shards gathers them back
        # once (every rank runs it) instead of raising MeshCommittedStateError
        self._reshard_on_gather = (
            bool(reshard_on_gather) if reshard_on_gather is not None
            else os.environ.get("PADDLE_TPU_RESHARD_ON_GATHER", "") == "1")
        if self.device.type == "cuda":
            # FLAGS_fraction_of_gpu_memory_to_use caps the card's share
            # before this executor allocates on it
            from paddle_tpu_torch import memory

            memory.apply_memory_fraction(self.device)
        self._cache_stats = {
            "hits": 0, "misses": 0, "runs": 0, "plan_hits": 0, "plan_misses": 0,
            "plan_evictions": 0, "jit_evictions": 0, "dispatch_overhead_s": 0.0,
            "ps_pull_overlap_s": 0.0, "ps_pull_wait_s": 0.0,
        }
        with _exec_stats_lock:
            _exec_stats.append(self._cache_stats)
        weakref.finalize(self, _retire_exec_stats, self._cache_stats)
        self._cache = _LRUCache(
            jit_cache_capacity if jit_cache_capacity is not None else _ENTRY_CACHE_CAPACITY,
            on_evict=self._evict_entry)
        self._plans = _LRUCache(
            plan_cache_capacity if plan_cache_capacity is not None else _PLAN_CACHE_CAPACITY,
            on_evict=lambda _: self._bump("plan_evictions"))
        self._capture_stream: Optional[torch.cuda.Stream] = None
        self._capture_lock = threading.Lock()  # one capture at a time on the stream
        self._lock = threading.Lock()  # the two caches and their counters

    def _bump(self, key: str, n=1) -> None:
        self._cache_stats[key] += n

    def _evict_entry(self, entry: _Entry) -> None:
        self._bump("jit_evictions")
        entry.release()

    # ------------------------------------------------------------------
    def _coerce_feed(self, val, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """A feed value as a tensor in the program var's dtype, where it
        lies (a host array becomes a CPU tensor)."""
        if isinstance(val, torch.Tensor):
            return val.to(dtype) if dtype is not None else val
        arr = np.asarray(val)
        if dtype is not None and dtype != torch.bfloat16:
            arr = arr.astype(core_types.np_dtype(core_types.canonical_dtype(dtype)), copy=False)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(dtype) if dtype is not None else t

    def _analyze(self, program, feed_names, fetch_names, n_push=0, n_dense=0) -> _RunPlan:
        """The block's true dataflow reads: a name is read from outside
        only when some op reads it before any op writes it."""
        block = program.global_block()
        persistable = {v.name for v in program.list_vars() if v.persistable}
        read, written = set(), set()
        for op in block.ops:
            for n in lowering.op_reads(op):  # with what its bodies read
                if n not in written:
                    read.add(n)
            written.update(op.output_arg_names)
        for n in fetch_names:
            if n in persistable and n not in written:
                read.add(n)
        feed_dtypes = {}
        for n in feed_names:
            var = block._find_var_recursive(n)
            if var is not None:
                feed_dtypes[n] = core_types.torch_dtype(var.dtype)
        # ops a capture cannot hold, at any depth of the bodies
        eager_ops = {t for t in lowering.op_types(block.ops) if registry.has_op(t)
                     and (registry.get_op(t).random or registry.get_op(t).host_read)}
        from paddle_tpu_torch.ops import collective_ops

        eager_ops |= collective_ops.live_collectives(block.ops)
        return _RunPlan(
            feed_names, fetch_names,
            tuple(sorted((read & persistable) - set(feed_names))),
            tuple(sorted(written & persistable)),
            feed_dtypes, tuple(sorted(eager_ops)), n_push, n_dense)

    # ------------------------------------------------------------------
    def run(
        self,
        program: Optional[framework.Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
        steps: int = 1,
        per_step_feed: bool = False,
    ):
        """Run the program's global block ``steps`` times and return the
        last step's fetches (numpy arrays, or tensors on the device with
        ``return_numpy=False``).  With ``per_step_feed`` each feed value
        carries a leading ``steps`` axis and step ``i`` reads slice
        ``i``.

        The ``executor.run`` fault point gates the top of every run; its
        ``kill`` mode SIGKILLs this process.  Under a trace session each
        run records its phase spans (``executor/lower``,
        ``executor/h2d_feed``, ``executor/jit_compile`` for a capture,
        ``executor/device_execute``, ``executor/d2h_fetch``).  With a
        step-phase ledger armed (``train_from_dataset(phase_ledger=)``)
        the run is one ``device_execute`` window, less the ``h2d``
        charged inside it; the window closes after the fetches' host
        copy, which is where the card's step becomes visible to the
        host, so a run with no fetch leaves its device time to the next
        window."""
        self._cache_stats["runs"] += 1
        if _faults.active is not None:  # disarmed: one is-None gate
            _faults.active.faultpoint("executor.run", pid=os.getpid())
        led = self._train_ledger
        if led is None:
            return self._run(program, feed, fetch_list, scope, return_numpy,
                             use_program_cache, steps, per_step_feed, None)
        tok = led.window_begin()
        out = self._run(program, feed, fetch_list, scope, return_numpy,
                        use_program_cache, steps, per_step_feed, led)
        led.window_end(tok, "device_execute")
        return out

    def _run(self, program, feed, fetch_list, scope, return_numpy, use_program_cache,
             steps, per_step_feed, led):
        t_run0 = time.perf_counter()
        rec = _mon_spans.recording()
        stats = self._cache_stats
        program = program if program is not None else framework.default_main_program()
        compiled = None
        if getattr(program, "_is_compiled_program", False):
            # the compiled program's own program runs the same path as an
            # uncompiled one; a mesh of more than one rank takes its
            # sharded step (_run_compiled), a one-rank mesh the plain one
            compiled, program = program, program._program
        scope = scope if scope is not None else global_scope()
        if getattr(program, "_pserver_ctx", None):
            # a parameter server serves from the host: before the scope
            # binds a device, so its process never makes a CUDA context
            return self._run_pserver(program)
        scope.bind_device(self.device)
        feed = dict(feed or {})
        if compiled is not None and compiled.mesh.size > 1:
            return self._run_compiled(compiled, feed, fetch_list, scope, return_numpy, steps,
                                      per_step_feed)
        for attr, what in _UNPORTED_PROGRAM_STATE.items():
            if getattr(program, attr, None):
                raise NotImplementedError("%s is not ported to paddle_tpu_torch yet" % what)
        dense_ps = getattr(program, "_dense_ps_ctx", None)
        if dense_ps is not None:
            if steps != 1:
                raise ValueError(
                    "steps>1 is incompatible with dense PS mode (the grad "
                    "send / param recv is host-side per batch)")
            self._dense_ps_init(dense_ps, scope)
            # overlapped mode: install the params the background thread
            # pulled while the previous step ran (before this run reads
            # its state)
            join_wait = self._dense_ps_join_pending(dense_ps, scope)
            t_step0 = time.perf_counter()
        user_fetch = tuple(_as_fetch_name(f) for f in (fetch_list or []))
        # distributed lookup tables: the plan key takes the feed names
        # before the prefetch adds its rows and ids-to-row maps, and
        # leaves those out even where the overlapped prefetch installed
        # them ahead of this run, so the inline and the overlapped paths
        # share one plan and one entry.  Rows a caller fed with no
        # side-channel ids (a manual prefetch: nothing is pushed) are
        # keyed apart.
        dist_tables = getattr(program, "_distributed_tables", None)
        feed_key_names, manual_prefetch = tuple(sorted(feed)), ()
        if dist_tables:
            side = getattr(program, "_sparse_prefetched_ids", None) or {}
            internal = {n for m in dist_tables.values() for n in (m["rows_name"], m["local_name"])}
            feed_key_names = tuple(sorted(n for n in feed if n not in internal))
            manual_prefetch = tuple(sorted(
                m["rows_name"] for m in dist_tables.values()
                if m["rows_name"] in feed and m["rows_name"] not in side))
        plan_key = (
            program._uid,
            program.version,
            sum(len(b.ops) for b in program.blocks),
            feed_key_names,
            user_fetch,
            steps,
            per_step_feed,
            str(self.device),
            manual_prefetch,
            _penv.generation(),  # a bound ring decides whether its collectives run
        )
        ps_push = self._prefetch_distributed_tables(program, feed) if dist_tables else []
        with self._lock:
            plan = self._plans.get(plan_key) if use_program_cache else None
            if plan is not None:
                stats["plan_hits"] += 1
            else:
                stats["plan_misses"] += 1
                dense_grads = (tuple(d["grad"] for d in dense_ps["params"].values())
                               if dense_ps is not None else ())
                plan = self._analyze(program, tuple(sorted(feed)),
                                     user_fetch + tuple(g for _, _, g in ps_push) + dense_grads,
                                     len(ps_push), len(dense_grads))
                if use_program_cache:
                    self._plans[plan_key] = plan

        if steps != 1 and (ps_push or steps < 1):
            raise ValueError(
                "steps=%d: a run takes steps >= 1, and one step with distributed lookup "
                "tables (the parameter-server pull and push are per batch)" % steps)
        if per_step_feed:
            bad = {n: np.shape(v) for n, v in feed.items() if tuple(np.shape(v)[:1]) != (steps,)}
            if bad:
                raise ValueError(
                    "per_step_feed=True: every feed needs a leading steps=%d axis; got %s"
                    % (steps, bad))
        if compiled is not None:
            compiled._prepare_one_rank(self, scope, plan.state_in + plan.state_out)
        # hot-path: begin dispatch (plan hit -> feed coercion -> entry hit -> replay)
        if rec or led is not None:
            t0 = time.perf_counter()
        feeds = {n: self._coerce_feed(feed[n], plan.feed_dtypes.get(n)) for n in plan.feed_names}
        if led is not None:
            led.charge("h2d", time.perf_counter() - t0)
        if rec:
            _mon_spans.record_span("executor/h2d_feed", t0, time.perf_counter() - t0,
                                   cat="transfer", n_feeds=len(feeds))

        if scope.__dict__.get("_mesh_committed"):
            self._check_mesh_committed(scope, plan)
        state, missing = {}, []
        for n in plan.state_in:
            v = scope.vars.get(n)
            if v is None:
                missing.append(n)
            else:
                state[n] = v
        if missing:
            raise RuntimeError(
                "Variables %s are not initialized in scope — run the startup "
                "program first (reference: executor.py run startup)" % missing)

        feed_sig = tuple((n, tuple(t.shape), t.dtype) for n, t in feeds.items())
        key = (plan_key, feed_sig)
        with self._lock:
            entry = self._cache.get(key) if use_program_cache else None
            if entry is not None:
                stats["hits"] += 1
            else:
                stats["misses"] += 1
                t0 = time.perf_counter()
                entry = _Entry(lowering.lower_block(
                    program.global_block(), plan.feed_names, plan.fetch_names, plan.state_out,
                    self.device))
                if rec:
                    _mon_spans.record_span("executor/lower", t0, time.perf_counter() - t0,
                                           cat="lower", n_ops=len(program.global_block().ops))
                if use_program_cache:
                    self._cache[key] = entry
            overhead = time.perf_counter() - t_run0
            stats["dispatch_overhead_s"] += overhead
        if rec:
            ids = _mon_spans.current_trace_ids()
            _MON_DISPATCH_HIST.observe(
                overhead, exemplar={"trace_id": ids[0]} if ids else None)

        check_nan_inf = flags.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
        n_user = len(plan.fetch_names) - plan.n_push - plan.n_dense
        n_sparse = n_user + plan.n_push
        # the async dense-PS pull of train_from_dataset starts as soon as
        # the step is queued, so it overlaps the step
        overlap = dense_ps is not None and bool(dense_ps.get("overlap_pull")) and not dense_ps["sync"]
        graph_path = (use_program_cache and self.device.type == "cuda" and not plan.eager_ops
                      and all(scope.vars.get(n) is not None for n in plan.state_out))
        if graph_path:
            with entry.lock:  # feeds in, replay, fetches out: one thread at a time
                graph = entry.graph_for(scope)
                captured = graph is None and getattr(entry.warmed, "done", False)
                if captured:
                    t0 = time.perf_counter()
                    graph = self._capture(entry, plan, scope, feeds, per_step_feed)
                    if rec:
                        _mon_spans.record_span("executor/jit_compile", t0,
                                               time.perf_counter() - t0, cat="compile",
                                               steps=steps)
                replayed = graph is not None
                if replayed:
                    t0 = time.perf_counter()
                    fetches = self._replay(graph, scope, feeds, steps, per_step_feed, led)
                    if rec:
                        _mon_spans.record_span("executor/device_execute", t0,
                                               time.perf_counter() - t0, cat="execute",
                                               steps=steps)
                    # hot-path: end dispatch (the replay is queued; everything below may sync)
                    if overlap:
                        self._dense_ps_spawn_pull(dense_ps)
                    if check_nan_inf:
                        _check_nan_inf(list(zip(plan.fetch_names, fetches))
                                       + [(n, graph.bufs[n]) for n in plan.state_out])
                    # the graph's outputs are overwritten by its next
                    # replay: the caller's fetches and the pushed
                    # gradients leave as copies, under the lock
                    t0 = time.perf_counter()
                    grads = [host_copy(g) for g in fetches[n_user:]]
                    if return_numpy:
                        out = [to_numpy(f) for f in fetches[:n_user]]
                    else:
                        out = [f.clone() for f in fetches[:n_user]]
                    if rec:
                        _mon_spans.record_span("executor/d2h_fetch", t0,
                                               time.perf_counter() - t0, cat="transfer",
                                               n_fetch=len(out))
            if replayed:
                self._push_sparse(program, ps_push, grads[:plan.n_push])
                if dense_ps is not None:
                    self._dense_ps_round(dense_ps, scope, grads[plan.n_push:], overlap, t_step0,
                                         join_wait)
                return out
        t0 = time.perf_counter()
        feeds = {n: t.to(self.device, non_blocking=True) for n, t in feeds.items()}
        if led is not None:
            led.charge("h2d", time.perf_counter() - t0)
        t0 = time.perf_counter()
        fetches = _eager(entry.fn, state, feeds, scope, steps, per_step_feed)
        if rec:
            _mon_spans.record_span("executor/device_execute", t0, time.perf_counter() - t0,
                                   cat="execute", steps=steps, eager=True)
        entry.warmed.done = True
        if overlap:
            self._dense_ps_spawn_pull(dense_ps)
        if check_nan_inf:
            _check_nan_inf(list(zip(plan.fetch_names, fetches))
                           + [(n, scope.vars[n]) for n in plan.state_out if n in scope.vars])
        self._push_sparse(program, ps_push, [host_copy(g) for g in fetches[n_user:n_sparse]])
        if dense_ps is not None:
            self._dense_ps_round(dense_ps, scope, [host_copy(g) for g in fetches[n_sparse:]],
                                 overlap, t_step0, join_wait)
        fetches = fetches[:n_user]
        if return_numpy:
            t0 = time.perf_counter()
            out = [to_numpy(f) for f in fetches]
            if rec:
                _mon_spans.record_span("executor/d2h_fetch", t0, time.perf_counter() - t0,
                                       cat="transfer", n_fetch=len(out))
            return out
        if graph_path:
            # a fetch that is a state tensor becomes a graph buffer at the
            # next run, which replays write into in place
            state_ptrs = {t.untyped_storage().data_ptr() for t in state.values()}
            state_ptrs.update(scope.vars[n].untyped_storage().data_ptr()
                              for n in plan.state_out)
            fetches = [f.clone() if f.untyped_storage().data_ptr() in state_ptrs else f
                       for f in fetches]
        return fetches

    def _run_compiled(self, compiled, feed, fetch_list, scope, return_numpy, steps,
                      per_step_feed):
        """``steps`` runs of a compiled program's sharded step on this rank
        (``parallel/compiled_program.py``); the last one's fetches.  The
        sharded step has no parameter-server round, distributed tables or
        pipeline: a program that carries one raises, naming its part."""
        program = compiled._program
        for attr, what in _UNPORTED_PROGRAM_STATE.items():
            if getattr(program, attr, None):
                raise NotImplementedError("%s is not ported to paddle_tpu_torch yet" % what)
        for attr, what in (("_dense_ps_ctx", "a dense parameter-server trainer program"),
                           ("_distributed_tables", "distributed lookup tables")):
            if getattr(program, attr, None):
                raise NotImplementedError(
                    "%s under a CompiledProgram of %d ranks is not ported to "
                    "paddle_tpu_torch yet (ROADMAP A10 part 4); run it uncompiled, one "
                    "trainer a process" % (what, compiled.mesh.size))
        if steps < 1:
            raise ValueError("steps=%d: a run takes steps >= 1" % steps)
        fetch_names = tuple(_as_fetch_name(f) for f in (fetch_list or []))
        out = []
        for i in range(steps):
            step_feed = {n: v[i] for n, v in feed.items()} if per_step_feed else feed
            out = compiled._execute(self, step_feed, fetch_names, scope, return_numpy)
        return out

    def _check_mesh_committed(self, scope, plan) -> None:
        """An uncompiled run over state that a compiled run left as this
        rank's shards: gather it back once (``reshard_on_gather``) or raise
        the typed ``MeshCommittedStateError``."""
        committed = scope.__dict__["_mesh_committed"]
        hit = sorted(n for n in set(plan.state_in) | set(plan.state_out)
                     if n in committed and committed[n][1] is scope.vars.get(n))
        if not hit:
            return
        if self._reshard_on_gather:
            for n in hit:
                compiled, local = committed.pop(n)
                scope.vars[n] = compiled.gather_state(n, local)
            return
        from paddle_tpu_torch.sharding.rules import MeshCommittedStateError

        descs = ["%r on %s" % (n, dict(committed[n][0].mesh.shape)) for n in hit[:4]]
        more = len(hit) - len(descs)
        raise MeshCommittedStateError(
            "running this program UNCOMPILED, but its scope state holds this rank's "
            "shards, placed by a previous compiled run: %s%s. Run it through the same "
            "CompiledProgram, or opt into a one-time gather with "
            "Executor(reshard_on_gather=True) / PADDLE_TPU_RESHARD_ON_GATHER=1."
            % ("; ".join(descs), " (+%d more)" % more if more > 0 else ""))

    # ------------------------------------------------------------------
    def _capture(self, entry: _Entry, plan: _RunPlan, scope: Scope, feeds,
                 per_step_feed) -> _Graph:
        """Capture one step of ``entry`` into a CUDA graph against
        ``scope``'s tensors.  A failure raises: there is no quiet fall
        back to the interpreter."""
        bufs = {n: scope.vars[n] for n in plan.state_in + plan.state_out}
        feed_bufs = {n: torch.empty(tuple(t.shape[1:]) if per_step_feed else tuple(t.shape),
                                    dtype=t.dtype, device=self.device)
                     for n, t in feeds.items()}
        # values the graph writes back must not alias a buffer that an
        # earlier write-back in the same graph overwrites
        buf_ptrs = {b.untyped_storage().data_ptr() for b in bufs.values()}
        graph = torch.cuda.CUDAGraph()
        gc_was_enabled = gc.isenabled()
        with self._capture_lock:
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            stream = self._capture_stream
            # no cyclic collection on this thread while it captures: one
            # could free another graph held in dead cycles (an old
            # executor's), and destroying a graph invalidates the capture
            gc.disable()
            try:
                # "thread_local": the serving worker captures while other
                # threads may make CUDA calls (another executor's sync, a
                # host copy) that are legal outside this capture; this
                # thread's own calls are still checked
                with kernels.recording(stream.cuda_stream) as tally, \
                        torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"), \
                        torch.no_grad():
                    # read after the capture's own empty_cache, from the
                    # allocator's books (no CUDA call)
                    reserved = torch.cuda.memory_reserved(self.device)
                    fetches, new_state = entry.fn({n: bufs[n] for n in plan.state_in}, feed_bufs)
                    new_state = {n: v.clone() if v.untyped_storage().data_ptr() in buf_ptrs else v
                                 for n, v in new_state.items()}
                    for n, v in new_state.items():
                        bufs[n].copy_(v.reshape(bufs[n].shape))
            finally:
                if gc_was_enabled:
                    gc.enable()
            pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        captured = _Graph(scope, graph, bufs, feed_bufs, list(fetches), dict(tally), pool_bytes)
        entry.graphs[id(scope)] = captured
        return captured

    def _replay(self, graph: _Graph, scope: Scope, feeds, steps, per_step_feed, led=None):
        """Bring a tensor replaced in the graph's scope into its buffer,
        copy the feeds in, and replay the graph ``steps`` times.  An armed
        ledger is charged the feeds' copies as ``h2d``."""
        for n, buf in graph.bufs.items():
            cur = scope.vars.get(n)
            if cur is buf:
                continue
            if cur is None:
                raise RuntimeError("state %r was removed from the scope" % n)
            if cur.numel() != buf.numel():
                raise ValueError(
                    "state %r was replaced with shape %s; the captured step holds %s"
                    % (n, tuple(cur.shape), tuple(buf.shape)))
            buf.copy_(cur.reshape(buf.shape))
            scope.vars[n] = buf  # the buffer was this scope's tensor at capture
        t0 = time.perf_counter()
        if per_step_feed:
            feeds = {n: t.to(self.device, non_blocking=True) for n, t in feeds.items()}
        for i in range(steps):
            if per_step_feed or i == 0:
                for n, buf in graph.feeds.items():
                    buf.copy_(feeds[n][i] if per_step_feed else feeds[n], non_blocking=True)
                if led is not None:
                    led.charge("h2d", time.perf_counter() - t0)
            graph.graph.replay()
            t0 = time.perf_counter()
        kernels.add_launches(graph.launches, steps)
        return graph.fetches

    # ------------------------------------------------------------------
    # Distributed lookup tables: the sparse prefetch and push (reference:
    # parameter_prefetch.cc + the trainer-side send of SelectedRows
    # grads).  PS pulls run on the host per batch, the tables
    # concurrently; in async mode train_from_dataset overlaps batch N+1's
    # pulls with batch N's step.
    # ------------------------------------------------------------------
    @staticmethod
    def _sparse_expand_ids(meta, ids_val, ladder=None):
        """Unique + bucket one table's batch ids.  Returns
        ``(uniq_padded, n_uniq, counts, local)``: the bucketed unique
        ids (padded by repeating the first, which receives no gradient —
        no local index maps to the pad — so its push is a no-op), the
        real unique count, per-unique occurrence counts, and the int32
        ids-to-row map shaped like the feed (less a trailing 1 where the
        table was built on ``[..., 1]`` ids).  ``ladder``: an explicit
        unique-count bucket ladder; counts above its top rung, or no
        ladder, take ``pow2_id_bucket``."""
        ids_val = _host_ids(ids_val)
        flat = ids_val.reshape(-1).astype(np.int64)
        uniq, inv, counts = np.unique(flat, return_inverse=True, return_counts=True)
        n = len(uniq)
        bucket = next((int(r) for r in ladder or () if int(r) >= n), None)
        if bucket is None:
            bucket = pow2_id_bucket(n)
        fill = uniq[0] if n else 0
        uniq_p = np.concatenate([uniq, np.full(bucket - n, fill, np.int64)])
        local = inv.astype(np.int32)
        if meta["squeeze_last"] and ids_val.ndim >= 2 and ids_val.shape[-1] == 1:
            local = local.reshape(ids_val.shape[:-1])
        else:
            local = local.reshape(ids_val.shape)
        return uniq_p, n, counts, local

    @staticmethod
    def _record_uniq_count(program, n: int) -> None:
        """Per-batch unique-id-count histogram (``program._uniq_id_hist``,
        the id-ladder autotuner's input)."""
        hist = program.__dict__.setdefault("_uniq_id_hist", {})
        hist[n] = hist.get(n, 0) + 1

    def _sparse_client_pool(self, program, n: int):
        """``n`` dedicated PSClients for concurrent per-table pulls (a
        PSClient socket is not thread-safe: interleaved frames corrupt
        the wire), pooled on the program.  None when the bound client
        has no endpoints to dial (a stub): the caller pulls serially."""
        endpoints = getattr(getattr(program, "_ps_client", None), "endpoints", None)
        if not endpoints:
            return None
        from paddle_tpu_torch.distributed.ps import PSClient

        pool = program.__dict__.setdefault("_sparse_pull_pool", [])
        while len(pool) < n:
            pool.append(PSClient(list(endpoints)))
        return pool[:n]

    @staticmethod
    def _pull_one_table(client, cache, job):
        """One job's rows: through the hot-id embedding cache when one is
        bound (``program._embedding_cache``), else from the server."""
        meta, uniq_p, n_uniq, counts = job[:4]
        if cache is not None:
            rows = cache.lookup_through(client, meta["table"], uniq_p, n_valid=n_uniq,
                                        counts=counts)
        else:
            rows = client.pull_sparse(meta["table"], uniq_p)
        return np.asarray(rows, np.float32)

    def _fanout_table_pulls(self, jobs, clients, cache):
        """Job 0 on the calling thread with ``clients[0]``, the others on
        worker threads, each with a client of its own.  Returns
        ``(rows by rows name, [(error, client)])``."""
        results: Dict[str, np.ndarray] = {}
        errors = []

        def work(job, cl):
            try:
                results[job[0]["rows_name"]] = self._pull_one_table(cl, cache, job)
            except BaseException as e:  # noqa: BLE001 — the caller re-raises
                errors.append((e, cl))

        threads = [threading.Thread(target=work, args=(job, cl), name="ptpu-sparse-pull",
                                    daemon=True)
                   for job, cl in zip(jobs[1:], clients[1:])]
        for th in threads:
            th.start()
        work(jobs[0], clients[0])
        for th in threads:
            th.join()
        return results, errors

    def _pull_tables_concurrent(self, program, client, cache, jobs):
        """Every job's ``pull_sparse`` at once (job 0 on this thread with
        the bound client, the rest on pool clients).  The first error
        propagates after all joins, with its pool client closed and
        dropped (the next pull redials)."""
        pool = self._sparse_client_pool(program, len(jobs) - 1) if len(jobs) > 1 else []
        if pool is None:
            return {job[0]["rows_name"]: self._pull_one_table(client, cache, job)
                    for job in jobs}
        results, errors = self._fanout_table_pulls(jobs, [client] + pool, cache)
        if errors:
            pool_list = program.__dict__.get("_sparse_pull_pool", [])
            for _, cl in errors:
                if cl is not client:
                    try:
                        cl.close()
                    finally:
                        if cl in pool_list:
                            pool_list.remove(cl)
            raise errors[0][0]
        return results

    def _prefetch_distributed_tables(self, program, feed):
        """Put each distributed table's rows for this batch's unique ids,
        and the ids-to-row map, into ``feed``.  Returns ``[(table,
        padded unique ids, rows gradient name)]`` for the tables whose
        gradient the program computes (training), which ``run`` pushes
        after the step.  Rows already in the feed came from the
        overlapped prefetch (its side channel carries the unique ids, so
        the push still happens) or from a manual caller (no push)."""
        dist_tables = program._distributed_tables
        block = program.global_block()
        side = getattr(program, "_sparse_prefetched_ids", None)
        ladder = getattr(program, "_sparse_id_ladder", None)
        ps_push, pulls = [], []
        for meta in dist_tables.values():
            rows_name = meta["rows_name"]
            gname = framework.grad_var_name(rows_name)
            has_grad = block._find_var_recursive(gname) is not None
            if rows_name in feed:
                if side and rows_name in side:
                    uniq_p = side.pop(rows_name)
                    if has_grad:
                        ps_push.append((meta["table"], uniq_p, gname))
                continue
            if meta["ids_name"] not in feed:
                raise RuntimeError(
                    "distributed table %r needs ids var %r in the feed "
                    "(prefetch happens host-side per batch)" % (meta["table"], meta["ids_name"]))
            uniq_p, n_uniq, counts, local = self._sparse_expand_ids(
                meta, feed[meta["ids_name"]], ladder)
            self._record_uniq_count(program, n_uniq)
            feed[meta["local_name"]] = local
            if has_grad:
                ps_push.append((meta["table"], uniq_p, gname))
            pulls.append((meta, uniq_p, n_uniq, counts, local))
        if pulls:
            client = getattr(program, "_ps_client", None)
            if client is None:
                raise RuntimeError(
                    "program has distributed lookup tables; call "
                    "paddle_tpu_torch.distributed.bind_distributed_tables("
                    "program, endpoints) before running it")
            rows = self._pull_tables_concurrent(
                program, client, getattr(program, "_embedding_cache", None), pulls)
            for job in pulls:
                feed[job[0]["rows_name"]] = rows[job[0]["rows_name"]]
        return ps_push

    @staticmethod
    def _push_sparse(program, ps_push, grads) -> None:
        """Push each prefetched table's row gradients (host arrays): onto
        the Communicator's queue in async mode, else blocking.  A bound
        embedding cache drops the pushed rows after the server applied
        them: the blocking push invalidates once it returns, the async
        one from the Communicator's send thread after each applied merge
        (``on_pushed``).  Dropping them earlier would let a concurrent
        read-through cache the rows from before the update for good."""
        if not ps_push:
            return
        comm = getattr(program, "_ps_communicator", None)
        client = getattr(program, "_ps_client", None)
        cache = getattr(program, "_embedding_cache", None)
        if comm is not None and cache is not None:
            comm.on_pushed = cache.invalidate_ids
        for (table, uniq, _), grad in zip(ps_push, grads):
            if comm is not None:
                comm.push(table, uniq, grad)
            else:
                client.push_sparse(table, uniq, grad)
                if cache is not None:
                    cache.invalidate_ids(table, uniq)

    # ------------------------------------------------------------------
    # The dense parameter server (reference: distribute_transpiler.py's
    # trainer side + listen_and_serv_op.cc's server loop): a trainer
    # program of DistributeTranspiler carries ``_dense_ps_ctx``, its
    # pserver program ``_pserver_ctx``.
    # ------------------------------------------------------------------
    last_dense_ps_round = None  # the last dense-PS run's host seconds by part

    @staticmethod
    def _dense_ps_client(ctx):
        client = ctx.get("_client")
        if client is None:
            from paddle_tpu_torch.distributed.ps import PSClient

            client = ctx["_client"] = PSClient(ctx["endpoints"])
        return client

    @staticmethod
    def _dense_ps_pull_client(ctx):
        # the overlapped pull runs on its own thread beside the main
        # thread's push, and a PSClient socket is not thread-safe
        # (interleaved frames corrupt the wire): a client of its own
        client = ctx.get("_pull_client")
        if client is None:
            from paddle_tpu_torch.distributed.ps import PSClient

            client = ctx["_pull_client"] = PSClient(ctx["endpoints"])
        return client

    def _dense_ps_init(self, ctx, scope) -> None:
        """First-run handshake: create the server-side entries, trainer 0
        seeds its initial param values (deterministic broadcast), everyone
        pulls the seeded copy — the reference pserver startup + initial
        recv (distribute_transpiler.py get_startup_program)."""
        if ctx["initialized"]:
            return
        client = self._dense_ps_client(ctx)
        for name, desc in ctx["params"].items():
            val = scope.get(name)
            if val is None:
                raise RuntimeError(
                    "dense PS param %r not in scope — run the startup program first" % name)
            client.create_dense(name, tuple(val.shape), optimizer=desc["optimizer"],
                                attrs=desc["attrs"], n_trainers=ctx["n_trainers"],
                                sync=ctx["sync"])
            if ctx["trainer_id"] == 0:
                client.seed_dense(name, to_numpy(val))
            scope.set(name, client.pull_dense(name, min_version=0))
        ctx["initialized"] = True

    def _dense_ps_round(self, ctx, scope, grads, overlap, t_step0, join_wait) -> None:
        """Push every gradient (host copies), then, unless the overlapped
        pull is on its way, pull every parameter: in sync mode the pull
        waits for the server to apply all trainers' gradients of this
        step, so pushing all first is what keeps a trainer from waiting on
        itself (reference: send_barrier -> send -> recv,
        distribute_transpiler.py:320).  ``last_dense_ps_round`` keeps the
        run's host seconds: the step up to its gradients' host copies, the
        push, and the pull (or, overlapped, the wait at this run's join)."""
        t0 = time.perf_counter()
        client = self._dense_ps_client(ctx)
        names = list(ctx["params"])
        lrs: Dict[str, float] = {}  # one host read a learning-rate var
        for name, grad in zip(names, grads):
            lr_var = ctx["params"][name]["lr_var"]
            if lr_var not in lrs:
                lr_val = scope.get(lr_var)
                lrs[lr_var] = float(to_numpy(lr_val).reshape(-1)[0]) if lr_val is not None else 0.1
            client.push_dense(name, grad, lrs[lr_var])
        ctx["step"] += 1
        t1 = time.perf_counter()
        if not overlap:
            min_v = ctx["step"] if ctx["sync"] else 0
            for name in names:
                scope.set(name, client.pull_dense(name, min_version=min_v))
            led = self._train_ledger
            if led is not None:  # the blocking pull is PS wire wait, not device time
                led.charge("ps_wait", time.perf_counter() - t1)
        self.last_dense_ps_round = {"step_s": t0 - t_step0, "push_s": t1 - t0,
                                    "pull_wait_s": join_wait if overlap else time.perf_counter() - t1,
                                    "overlapped": overlap}

    def _dense_ps_spawn_pull(self, ctx) -> None:
        """Start the next step's param pull on a background thread (one in
        flight at a time: ``run`` joins the previous one first).  A
        transient failure (a refused or reset connection) closes the
        thread's client, redials on a fresh one and retries under the pull
        RetryPolicy; any error surfaces at the join, with the failing
        client's sockets closed."""
        from paddle_tpu_torch.distributed.ps import PSClient

        names = list(ctx["params"])
        client = self._dense_ps_pull_client(ctx)
        result: Dict[str, Any] = {}
        budget = self._ps_pull_policy().budget(op="ps.pull")

        def pull():
            nonlocal client
            t0 = time.perf_counter()
            try:
                while True:
                    try:
                        result["vals"] = {n: client.pull_dense(n, min_version=0) for n in names}
                        return
                    except _PS_PULL_RETRYABLE:
                        try:
                            client.close()
                        finally:
                            ctx.pop("_pull_client", None)
                        if not budget.backoff():
                            raise
                        client = ctx["_pull_client"] = PSClient(ctx["endpoints"])
            except BaseException as e:  # noqa: BLE001 — re-raised at the join
                result["exc"] = e
            finally:
                result["dur"] = time.perf_counter() - t0

        th = threading.Thread(target=pull, name="ptpu-ps-pull", daemon=True)
        ctx["_pull_pending"] = (th, result)
        th.start()

    def _dense_ps_join_pending(self, ctx, scope) -> float:
        """Join the in-flight overlapped pull, if any, install the pulled
        params and return the seconds waited.  ``ps_pull_overlap_s`` counts
        the pull seconds that hid behind the step, ``ps_pull_wait_s`` what
        this join waited; an armed ledger is charged the wait as
        ``ps_wait``."""
        pending = ctx.pop("_pull_pending", None)
        if pending is None:
            return 0.0
        th, result = pending
        t0 = time.perf_counter()
        th.join()
        wait = time.perf_counter() - t0
        with self._lock:
            self._cache_stats["ps_pull_wait_s"] += wait
            self._cache_stats["ps_pull_overlap_s"] += max(0.0, result.get("dur", 0.0) - wait)
        led = self._train_ledger
        if led is not None:
            led.charge("ps_wait", wait)
        if "exc" in result:
            raise result["exc"]
        for n, v in result["vals"].items():
            scope.set(n, v)
        return wait

    def _run_pserver(self, program):
        """Serve the dense params hashed to this endpoint and block, like
        the reference's listen_and_serv op.  The live server is
        ``program._pserver``, so its caller can stop it.  A server keeps its
        parameters and their optimizer state in host memory: it never
        touches the executor's device."""
        from paddle_tpu_torch.distributed.ps import ParameterServer, PSClient, _DenseParam

        ctx = program._pserver_ctx
        server = ParameterServer(ctx["endpoint"])
        # register this shard's dense params directly (no wire round-trip;
        # the placement is the trainer-side PSClient.shard_for)
        placer = PSClient(ctx["endpoints"])
        my_idx = ctx["endpoints"].index(ctx["endpoint"])
        for name, desc in ctx["params"].items():
            if placer.shard_for(name) != my_idx:
                continue
            server._dense[name] = _DenseParam(
                desc["shape"], optimizer=desc["optimizer"], attrs=desc["attrs"],
                n_trainers=ctx["n_trainers"], sync=ctx["sync"])
        program._pserver = server
        server.start()
        try:
            server._thread.join()
        except KeyboardInterrupt:
            server.stop()
        return []

    # the overlapped sparse prefetch of async mode: batch N+1's pulls run
    # on a background thread while batch N steps (bounded staleness 1,
    # which async mode accepts; sync mode keeps the strict pull-after-push
    # order)
    _PS_PULL_POLICY = None  # built at first use

    @classmethod
    def _ps_pull_policy(cls):
        if cls._PS_PULL_POLICY is None:
            from paddle_tpu_torch.faults.retry import RetryPolicy

            cls._PS_PULL_POLICY = RetryPolicy(
                max_attempts=4, base_delay_s=0.05, multiplier=2.0, max_delay_s=1.0)
        return cls._PS_PULL_POLICY

    @staticmethod
    def _sparse_overlap_clients(ctx, endpoints, n: int):
        """The overlap thread's own clients, one per table: never the
        caller's, nor the inline pool's."""
        from paddle_tpu_torch.distributed.ps import PSClient

        pool = ctx.setdefault("clients", [])
        while len(pool) < n:
            pool.append(PSClient(list(endpoints)))
        return pool[:n]

    @staticmethod
    def _sparse_overlap_close(ctx) -> None:
        for cl in ctx.pop("clients", []):
            cl.close()

    def _sparse_spawn_prefetch(self, program, feed) -> None:
        """Start ``feed``'s table pulls on a background thread (one in
        flight at a time).  A transient failure closes the thread's
        clients, redials and retries under the pull RetryPolicy; on
        exhaustion the error surfaces at the join."""
        ladder = getattr(program, "_sparse_id_ladder", None)
        cache = getattr(program, "_embedding_cache", None)
        endpoints = getattr(getattr(program, "_ps_client", None), "endpoints", None)
        jobs = []
        for meta in program._distributed_tables.values():
            if meta["rows_name"] in feed or meta["ids_name"] not in feed:
                continue
            uniq_p, n, counts, local = self._sparse_expand_ids(meta, feed[meta["ids_name"]], ladder)
            self._record_uniq_count(program, n)
            jobs.append((meta, uniq_p, n, counts, local))
        if not jobs or not endpoints:
            return
        ctx = program.__dict__.setdefault("_sparse_overlap_ctx", {})
        result: Dict[str, Any] = {}
        budget = self._ps_pull_policy().budget(op="ps.pull")

        def pull():
            t0 = time.perf_counter()
            try:
                while True:
                    try:
                        clients = self._sparse_overlap_clients(ctx, endpoints, len(jobs))
                        vals, errs = self._fanout_table_pulls(jobs, clients, cache)
                        if errs:
                            raise errs[0][0]
                        result["vals"] = vals
                        return
                    except _PS_PULL_RETRYABLE:
                        self._sparse_overlap_close(ctx)  # redial on a fresh set
                        if not budget.backoff():
                            raise
            except BaseException as e:  # noqa: BLE001 — re-raised at the join
                result["exc"] = e
            finally:
                result["dur"] = time.perf_counter() - t0

        th = threading.Thread(target=pull, name="ptpu-sparse-prefetch", daemon=True)
        ctx["pending"] = (th, result, jobs)
        th.start()

    def _sparse_join_prefetch(self, program, feed) -> None:
        """Join the in-flight prefetch and put its rows and ids-to-row maps
        into ``feed``; the unique ids ride the ``_sparse_prefetched_ids``
        side channel so that the next ``run`` pushes this batch's
        gradients.  ``ps_pull_overlap_s`` counts the pull seconds that hid
        behind the step, ``ps_pull_wait_s`` what this join waited."""
        ctx = program.__dict__.get("_sparse_overlap_ctx")
        pending = ctx.pop("pending", None) if ctx else None
        if pending is None:
            return
        th, result, jobs = pending
        t0 = time.perf_counter()
        th.join()
        wait = time.perf_counter() - t0
        with self._lock:
            self._cache_stats["ps_pull_wait_s"] += wait
            self._cache_stats["ps_pull_overlap_s"] += max(0.0, result.get("dur", 0.0) - wait)
        if "exc" in result:
            raise result["exc"]
        side = program.__dict__.setdefault("_sparse_prefetched_ids", {})
        for meta, uniq_p, _n, _counts, local in jobs:
            feed[meta["rows_name"]] = result["vals"][meta["rows_name"]]
            feed[meta["local_name"]] = local
            side[meta["rows_name"]] = uniq_p

    def _sparse_overlap_iter(self, program, batches):
        """One-step lookahead: spawn batch N+1's pulls before yielding
        batch N, join and install them when the consumer asks for N+1.
        Every exit joins the pending thread and closes the overlap
        clients.  Each batch is a copy: the caller's dicts never see the
        installed rows (a second epoch over them would otherwise look
        manually prefetched, and push nothing)."""
        ctx = program.__dict__.setdefault("_sparse_overlap_ctx", {})
        it = iter(batches)

        def pull_next():
            nxt = next(it, None)
            return dict(nxt) if isinstance(nxt, dict) else nxt

        try:
            cur = pull_next()
            if cur is None:
                return
            while True:
                nxt = pull_next()
                if nxt is not None:
                    self._sparse_spawn_prefetch(program, nxt)
                yield cur
                if nxt is None:
                    return
                self._sparse_join_prefetch(program, nxt)
                cur = nxt
        finally:
            pending = ctx.pop("pending", None)
            if pending is not None:
                pending[0].join()  # abandoned mid-epoch: drain the thread; its error is moot
            self._sparse_overlap_close(ctx)
            program.__dict__.pop("_sparse_prefetched_ids", None)
            closer = getattr(it, "close", None)
            if closer is not None:
                closer()

    # ------------------------------------------------------------------
    def train_from_dataset(self, program=None, dataset=None, scope=None, thread=0, debug=False,
                           fetch_list=None, fetch_info=None, print_period=100,
                           trainer_desc=None, trace_id=None, checkpoint_dir=None,
                           checkpoint_every=0, checkpoint_epoch=0, resume_from=None,
                           checkpoint_async=False, phase_ledger=None, watchdog=None,
                           train_log=None):
        """Loop the dataset's batches through ``run`` (reference:
        executor.py train_from_dataset -> the C++ Trainer/DeviceWorker
        loop, trainer.h:38; here the cached step is the device worker).
        Returns each step's fetches (numpy), when ``fetch_list`` is given.

        ``trainer_desc`` (trainer_desc.py) supplies the fetch config and
        checks that its device worker fits the program (Section needs a
        PipelineOptimizer-cut program, DownpourSGD distributed lookup
        tables; DownpourSGD installs the async Communicator).
        ``thread=N`` (N > 1) prefetches N batches ahead on a background
        thread through ``reader.device_buffered``, staged on the
        executor's device: on the card for a CUDA executor (raising
        where there is none), on the host for a ``CPUPlace`` one; a
        distributed table's ids stay on the host, where each batch's
        unique ids are taken.  With distributed tables in async mode (a
        Communicator bound), batch N+1's pulls overlap batch N's step; on
        an async dense-PS program, each step's parameter pull overlaps the
        step (``ps_pull_overlap_s``), and the loop joins the last one
        before it returns.

        Crash-resumable training, exact to a step:
        ``checkpoint_dir`` + ``checkpoint_every=N`` commits an atomic
        checkpoint every N completed steps — the program's persistables,
        the PS sparse tables (when the program is bound to a
        ``PSClient``), and the dataset cursor, all via tmp+rename
        (``faults.checkpoint.TrainCheckpoint``).  A killed run restarted
        with ``resume_from=<same dir>`` restores all three and skips the
        consumed batches before any prefetch stages them, so it
        continues within one checkpoint interval of where it died;
        ``last_resume_step`` reports the restored cursor,
        ``last_restore_path`` and ``last_restore_fallbacks`` which
        checkpoint served it.  ``resume_from`` and a different
        ``checkpoint_dir`` fork the run: restore from one, save to the
        other.  The Communicator's queued pushes are flushed before each
        save.  ``checkpoint_async=True`` leaves the step only the
        snapshot (a host copy of the state, complete before the next
        step can write it in place); a background thread writes and
        commits, and the epoch joins the tail save before returning.
        ``last_checkpoints`` lists this epoch's saves.

        Request-scoped tracing: the epoch mints a trace id (or joins
        ``trace_id``) readable back via ``last_train_trace_id``; while a
        trace session or flight recorder is live, every step runs under
        that id inside an ``executor/train_step`` span parented to one
        ``executor/train_epoch`` span.

        Training control tower (monitor/train.py):
        ``phase_ledger=True`` (or a ``StepPhaseLedger``) attributes every
        wall-clock second of the epoch to data_wait / h2d /
        device_execute / ps_wait / checkpoint / restore_fallback / other
        (``train_phase_seconds_total{phase=}``, throughput and MFU
        gauges), asserted to sum to the elapsed time within 1%.  A step's
        device time is seen by the host where ``run`` copies a fetch out,
        so fetch the loss for the step's device time to land in its own
        ``device_execute``.  ``watchdog=True`` (or a ``TrainWatchdog``)
        runs EWMA + z-score anomaly detection per step, emitting
        ``train/anomaly`` events and raising ``TrainAnomalyError`` for
        kinds in its ``halt_on``.  ``train_log=<path>`` streams one JSONL
        record per step (``monitor.train.replay_step_log`` reads it).
        ``start_train_admin()`` serves it all at ``/trainz``.

        A compiled (multi-device) program is ROADMAP A10 part 4 and
        raises; ``Executor.run`` runs its steps."""
        if program is not None and getattr(program, "_is_compiled_program", False):
            raise NotImplementedError(
                "train_from_dataset over a compiled (multi-device) program is ROADMAP A10 "
                "part 4, not ported to paddle_tpu_torch yet; run its steps with Executor.run")
        program = program if program is not None else framework.default_main_program()
        n_prefetch = int(thread)
        if trainer_desc is not None:
            worker = trainer_desc._worker
            if worker.worker_kind == "Section" and not getattr(program, "_pipeline_plan", None):
                raise ValueError("Section worker needs a PipelineOptimizer(cut_list=...) program")
            if (worker.worker_kind == "DownpourSGD"
                    and not getattr(program, "_distributed_tables", None)):
                raise ValueError("DownpourSGD worker needs embedding(is_distributed=True) tables")
            worker._prepare(program)
            fetch_list = fetch_list or trainer_desc._fetch_vars
            fetch_info = fetch_info or trainer_desc._fetch_info
            print_period = trainer_desc._print_period
            n_prefetch = n_prefetch or int(getattr(trainer_desc, "thread_num", 0))
        scope = scope if scope is not None else global_scope()
        # training control tower: the ledger's epoch window opens HERE so
        # a resume restore below is attributed (restore_fallback) inside
        # the wall clock its 1% sum contract covers
        led = None
        if phase_ledger:
            led = (phase_ledger if isinstance(phase_ledger, _mon_train.StepPhaseLedger)
                   else _mon_train.StepPhaseLedger(device=self.device))
            self.last_train_ledger = led
            led.begin_epoch()
        wd = None
        if watchdog:
            wd = (watchdog if isinstance(watchdog, _mon_train.TrainWatchdog)
                  else _mon_train.TrainWatchdog())
            self.last_train_watchdog = wd
        steplog = None
        if train_log:
            steplog = _mon_train.StepLog(train_log)
            self.last_train_log = train_log
        # crash-resume: restore persistables + PS tables + the dataset
        # cursor BEFORE the first batch, then skip the consumed prefix
        ckpt = None
        start_step = 0
        self.last_resume_step = None
        self.last_restore_path = None
        self.last_restore_fallbacks = 0
        self.last_restore_stats = None
        self.last_checkpoints = []
        if checkpoint_dir is not None or resume_from is not None:
            from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint

            ckpt = TrainCheckpoint(checkpoint_dir or resume_from,
                                   every_n_steps=int(checkpoint_every))
            if resume_from is not None:
                src = (ckpt if checkpoint_dir in (None, resume_from)
                       else TrainCheckpoint(resume_from))
                scope.bind_device(self.device)
                tok = led.window_begin() if led is not None else None
                cursor = src.restore(program, scope,
                                     ps_client=getattr(program, "_ps_client", None))
                if tok is not None:
                    led.window_end(tok, "restore_fallback")
                self.last_restore_path = src.last_restore_path
                self.last_restore_fallbacks = src.last_restore_fallbacks
                self.last_restore_stats = src.last_restore_stats
                if cursor is not None:
                    start_step = int(cursor.get("step", 0))
                    self.last_resume_step = start_step
                _mon_events.emit(
                    "train/resume",
                    severity="warning" if self.last_restore_fallbacks else "info",
                    message="resumed from %s at step %d (%d fallback(s))"
                    % (self.last_restore_path, start_step, self.last_restore_fallbacks),
                    cat="train", step=start_step, path=self.last_restore_path,
                    fallbacks=self.last_restore_fallbacks)
        batches = iter(dataset)
        if start_step:
            # skip the consumed batches before the prefetch, which would
            # otherwise stage them on the card
            batches = itertools.islice(batches, start_step, None)
        tables = getattr(program, "_distributed_tables", None) or {}
        if n_prefetch > 1:
            from paddle_tpu_torch import reader

            # a distributed table's ids stay on the host, where every
            # batch expands them: staged, they would come back each step
            batches = reader.device_buffered(
                batches, size=n_prefetch,
                device=self.device if self.device.type == "cuda" else None,
                host_names=[m["ids_name"] for m in tables.values()])()
        if tables and getattr(program, "_ps_communicator", None) is not None:
            batches = self._sparse_overlap_iter(program, batches)
        if led is not None:
            batches = led.timed_iter(batches)
        # dense-PS async mode: each step's param pull overlaps the step (the
        # pull thread runs while the card works; ps_pull_overlap_s counts
        # the hidden seconds).  Sync mode keeps the strict barrier order,
        # so the flag arms async runs only, and only for this loop.
        ps_ctx = getattr(program, "_dense_ps_ctx", None)
        overlap_prev = None
        if ps_ctx is not None and not ps_ctx.get("sync", True):
            overlap_prev = ps_ctx.get("overlap_pull")
            ps_ctx["overlap_pull"] = True
        # the epoch trace id: minted per call (or joined via trace_id=);
        # the epoch span id parents every step span
        tid = trace_id or _mon_flight.new_trace_id()
        self.last_train_trace_id = tid
        epoch_sid = epoch_t0 = None
        n_steps = 0
        results = []
        monitoring = led is not None or wd is not None or steplog is not None
        self._train_ledger = led  # arm run()'s phase charges (or clear)
        t_prev = time.perf_counter()
        try:
            for i, feed in enumerate(batches):
                step = start_step + i  # the global step (resume-aware cursor)
                if _mon_spans.recording():
                    if epoch_sid is None:
                        epoch_sid = _mon_spans.new_span_id()
                        epoch_t0 = time.perf_counter()
                    t0 = time.perf_counter()
                    with _mon_spans.trace_context((tid,)):
                        with _mon_spans.parent_scope(epoch_sid):
                            with _mon_spans.parent_scope() as step_sid:
                                out = self.run(program, feed=feed, fetch_list=fetch_list,
                                               scope=scope)
                            _mon_spans.record_span(
                                "executor/train_step", t0, time.perf_counter() - t0,
                                cat="train", span_id=step_sid, step=step)
                else:
                    out = self.run(program, feed=feed, fetch_list=fetch_list, scope=scope)
                n_steps += 1
                t_now = time.perf_counter()
                dur, t_prev = t_now - t_prev, t_now  # the step period, data_wait included
                _MON_TRAIN_STEP_HIST.observe(dur, exemplar={"trace_id": tid})
                if fetch_list:
                    results.append(out)
                    if debug and i % print_period == 0:
                        names = fetch_info or [_as_fetch_name(f) for f in fetch_list]
                        print("batch %d:" % step, dict(zip(names, out)))
                        _mon_events.emit(
                            "train/progress", severity="info",
                            message="batch %d: %s" % (step, {
                                n: float(np.mean(v)) for n, v in zip(names, out)
                                if np.issubdtype(np.asarray(v).dtype, np.number)}),
                            cat="train", step=step)
                if monitoring:
                    self._observe_step(program, feed, out, fetch_list, step, dur, led, wd,
                                       steplog, tid)
                if ckpt is not None and ckpt.should_save(step + 1):
                    tok = led.window_begin() if led is not None else None
                    self._train_checkpoint(ckpt, program, scope, step + 1,
                                           int(checkpoint_epoch), bool(checkpoint_async))
                    if tok is not None:
                        # the foreground cost: the quiesce and the (sync)
                        # write or the (async) snapshot
                        led.window_end(tok, "checkpoint", detail="sync")
            if ckpt is not None:
                # commit the tail background save before returning (a
                # write error surfaces here, on the epoch's own path)
                tok = led.window_begin() if led is not None else None
                ckpt.wait()
                if tok is not None:
                    led.window_end(tok, "checkpoint", detail="commit")
            if led is not None:
                led.finish_epoch()  # the remainder lands in `other`; the 1% sum asserted
        finally:
            self._train_ledger = None  # disarm run()'s phase charges
            if led is not None:
                led.finish_epoch(strict=False)  # an exceptional exit keeps its own error
            if steplog is not None:
                steplog.close()
            if ckpt is not None and ckpt.in_flight:
                # abnormal exit with a save still writing: join it; the
                # epoch's primary error stays the one that propagates
                try:
                    ckpt.wait()
                except BaseException:  # noqa: BLE001 — deliberate
                    pass
            if epoch_sid is not None:
                with _mon_spans.trace_context((tid,)):
                    _mon_spans.record_span(
                        "executor/train_epoch", epoch_t0, time.perf_counter() - epoch_t0,
                        cat="train", span_id=epoch_sid, steps=n_steps)
            closer = getattr(batches, "close", None)
            if closer is not None:
                closer()  # stop the prefetch producer and the overlap thread
            if ps_ctx is not None:
                # drain the in-flight dense pull, so the scope leaves with the
                # freshest params and no thread dangles, then close the pull
                # thread's client (a next epoch redials)
                try:
                    self._dense_ps_join_pending(ps_ctx, scope)
                finally:
                    if overlap_prev is None:
                        ps_ctx.pop("overlap_pull", None)
                    else:
                        ps_ctx["overlap_pull"] = overlap_prev
                    pull_client = ps_ctx.get("_pull_client")
                    if pull_client is not None:
                        pull_client.close()
        return results

    @staticmethod
    def _observe_step(program, feed, out, fetch_list, step, dur, led, wd, steplog, tid):
        """One step's control-tower bookkeeping: the ledger's row, the
        watchdog's detectors, the step log's record, then a typed halt."""
        examples = _mon_train.batch_examples(feed)
        loss_val = None
        if out and fetch_list:
            li = wd.loss_index if wd is not None else 0
            try:
                loss_val = float(np.mean(out[li]))
            except (TypeError, ValueError, IndexError):
                loss_val = None
        row = None
        if led is not None:
            if led.flops_per_step is None:
                # the static-FLOPs MFU numerator, resolved once against the
                # first batch's leading dim
                led.flops_per_step = _mon_train.estimate_block_flops(
                    program, batch=max(1, examples))
            row = led.step_done(step, dur, examples=examples, loss=loss_val)
        anomalies = ()
        if wd is not None:
            anomalies = wd.observe_step(step, loss=loss_val, step_time_s=dur)
        if steplog is not None:
            rec = (dict(row) if row is not None
                   else {"step": step, "duration_s": round(dur, 6), "examples": examples})
            if loss_val is not None and "loss" not in rec:
                rec["loss"] = loss_val
            if anomalies:
                rec["anomalies"] = list(anomalies)
            rec["trace_id"] = tid
            steplog.write(rec)
        if wd is not None and anomalies:
            # after the step is logged, so the fatal step is in the record
            wd.raise_if_halt(anomalies)

    def _train_checkpoint(self, ckpt, program, scope, step, epoch, async_=False) -> None:
        """Quiesce, then commit one atomic checkpoint: the overlapped dense
        pull is joined (its params land in the scope first) and the async
        Communicator is flushed (every queued sparse gradient reaches the
        server) so the saved params, PS rows and cursor describe the SAME
        step.  ``async_``: snapshot on this thread, write and commit on the
        checkpoint's background writer."""
        ps_ctx = getattr(program, "_dense_ps_ctx", None)
        if ps_ctx is not None:
            self._dense_ps_join_pending(ps_ctx, scope)
        comm = getattr(program, "_ps_communicator", None)
        if comm is not None:
            comm.flush()
        t0 = time.perf_counter()
        saver = ckpt.save_async if async_ else ckpt.save
        saver(program, scope, step=step, epoch=epoch,
              ps_client=getattr(program, "_ps_client", None))
        self.last_checkpoints.append({"step": int(step), "name": ckpt._name(step),
                                      "mode": "async" if async_ else "sync",
                                      "foreground_s": time.perf_counter() - t0})

    # ------------------------------------------------------------------
    # the training control tower: the trainer's scrapeable surface
    # ------------------------------------------------------------------
    def start_train_admin(self, host: str = "127.0.0.1", port: int = 0):
        """Serve this trainer's observability surface over HTTP
        (``port=0`` = ephemeral; returns the bound ``(host, port)``):
        ``/metrics`` (Prometheus/OpenMetrics with exemplars),
        ``/trainz`` (ledger snapshot + last-N step table + watchdog
        state + checkpoint/resume history), ``/statusz``, ``/tracez``,
        ``/eventz``, ``/healthz``."""
        return _mon_train.start_train_admin(self, host=host, port=port)

    def stop_train_admin(self) -> None:
        _mon_train.stop_train_admin(self)

    @property
    def train_admin_address(self):
        srv = self._train_admin
        return srv.server_address if srv is not None else None

    def trainz(self):
        """The ``/trainz`` document (see ``monitor.train.trainz_doc``)."""
        return _mon_train.trainz_doc(self)

    def infer_from_dataset(self, program=None, dataset=None, scope=None, thread=0, debug=False,
                           fetch_list=None, fetch_info=None, print_period=100):
        """``train_from_dataset`` over an inference program (its fetches,
        no update): the reference's infer_from_dataset."""
        return self.train_from_dataset(program, dataset, scope, thread, debug, fetch_list,
                                       fetch_info, print_period)

    # ------------------------------------------------------------------
    def jit_cache_stats(self) -> Dict[str, Any]:
        """Cache accounting, with the JAX package's keys and meanings.

        ``misses`` counts entries built (a new plan and feed signature);
        ``hits`` counts runs served by an existing entry, whether that run
        captures or replays; ``entries`` is the live entry count.
        ``plan_*`` is the same accounting for the run plans, and
        ``dispatch_overhead_s`` sums the host seconds each run spent
        before its step ran.  ``graphs`` counts the captured CUDA graphs
        of the live entries (one per entry and scope), and
        ``graph_pool_bytes`` the device memory their captures reserved.
        ``ps_pull_overlap_s`` sums the seconds of the overlapped sparse
        and dense-PS pulls that hid behind a step, ``ps_pull_wait_s`` the
        seconds the loop waited for them."""
        with self._lock:
            graphs = [g for e in self._cache.values() for g in list(e.graphs.values())]
        return {
            "entries": len(self._cache),
            "hits": self._cache_stats["hits"],
            "misses": self._cache_stats["misses"],
            "jit_evictions": self._cache_stats["jit_evictions"],
            "plan_entries": len(self._plans),
            "plan_hits": self._cache_stats["plan_hits"],
            "plan_misses": self._cache_stats["plan_misses"],
            "plan_evictions": self._cache_stats["plan_evictions"],
            "dispatch_overhead_s": self._cache_stats["dispatch_overhead_s"],
            "ps_pull_overlap_s": self._cache_stats["ps_pull_overlap_s"],
            "ps_pull_wait_s": self._cache_stats["ps_pull_wait_s"],
            "graphs": len(graphs),
            "graph_pool_bytes": sum(g.pool_bytes for g in graphs),
        }

    def close(self):
        """Drop the caches; release every captured graph and its memory pool."""
        with self._lock:
            for entry in self._cache.values():
                entry.release()
            self._cache.clear()
            self._plans.clear()


class AsyncExecutor:
    """The legacy filelist-driven trainer facade (reference:
    framework/async_executor.h:62 + executor_thread_worker.cc, the
    pre-Trainer API that ran ExecutorThreadWorker threads over a Dataset).
    The cached step is the device worker, so ``run`` builds an
    ``InMemoryDataset`` over the filelist and hands it to
    ``Executor.train_from_dataset``.  The place rule is ``Executor``'s:
    ``cuda:0`` unless given ``CPUPlace()``."""

    def __init__(self, place=None):
        self._exe = Executor(place)

    def run(self, program, data_feed, filelist, thread_num=1, fetch_list=None,
            fetch_info=None, debug=False, mode="", scope=None):
        from paddle_tpu_torch.fluid_dataset import DatasetFactory

        slots = getattr(data_feed, "slots", None)
        if not slots:
            raise ValueError(
                "AsyncExecutor needs a data_feed with a .slots list of the "
                "program's input Variables (DataFeedDesc analog)")
        if isinstance(filelist, str):
            filelist = [filelist]
        dataset = DatasetFactory().create_dataset("InMemoryDataset")
        dataset.set_use_var(slots)
        dataset.set_filelist(list(filelist))
        dataset.load_into_memory()
        return self._exe.train_from_dataset(
            program=program, dataset=dataset, scope=scope,
            fetch_list=fetch_list, fetch_info=fetch_info, debug=debug)
