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
a graph), a run that creates scope state (a var it writes that the
scope does not hold yet, so there is no tensor to write it back into),
and ``use_program_cache=False``.  A capture that fails raises.

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
"""
from __future__ import annotations

import collections
import gc
import threading
import time
import weakref
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import flags, framework, kernels
from paddle_tpu_torch.core import lowering, registry
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.scope import Scope, global_scope, to_numpy

__all__ = ["Executor"]

# cache bounds, as the JAX package's defaults: an ordinary workload never
# evicts; the bound is for programs built in a loop forever
_PLAN_CACHE_CAPACITY = 1024
_ENTRY_CACHE_CAPACITY = 512


def _as_fetch_name(f) -> str:
    return f.name if isinstance(f, framework.Variable) else str(f)


class _RunPlan:
    """The block analysis of one plan key: the feed and fetch names, the
    persistable vars the block reads from the scope (``state_in``) and
    writes back (``state_out``), each feed's torch dtype, and the random
    ops that keep the plan on the interpreter."""

    __slots__ = ("feed_names", "fetch_names", "state_in", "state_out", "feed_dtypes",
                 "random_ops")

    def __init__(self, feed_names, fetch_names, state_in, state_out, feed_dtypes, random_ops):
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.state_in = state_in
        self.state_out = state_out
        self.feed_dtypes = feed_dtypes
        self.random_ops = random_ops


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

    def __init__(self, place: Optional[framework.Place] = None,
                 plan_cache_capacity: Optional[int] = None,
                 jit_cache_capacity: Optional[int] = None):
        self.place = place if place is not None else framework.CUDAPlace(0)
        self.device: torch.device = framework.device_of(place)
        self._cache_stats = {
            "hits": 0, "misses": 0, "plan_hits": 0, "plan_misses": 0,
            "plan_evictions": 0, "jit_evictions": 0, "dispatch_overhead_s": 0.0,
        }
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

    def _analyze(self, program, feed_names, fetch_names) -> _RunPlan:
        """The block's true dataflow reads: a name is read from outside
        only when some op reads it before any op writes it."""
        block = program.global_block()
        persistable = {v.name for v in program.list_vars() if v.persistable}
        read, written = set(), set()
        for op in block.ops:
            for n in op.input_arg_names:
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
        random_ops = tuple(sorted({op.type for op in block.ops
                                   if registry.has_op(op.type) and registry.get_op(op.type).random}))
        return _RunPlan(
            feed_names, fetch_names,
            tuple(sorted((read & persistable) - set(feed_names))),
            tuple(sorted(written & persistable)),
            feed_dtypes, random_ops)

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
        ``i``."""
        t_run0 = time.perf_counter()
        stats = self._cache_stats
        program = program if program is not None else framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        scope.bind_device(self.device)
        feed = dict(feed or {})
        fetch_names = tuple(_as_fetch_name(f) for f in (fetch_list or []))
        plan_key = (
            program._uid,
            program.version,
            sum(len(b.ops) for b in program.blocks),
            tuple(sorted(feed)),
            fetch_names,
            steps,
            per_step_feed,
            str(self.device),
        )
        with self._lock:
            plan = self._plans.get(plan_key) if use_program_cache else None
            if plan is not None:
                stats["plan_hits"] += 1
            else:
                stats["plan_misses"] += 1
                plan = self._analyze(program, tuple(sorted(feed)), fetch_names)
                if use_program_cache:
                    self._plans[plan_key] = plan

        if steps < 1:
            raise ValueError("steps=%d: a run takes steps >= 1" % steps)
        if per_step_feed:
            bad = {n: np.shape(v) for n, v in feed.items() if tuple(np.shape(v)[:1]) != (steps,)}
            if bad:
                raise ValueError(
                    "per_step_feed=True: every feed needs a leading steps=%d axis; got %s"
                    % (steps, bad))
        feeds = {n: self._coerce_feed(feed[n], plan.feed_dtypes.get(n)) for n in plan.feed_names}

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
                entry = _Entry(lowering.lower_block(
                    program.global_block(), plan.feed_names, plan.fetch_names, plan.state_out,
                    self.device))
                if use_program_cache:
                    self._cache[key] = entry
            stats["dispatch_overhead_s"] += time.perf_counter() - t_run0

        check_nan_inf = flags.get_flags("FLAGS_check_nan_inf")["FLAGS_check_nan_inf"]
        graph_path = (use_program_cache and self.device.type == "cuda" and not plan.random_ops
                      and all(n in scope.vars for n in plan.state_out))
        if graph_path:
            with entry.lock:  # feeds in, replay, fetches out: one thread at a time
                graph = entry.graph_for(scope)
                if graph is None and getattr(entry.warmed, "done", False):
                    graph = self._capture(entry, plan, scope, feeds, per_step_feed)
                if graph is not None:
                    fetches = self._replay(graph, scope, feeds, steps, per_step_feed)
                    if check_nan_inf:
                        _check_nan_inf(list(zip(plan.fetch_names, fetches))
                                       + [(n, graph.bufs[n]) for n in plan.state_out])
                    # the graph's outputs are overwritten by its next replay
                    if return_numpy:
                        return [to_numpy(f) for f in fetches]
                    return [f.clone() for f in fetches]
        feeds = {n: t.to(self.device, non_blocking=True) for n, t in feeds.items()}
        fetches = _eager(entry.fn, state, feeds, scope, steps, per_step_feed)
        entry.warmed.done = True
        if check_nan_inf:
            _check_nan_inf(list(zip(plan.fetch_names, fetches))
                           + [(n, scope.vars[n]) for n in plan.state_out if n in scope.vars])
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        if graph_path:
            # a fetch that is a state tensor becomes a graph buffer at the
            # next run, which replays write into in place
            state_ptrs = {t.untyped_storage().data_ptr() for t in state.values()}
            state_ptrs.update(scope.vars[n].untyped_storage().data_ptr()
                              for n in plan.state_out)
            fetches = [f.clone() if f.untyped_storage().data_ptr() in state_ptrs else f
                       for f in fetches]
        return fetches

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

    def _replay(self, graph: _Graph, scope: Scope, feeds, steps, per_step_feed):
        """Bring a tensor replaced in the graph's scope into its buffer,
        copy the feeds in, and replay the graph ``steps`` times."""
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
        if per_step_feed:
            feeds = {n: t.to(self.device, non_blocking=True) for n, t in feeds.items()}
        for i in range(steps):
            if per_step_feed or i == 0:
                for n, buf in graph.feeds.items():
                    buf.copy_(feeds[n][i] if per_step_feed else feeds[n], non_blocking=True)
            graph.graph.replay()
        kernels.add_launches(graph.launches, steps)
        return graph.fetches

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
        ``graph_pool_bytes`` the device memory their captures reserved.  The parameter-server keys read 0: the
        port has no parameter server yet."""
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
            "ps_pull_overlap_s": 0.0,
            "ps_pull_wait_s": 0.0,
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
