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
from paddle_tpu_torch.scope import Scope, global_scope, host_copy, to_numpy

__all__ = ["Executor", "pow2_id_bucket"]

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
    "_dense_ps_ctx": "the dense parameter server (DistributeTranspiler; ROADMAP A6b)",
    "_pserver_ctx": "the dense parameter server (DistributeTranspiler; ROADMAP A6b)",
    "_mesh_tables": "mesh-resident tables (bind_mesh_tables; ROADMAP A10)",
    "_embedding_cache": "the embedding cache (ROADMAP A8)",
    "_pipeline_plan": "the pipelined program (PipelineOptimizer cut_list; ROADMAP A10)",
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
    that keep the plan on the interpreter (``eager_ops``: random ops, and
    ops that read a value on the host, a loop or branch predicate; at any
    depth of the control-flow bodies), and ``n_push``: how many fetches
    at the end of ``fetch_names`` are prefetched rows' gradients that the
    run pushes and hides from the caller."""

    __slots__ = ("feed_names", "fetch_names", "state_in", "state_out", "feed_dtypes",
                 "eager_ops", "n_push")

    def __init__(self, feed_names, fetch_names, state_in, state_out, feed_dtypes, eager_ops,
                 n_push=0):
        self.feed_names = feed_names
        self.fetch_names = fetch_names  # the caller's, then the pushed rows' gradients
        self.state_in = state_in
        self.state_out = state_out
        self.feed_dtypes = feed_dtypes
        self.eager_ops = eager_ops
        self.n_push = n_push


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
            "ps_pull_overlap_s": 0.0, "ps_pull_wait_s": 0.0,
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

    def _analyze(self, program, feed_names, fetch_names, n_push=0) -> _RunPlan:
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
        eager_ops = tuple(sorted({t for t in lowering.op_types(block.ops) if registry.has_op(t)
                                  and (registry.get_op(t).random or registry.get_op(t).host_read)}))
        return _RunPlan(
            feed_names, fetch_names,
            tuple(sorted((read & persistable) - set(feed_names))),
            tuple(sorted(written & persistable)),
            feed_dtypes, eager_ops, n_push)

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
        for attr, what in _UNPORTED_PROGRAM_STATE.items():
            if getattr(program, attr, None):
                raise NotImplementedError("%s is not ported to paddle_tpu_torch yet" % what)
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
        )
        ps_push = self._prefetch_distributed_tables(program, feed) if dist_tables else []
        with self._lock:
            plan = self._plans.get(plan_key) if use_program_cache else None
            if plan is not None:
                stats["plan_hits"] += 1
            else:
                stats["plan_misses"] += 1
                plan = self._analyze(program, tuple(sorted(feed)),
                                     user_fetch + tuple(g for _, _, g in ps_push), len(ps_push))
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
        n_user = len(plan.fetch_names) - plan.n_push
        graph_path = (use_program_cache and self.device.type == "cuda" and not plan.eager_ops
                      and all(scope.vars.get(n) is not None for n in plan.state_out))
        if graph_path:
            with entry.lock:  # feeds in, replay, fetches out: one thread at a time
                graph = entry.graph_for(scope)
                if graph is None and getattr(entry.warmed, "done", False):
                    graph = self._capture(entry, plan, scope, feeds, per_step_feed)
                replayed = graph is not None
                if replayed:
                    fetches = self._replay(graph, scope, feeds, steps, per_step_feed)
                    if check_nan_inf:
                        _check_nan_inf(list(zip(plan.fetch_names, fetches))
                                       + [(n, graph.bufs[n]) for n in plan.state_out])
                    # the graph's outputs are overwritten by its next
                    # replay: the caller's fetches and the pushed
                    # gradients leave as copies, under the lock
                    grads = [host_copy(g) for g in fetches[n_user:]]
                    if return_numpy:
                        out = [to_numpy(f) for f in fetches[:n_user]]
                    else:
                        out = [f.clone() for f in fetches[:n_user]]
            if replayed:
                self._push_sparse(program, ps_push, grads)
                return out
        feeds = {n: t.to(self.device, non_blocking=True) for n, t in feeds.items()}
        fetches = _eager(entry.fn, state, feeds, scope, steps, per_step_feed)
        entry.warmed.done = True
        if check_nan_inf:
            _check_nan_inf(list(zip(plan.fetch_names, fetches))
                           + [(n, scope.vars[n]) for n in plan.state_out if n in scope.vars])
        self._push_sparse(program, ps_push, [host_copy(g) for g in fetches[n_user:]])
        fetches = fetches[:n_user]
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
    def _pull_one_table(client, meta, uniq_p):
        return np.asarray(client.pull_sparse(meta["table"], uniq_p), np.float32)

    def _fanout_table_pulls(self, jobs, clients):
        """Job 0 on the calling thread with ``clients[0]``, the others on
        worker threads, each with a client of its own.  Returns
        ``(rows by rows name, [(error, client)])``."""
        results: Dict[str, np.ndarray] = {}
        errors = []

        def work(job, cl):
            meta, uniq_p = job[0], job[1]
            try:
                results[meta["rows_name"]] = self._pull_one_table(cl, meta, uniq_p)
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

    def _pull_tables_concurrent(self, program, client, jobs):
        """Every job's ``pull_sparse`` at once (job 0 on this thread with
        the bound client, the rest on pool clients).  The first error
        propagates after all joins, with its pool client closed and
        dropped (the next pull redials)."""
        pool = self._sparse_client_pool(program, len(jobs) - 1) if len(jobs) > 1 else []
        if pool is None:
            return {job[0]["rows_name"]: self._pull_one_table(client, job[0], job[1])
                    for job in jobs}
        results, errors = self._fanout_table_pulls(jobs, [client] + pool)
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
            rows = self._pull_tables_concurrent(program, client, pulls)
            for job in pulls:
                feed[job[0]["rows_name"]] = rows[job[0]["rows_name"]]
        return ps_push

    @staticmethod
    def _push_sparse(program, ps_push, grads) -> None:
        """Push each prefetched table's row gradients (host arrays): onto
        the Communicator's queue in async mode, else blocking."""
        if not ps_push:
            return
        comm = getattr(program, "_ps_communicator", None)
        client = getattr(program, "_ps_client", None)
        for (table, uniq, _), grad in zip(ps_push, grads):
            if comm is not None:
                comm.push(table, uniq, grad)
            else:
                client.push_sparse(table, uniq, grad)

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
                        vals, errs = self._fanout_table_pulls(jobs, clients)
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
        unique ids are taken.  With
        distributed tables in async mode (a Communicator bound), batch
        N+1's pulls overlap batch N's step.

        Not ported yet, and raising by name: checkpoints and resume
        (``checkpoint_dir``, ``resume_from``), the training control tower
        (``phase_ledger``, ``watchdog``, ``train_log``) and the trace
        spans (``trace_id``), ROADMAP A9; a compiled program, A10."""
        unported = {"checkpoint_dir": checkpoint_dir, "resume_from": resume_from,
                    "phase_ledger": phase_ledger, "watchdog": watchdog, "train_log": train_log,
                    "trace_id": trace_id}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(
                "train_from_dataset(%s): checkpoints, the training control tower and the "
                "trace spans (faults/checkpoint.py, monitor/train.py, monitor/spans.py) are "
                "ROADMAP A9, not ported to paddle_tpu_torch yet" % ", ".join(asked))
        if program is not None and getattr(program, "_is_compiled_program", False):
            raise NotImplementedError(
                "train_from_dataset over a compiled (multi-device) program is ROADMAP A10, "
                "not ported to paddle_tpu_torch yet")
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
        batches = iter(dataset)
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
        results = []
        try:
            for step, feed in enumerate(batches):
                out = self.run(program, feed=feed, fetch_list=fetch_list, scope=scope)
                if fetch_list:
                    results.append(out)
                    if debug and step % print_period == 0:
                        names = fetch_info or [_as_fetch_name(f) for f in fetch_list]
                        print("batch %d:" % step, dict(zip(names, out)))
        finally:
            closer = getattr(batches, "close", None)
            if closer is not None:
                closer()  # stop the prefetch producer and the overlap thread
        return results

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
        pulls that hid behind a step, ``ps_pull_wait_s`` the seconds the
        loop waited for them."""
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
