"""Bucketed KV-cache slot pool for continuous-batching decode (the port's
``serving/kv_pool.py``).

A decode step's shapes are set by (slot count, cache length), so the
pool quantizes both onto ladders — ``slot_ladder`` rungs over batch
slots x ``len_ladder`` rungs over sequence length — and prepares the
functions the scheduler dispatches (``decoding.make_slot_decode_fns``:
the multi-step ``chunk`` and the seat-one-request ``admit`` /
``release``, plus ``admit_prefix`` and ``spec_chunk`` when asked) for
every rung pair at :meth:`warmup`.  After warmup, a mixed prompt/decode
storm runs only on prepared entries; :meth:`jit_cache_stats` is the
ground truth the serving layer reports (``misses`` counts entries built
after warmup).

On the card an entry is a CUDA graph.  Each rung pair owns one set of
state buffers (``cache``, ``tokens``, ``pos``, ``prompt_len``,
``total_len``, ``active``, ``finished``, ``n_gen``, and ``spec`` /
``draft_cache`` when speculative), allocated outside any capture; each
graph of that pair reads and writes them in place, where the JAX
package donates the state to its compiled function.  A dispatch copies
its host inputs (the admit mask, the padded prompt, its lengths, and a
prefix's KV leaves) into the graph's static input buffers and replays
the graph; no value is baked into a capture.  :meth:`warmup` captures on
the caller's thread, on a side stream, with ``capture_error_mode=
"thread_local"`` (the scheduler replays on its own thread), every graph
of a pool in one memory pool: the graphs never replay concurrently and
all their results land in the state buffers.  A dispatch that finds no
graph captures one and counts a miss; nothing runs eagerly on the card.
On the CPU an entry is the plain function, with the same accounting.

Layout: one buffer set a rung pair, so the pool's memory is the sum over
its pairs (``state_bytes()``; ``kv_rung_bytes`` stays the JAX package's
accounting of one pair).  Rung transitions (a storm outgrowing its slot
rung, a long prompt outgrowing the length rung) copy device to device
into the target pair's buffers, zero-padded: no capture, no host trip.
"""
from __future__ import annotations

import gc
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_tpu_torch import kernels
from paddle_tpu_torch.decoding import _tree_map, kv_tree_leaves as _leaves
from paddle_tpu_torch.serving.bucketing import BucketPolicy

__all__ = ["KVSlotPool", "default_len_ladder"]


def default_len_ladder(max_seq_len: int, start: int = 8) -> List[int]:
    """Powers of two from ``start`` up to ``max_seq_len`` (appended when
    not itself a power of two) — the length-axis analog of the batch
    bucket ladder."""
    if max_seq_len < 1:
        raise ValueError("max_seq_len must be >= 1, got %r" % max_seq_len)
    ladder = []
    b = min(start, max_seq_len)
    while b < max_seq_len:
        ladder.append(b)
        b *= 2
    ladder.append(max_seq_len)
    return sorted(set(ladder))


class _Graph:
    """One captured entry: the graph, the state buffers it reads and
    writes, its static inputs (``packed`` scalars and prompt, ``kv``
    prefix leaves), the hand-kernel launches one replay makes, and the
    bytes its capture added to the pool's memory pool."""

    __slots__ = ("graph", "state", "packed", "kv", "launches", "pool_bytes")

    def __init__(self, graph, state, packed, kv, launches, pool_bytes):
        self.graph = graph
        self.state = state
        self.packed = packed
        self.kv = kv
        self.launches = launches
        self.pool_bytes = pool_bytes


class KVSlotPool:
    """Prepared entries + state plumbing for one decode endpoint.

    ``step_fn``/``make_cache``: the slot-pooled step builder's outputs
    (``decoding.make_transformer_lm_pooled_step_fn`` — per-row positions,
    cache T axis read from the cache itself, so ONE step fn serves every
    rung pair).  ``steps``: tokens advanced per ``chunk`` dispatch.  The
    state lives on ``step_fn.device``; ``make_cache(n_rows, seq_len,
    device=)`` builds a cache on any device (the pool asks for
    ``device="meta"`` to read shapes and types without allocating).

    ``on_recompile``: called once per entry built AFTER :meth:`warmup` —
    the serving layer counts it as a recompile, the guarantee violation.
    """

    def __init__(self, step_fn: Callable, make_cache: Callable, *,
                 eos_id: int, max_slots: int, max_seq_len: int,
                 slot_ladder: Optional[Sequence[int]] = None,
                 len_ladder: Optional[Sequence[int]] = None,
                 steps: int = 4,
                 on_recompile: Optional[Callable[[], None]] = None,
                 prefix: bool = False,
                 speculative=None,
                 kv_dtype: str = "fp32",
                 len_multiple: int = 1):
        from paddle_tpu_torch.decoding import (make_prefix_admit_fn,
                                               make_slot_decode_fns,
                                               normalize_kv_dtype)

        self._make_cache = make_cache
        self.kv_dtype = normalize_kv_dtype(kv_dtype)
        self.eos_id = int(eos_id)
        self.steps = max(1, int(steps))
        self.slot_policy = BucketPolicy(max_slots, slot_ladder)
        # ``len_multiple``: every length rung — and the cap itself —
        # rounds UP to the next multiple
        self.len_multiple = max(1, int(len_multiple))
        ladder = list(len_ladder or default_len_ladder(max_seq_len))
        if self.len_multiple > 1:
            lm = self.len_multiple
            max_seq_len = -(-int(max_seq_len) // lm) * lm
            ladder = sorted({-(-int(t) // lm) * lm for t in ladder}
                            | {max_seq_len})
        self.len_policy = BucketPolicy(max_seq_len, ladder)
        # ``prefix`` adds the admit_prefix entry (shared-prefix KV
        # installation); ``speculative`` (a SpeculativeConfig) threads
        # the draft cache + spec flag through the state and adds the
        # fused draft+verify spec_chunk entry
        self.prefix = bool(prefix)
        self.speculative = speculative
        chunk, admit, release = make_slot_decode_fns(
            step_fn, self.eos_id, self.steps,
            draft_step_fn=(speculative.draft_step_fn
                           if speculative is not None else None))
        self._plain = {"chunk": chunk, "admit": admit, "release": release}
        if self.prefix:
            self._plain["admit_prefix"] = make_prefix_admit_fn(admit)
        if speculative is not None:
            from paddle_tpu_torch.serving.speculative import make_spec_chunk_fn

            self._plain["spec_chunk"] = make_spec_chunk_fn(
                speculative.verify_fn, speculative.draft_step_fn,
                self.eos_id, speculative.k)
        self.device = torch.device(step_fn.device)
        self._cuda = self.device.type == "cuda"
        self._exe: Dict[Tuple[str, int, int], object] = {}
        self._bufs: Dict[Tuple[int, int], Dict[str, object]] = {}
        self._specs: Dict[Tuple[int, int], Dict[str, object]] = {}
        self._mempool = None
        self._stream = None
        self._thread_warm = threading.local()
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self.warmed = False
        self._on_recompile = on_recompile

    # ------------------------------------------------------------------
    @property
    def max_slots(self) -> int:
        return self.slot_policy.max_batch_size

    @property
    def max_seq_len(self) -> int:
        return self.len_policy.max_batch_size

    def rung_pairs(self) -> List[Tuple[int, int]]:
        return [(s, t) for s in self.slot_policy.ladder
                for t in self.len_policy.ladder]

    def _kinds(self) -> List[str]:
        """Every entry kind this pool prepares per rung pair."""
        kinds = ["chunk", "admit", "release"]
        if self.prefix:
            kinds.append("admit_prefix")
        if self.speculative is not None:
            kinds.append("spec_chunk")
        return kinds

    # ------------------------------------------------------------------
    def _state_spec(self, s: int, t: int):
        """The pool state of rung pair ``(s, t)`` as meta tensors."""
        spec = self._specs.get((s, t))
        if spec is None:
            def meta(shape, dtype):
                return torch.empty(shape, dtype=dtype, device="meta")

            spec = {
                "cache": self._make_cache(s, t, device="meta"),
                "tokens": meta((s, t), torch.int32),
                "pos": meta((s,), torch.int32),
                "prompt_len": meta((s,), torch.int32),
                "total_len": meta((s,), torch.int32),
                "active": meta((s,), torch.bool),
                "finished": meta((s,), torch.bool),
                "n_gen": meta((s,), torch.int32),
            }
            if self.speculative is not None:
                spec["spec"] = meta((s,), torch.bool)
                spec["draft_cache"] = self.speculative.draft_make_cache(s, t, device="meta")
            self._specs[(s, t)] = spec
        return spec

    def _kv_subtree_leaves(self, state_or_spec):
        """Leaves of the state's KV subtrees (``cache`` plus
        ``draft_cache`` when speculative) — the fixed order the prefix
        cache stores and ``admit_prefix`` consumes."""
        sub = {"cache": state_or_spec["cache"]}
        if "draft_cache" in state_or_spec:
            sub["draft_cache"] = state_or_spec["draft_cache"]
        return _leaves(sub)

    def _zeros(self, s: int, t: int):
        return _tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=self.device),
                         self._state_spec(s, t))

    def _buffers(self, s: int, t: int):
        """The card's state buffers of rung pair ``(s, t)`` (made once,
        zeroed, outside any capture)."""
        bufs = self._bufs.get((s, t))
        if bufs is None:
            bufs = self._bufs[(s, t)] = self._zeros(s, t)
        return bufs

    def alloc(self, s: int, t: int) -> Dict[str, object]:
        """A zeroed pool state for rung pair ``(s, t)``: fresh tensors on
        the CPU, the pair's own buffers (zeroed) on the card."""
        if not self._cuda:
            return self._zeros(s, t)
        bufs = self._buffers(s, t)
        for leaf in _leaves(bufs):
            leaf.zero_()
        return bufs

    def resize(self, state, new_s: int, new_t: int) -> Dict[str, object]:
        """Re-shape ``state`` into rung pair ``(new_s, new_t)``: every
        leaf is copied (device to device) into a zero-padded (or sliced)
        state of the target rungs — the pair's buffers on the card.  No
        capture is involved, so the zero-recompile guarantee survives
        rung transitions.  Shrinking assumes the caller vacated the
        dropped tail slots."""
        if self.state_rungs(state) == (new_s, new_t):
            return state
        out = self._buffers(new_s, new_t) if self._cuda else self._zeros(new_s, new_t)
        with torch.no_grad():
            for src, dst in zip(_leaves(state), _leaves(out)):
                if src.shape != dst.shape:
                    dst.zero_()
                sl = tuple(slice(0, min(a, b)) for a, b in zip(src.shape, dst.shape))
                dst[sl].copy_(src[sl])
        return out

    @staticmethod
    def state_rungs(state) -> Tuple[int, int]:
        """The (slot, length) rung pair a state currently occupies."""
        s, t = state["tokens"].shape
        return int(s), int(t)

    def kv_rung_bytes(self, s: int, t: int) -> int:
        """KV bytes one state of rung pair ``(s, t)`` holds (cache +
        sibling scale leaves + draft cache) — computed from the state's
        stored dtypes, no allocation.  This is the pool accounting the
        ``serving_kv_cache_bytes`` gauge and the int8-KV capacity check
        read."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for leaf in self._kv_subtree_leaves(self._state_spec(s, t))))

    def kv_state_bytes(self, state) -> int:
        """:meth:`kv_rung_bytes` for ``state``'s current rung pair."""
        s, t = self.state_rungs(state)
        return self.kv_rung_bytes(s, t)

    def state_bytes(self) -> int:
        """Bytes of the state buffers this pool holds on the card (every
        rung pair's, KV and control leaves alike); 0 on the CPU."""
        return int(sum(leaf.numel() * leaf.element_size()
                       for bufs in self._bufs.values() for leaf in _leaves(bufs)))

    def graph_pool_bytes(self) -> int:
        """Bytes the captures added to the graphs' shared memory pool."""
        with self._lock:
            return int(sum(g.pool_bytes for g in self._exe.values() if isinstance(g, _Graph)))

    # ------------------------------------------------------------------
    def _args(self, kind: str, s: int, t: int, packed, kv):
        """The entry's arguments after the state, built from the packed
        int32 inputs ``[mask (s), prompt (t), prompt_len, total_len,
        prefix_len, spec_flag]`` (views, so a graph reads its static
        buffer) and the prefix KV leaves."""
        if kind in ("chunk", "spec_chunk"):
            return ()
        mask = packed[:s] != 0
        if kind == "release":
            return (mask,)
        args = [mask, packed[s:s + t], packed[s + t], packed[s + t + 1]]
        if kind == "admit_prefix":
            args += [kv, packed[s + t + 2]]
        if self.speculative is not None:
            args.append(packed[s + t + 3] != 0)
        return tuple(args)

    def _kv_shapes(self, s: int, t: int):
        """(shape, dtype) of each prefix KV input of rung pair ``(s, t)``:
        a leaf's per-slot shape, or a (1,) fp32 dummy."""
        from paddle_tpu_torch.decoding import kv_leaf_seq_axis

        out = []
        for leaf in self._kv_subtree_leaves(self._state_spec(s, t)):
            if kv_leaf_seq_axis(tuple(leaf.shape), s, t) is None:
                out.append(((1,), torch.float32))
            else:
                out.append((tuple(leaf.shape[1:]), leaf.dtype))
        return out

    def _warm_thread(self) -> None:
        """Before this thread's first capture, run each kind once eagerly
        on a scratch state of the smallest rung pair, every mask off: the
        kernel libraries load and the thread's cuBLAS handle exists before
        a capture records them."""
        if getattr(self._thread_warm, "done", False):
            return
        s, t = self.rung_pairs()[0]
        state = self._zeros(s, t)
        packed = torch.zeros((s + t + 4,), dtype=torch.int32, device=self.device)
        kv = [torch.zeros(shp, dtype=dt, device=self.device) for shp, dt in self._kv_shapes(s, t)]
        for kind in self._kinds():
            self._plain[kind](state, *self._args(kind, s, t, packed, kv))
        torch.cuda.synchronize(self.device)
        self._thread_warm.done = True

    def _capture(self, kind: str, s: int, t: int) -> _Graph:
        """Capture entry ``kind`` of rung pair ``(s, t)`` as a CUDA graph
        over the pair's buffers.  A failure raises: nothing falls back to
        eager on the card."""
        state = self._buffers(s, t)
        packed = torch.zeros((s + t + 4,), dtype=torch.int32, device=self.device)
        kv = ([torch.zeros(shp, dtype=dt, device=self.device) for shp, dt in self._kv_shapes(s, t)]
              if kind == "admit_prefix" else None)
        self._warm_thread()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        gc_was_enabled = gc.isenabled()
        # no cyclic collection while capturing: one could free a graph
        # held in dead cycles, and destroying a graph invalidates the capture
        gc.disable()
        try:
            reserved = torch.cuda.memory_reserved(self.device)
            with kernels.recording(self._stream.cuda_stream) as tally, \
                    torch.cuda.stream(self._stream), torch.no_grad():
                graph.capture_begin(pool=self._mempool, capture_error_mode="thread_local")
                try:
                    # the inputs' views and casts are recorded too: a
                    # replay reads what the dispatch copied in
                    self._plain[kind](state, *self._args(kind, s, t, packed, kv))
                finally:
                    graph.capture_end()
            pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        finally:
            if gc_was_enabled:
                gc.enable()
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        return _Graph(graph, state, packed, kv, dict(tally), pool_bytes)

    def _build(self, kind: str, s: int, t: int):
        return self._capture(kind, s, t) if self._cuda else self._plain[kind]

    def _get_exe(self, kind: str, s: int, t: int):
        key = (kind, s, t)
        with self._lock:
            exe = self._exe.get(key)
            if exe is not None:
                self._hits += 1
                return exe
        exe = self._build(kind, s, t)
        with self._lock:
            self._exe[key] = exe
            self._misses += 1
            if self.warmed and self._on_recompile is not None:
                self._on_recompile()
        return exe

    # ------------------------------------------------------------------
    def warmup(self) -> int:
        """Prepare chunk + admit + release (and admit_prefix / spec_chunk
        when enabled) for EVERY rung pair — on the card, capture each as
        a CUDA graph; returns the number of entries built (0 on a
        re-warm).  After this, a storm that stays inside the ladders
        never builds an entry again — :meth:`jit_cache_stats` ``misses``
        is the proof the serving layer asserts on."""
        todo = [(kind, s, t) for s, t in self.rung_pairs() for kind in self._kinds()
                if (kind, s, t) not in self._exe]
        for kind, s, t in todo:
            exe = self._build(kind, s, t)
            with self._lock:
                self._exe[(kind, s, t)] = exe
        self.warmed = True
        return len(todo)

    def jit_cache_stats(self) -> Dict[str, int]:
        """The recompile ground truth (same contract as
        ``AnalysisPredictor.jit_cache_stats``): ``misses`` counts entries
        built outside warmup, ``hits`` runs served by an existing one."""
        with self._lock:
            return {"entries": len(self._exe), "hits": self._hits,
                    "misses": self._misses}

    def close(self) -> None:
        """Drop the graphs and the state buffers (the card's memory goes
        back to the caching allocator)."""
        with self._lock:
            self._exe.clear()
            self._bufs.clear()
            self._mempool = None

    # ------------------------------------------------------------------
    # dispatch (the scheduler's hot path: one dict lookup + a replay)
    # ------------------------------------------------------------------
    def _dispatch(self, kind: str, state, packed=None, kv=None):
        """Run entry ``kind`` on ``state`` with the host inputs ``packed``
        (int32 numpy) and ``kv`` (prefix leaves, numpy): on the card, copy
        them (and a state that is not the pair's buffers) into the
        graph's static buffers and replay; on the CPU, call the function."""
        s, t = self.state_rungs(state)
        exe = self._get_exe(kind, s, t)
        if not self._cuda:
            p = None if packed is None else torch.from_numpy(packed)
            k = None if kv is None else [torch.from_numpy(x) for x in kv]
            return exe(state, *self._args(kind, s, t, p, k))
        if state is not exe.state:
            for src, dst in zip(_leaves(state), _leaves(exe.state)):
                if src is not dst:
                    dst.copy_(src)
        if packed is not None:
            exe.packed.copy_(torch.from_numpy(packed), non_blocking=True)
        if kv is not None:
            for buf, x in zip(exe.kv, kv):
                buf.copy_(torch.from_numpy(x), non_blocking=True)
        exe.graph.replay()
        if exe.launches:
            kernels.add_launches(exe.launches)
        return exe.state

    def chunk(self, state) -> Dict[str, object]:
        """Advance every active slot by up to ``steps`` tokens in ONE
        dispatch (prefill and decode interleaved inside)."""
        # hot-path: begin kv_chunk (entry lookup + replay; the scheduler
        # materializes results OUTSIDE this region)
        out = self._dispatch("chunk", state)
        # hot-path: end kv_chunk
        return out

    def _packed(self, s: int, t: int, slots, prompt=None, prompt_len=0, total_len=0,
                prefix_len=0, spec=False) -> np.ndarray:
        buf = np.zeros((s + t + 4,), np.int32)
        for i in slots:
            buf[i] = 1
        if prompt is not None:
            n = min(len(prompt), t)
            buf[s:s + n] = np.asarray(prompt[:n], np.int32)
        buf[s + t:] = (int(prompt_len), int(total_len), int(prefix_len), int(bool(spec)))
        return buf

    def admit(self, state, slot: int, prompt: np.ndarray,
              prompt_len: int, total_len: int,
              spec: bool = False) -> Dict[str, object]:
        """Seat one request into free slot ``slot``: the prompt is
        padded host-side to the state's length rung and the slot's
        flags/cursors reset in ONE dispatch (the cache is left as it is —
        write-before-read makes zeroing a reused slot unnecessary).
        ``spec`` marks the slot for speculative rounds (ignored unless
        the pool was built with a SpeculativeConfig)."""
        s, t = self.state_rungs(state)
        packed = self._packed(s, t, [slot], prompt, prompt_len, total_len, spec=spec)
        # hot-path: begin kv_admit (entry lookup + input copy + replay)
        out = self._dispatch("admit", state, packed)
        # hot-path: end kv_admit
        return out

    def admit_prefix(self, state, slot: int, prompt: np.ndarray,
                     prompt_len: int, total_len: int,
                     kv_leaves, prefix_len: int,
                     spec: bool = False) -> Dict[str, object]:
        """Seat a request whose first ``prefix_len`` positions are
        served from retained KV blocks (``kv_leaves``: the prefix
        cache's stored leaf list, in :meth:`extract_kv` order): the
        leaves are host-padded to the current length rung and installed
        by the warmed ``admit_prefix`` entry, and the slot starts at
        ``pos = prefix_len`` — prefill resumes at the unmatched suffix.
        Requires ``prefix=True`` at construction."""
        from paddle_tpu_torch.decoding import kv_leaf_seq_axis

        if "admit_prefix" not in self._plain:
            raise RuntimeError(
                "pool was built without prefix=True — admit_prefix has "
                "no warmed entry")
        s, t = self.state_rungs(state)
        packed = self._packed(s, t, [slot], prompt, prompt_len, total_len, prefix_len, spec)
        kv = []
        for leaf, ent in zip(self._kv_subtree_leaves(self._state_spec(s, t)), kv_leaves):
            if kv_leaf_seq_axis(tuple(leaf.shape), s, t) is None or ent is None:
                kv.append(np.zeros((1,), np.float32))
                continue
            tgt = np.zeros(tuple(leaf.shape[1:]), str(leaf.dtype).replace("torch.", ""))
            sl = tuple(slice(0, min(a, b)) for a, b in zip(ent.shape, tgt.shape))
            tgt[sl] = ent[sl]
            kv.append(tgt)
        # hot-path: begin kv_admit_prefix (entry lookup + input copies +
        # replay; the leaf re-pad above is host numpy on stored host arrays)
        out = self._dispatch("admit_prefix", state, packed, kv)
        # hot-path: end kv_admit_prefix
        return out

    def extract_kv(self, state, slot: int, m: int):
        """Materialize slot ``slot``'s first ``m`` KV positions as host
        arrays (the prefix cache's retained-entry payload): one list
        entry per KV subtree leaf, ``None`` for leaves carrying no
        per-slot sequence state.  A control-plane d2h — called when a
        slot is FREED, off the tick's dispatch path."""
        from paddle_tpu_torch.decoding import kv_leaf_seq_axis

        s, t = self.state_rungs(state)
        out = []
        for leaf in self._kv_subtree_leaves(state):
            ax = kv_leaf_seq_axis(tuple(leaf.shape), s, t)
            if ax is None:
                out.append(None)
                continue
            sl = [slice(None)] * (leaf.dim() - 1)
            sl[ax - 1] = slice(0, int(m))
            out.append(leaf[slot][tuple(sl)].cpu().numpy())
        return out

    def release(self, state, slots: Sequence[int]) -> Dict[str, object]:
        """Deactivate ``slots`` mid-flight (expired deadline, abort):
        their lanes stop advancing and become seatable again."""
        s, t = self.state_rungs(state)
        return self._dispatch("release", state, self._packed(s, t, slots))
