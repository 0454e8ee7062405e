"""Ring attention: sequence-parallel exact attention over a group of ranks.

The port's counterpart of the JAX package's ``parallel/ring_attention.py``.
The JAX function runs inside ``shard_map``: a ``lax.scan`` over the ring
whose body attends one K/V block with einsums, folds it into a running
(max, denominator, accumulator) and passes K and V on with
``lax.ppermute``.  The port is SPMD across processes, so the ring is a
``torch.distributed`` group:

* rank r of the group holds the queries, keys and values of tokens
  ``[r Tl, (r + 1) Tl)``;
* at hop s it holds the K/V block of rank ``(r - s) mod n``; it posts the
  block's send to rank r + 1 and the next block's receive from rank r - 1
  (``isend`` / ``irecv``) before it attends the block, so the hop overlaps
  the attention; gloo moves host tensors only, so over gloo a CUDA block
  goes through the host, as ``parallel/mesh.py`` ``all_gather_cat`` does;
* each block is attended and merged in one launch,
  ``kernels/ring_attention.py`` ``ring_step``: rank r's own block first,
  with ``causal`` (queries and keys share the window), by kernel B1's
  forward with its row statistics; then the blocks of lower ranks, with
  no mask, by B1's forward with the merge in its epilogue (kernel B2),
  which folds the block into the running output and its statistics in
  place with the JAX function's ``max(l, 1e-20)`` guard; and, when
  ``causal``, the blocks of higher ranks not at all (every key lies after
  every query: the JAX scan adds exactly 0 for them).

So rank r launches B1's forward once and B2 r times under ``causal`` (once
and n - 1 times without), and sends n - 1 blocks of K and V.  After the
last hop the running statistics are the rows' (m, log l) over the whole
sequence.  There is no backward yet: the ``sp`` layout serves (the JAX
package's ``sharding/layouts.py``), and the ring's gradient, which can
rebuild each block's probabilities from those statistics, comes with sp
training.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

__all__ = ["ring_attention", "ring_stats", "reset_ring_stats"]

_STATS: Dict[str, float] = {}


def reset_ring_stats() -> None:
    """Zero this process's ring counters."""
    _STATS.clear()
    _STATS.update(calls=0, hops=0, bytes_sent=0, hop_s=0.0, wait_s=0.0)


reset_ring_stats()


def ring_stats() -> Dict[str, float]:
    """This process's ring counters since the last reset: ``calls``
    (shape-only calls on meta tensors included), ``hops`` (blocks sent),
    ``bytes_sent`` (K and V, the wire's bytes), ``hop_s`` (seconds from a
    hop's posting to its completion, summed) and ``wait_s`` (of those, the
    seconds the rank waited after its block's attention was queued)."""
    return dict(_STATS)


def ring_attention(q, k, v, group=None, causal: bool = True, scale: Optional[float] = None):
    """Exact attention over ring-sharded sequences.

    q/k/v: [B, H, Tl, D], this rank's window of the sequence (rank r of
    ``group`` holds tokens ``[r Tl, (r + 1) Tl)``); ``group`` a
    ``torch.distributed`` process group (None: a world of one rank).
    ``scale=None`` is ``1/sqrt(D)``.  Returns [B, H, Tl, D]: softmax of the
    window's queries against every key (those at or before the query's
    position with ``causal``) times V."""
    import torch.distributed as dist

    from paddle_tpu_torch.kernels import ring_attention as kra

    D = q.shape[-1]
    scale = float(D ** -0.5 if scale is None else scale)
    _STATS["calls"] += 1
    if q.device.type == "meta":
        return torch.empty_like(q)
    n = dist.get_world_size(group) if group is not None else 1
    r = dist.get_rank(group) if group is not None else 0
    kv = torch.stack([k, v])  # one message a hop
    staged = kv.is_cuda and n > 1 and dist.get_backend(group) == "gloo"
    wire = kv.cpu() if staged else kv
    if n > 1:
        nxt = dist.get_global_rank(group, (r + 1) % n)
        prv = dist.get_global_rank(group, (r - 1) % n)
    out = stats = None
    for s in range(n):
        reqs = []
        if s < n - 1:
            t_post = time.perf_counter()
            incoming = torch.empty_like(wire)
            reqs = [dist.isend(wire, nxt, group=group), dist.irecv(incoming, prv, group=group)]
        src = (r - s) % n
        if not (causal and src > r):
            out, stats = kra.ring_step(q, kv[0], kv[1], causal and s == 0, scale, out, stats)
        if reqs:
            t_wait = time.perf_counter()
            for req in reqs:
                req.wait()
            t_done = time.perf_counter()
            _STATS["hops"] += 1
            _STATS["bytes_sent"] += wire.numel() * wire.element_size()
            _STATS["hop_s"] += t_done - t_post
            _STATS["wait_s"] += t_done - t_wait
            wire = incoming
            kv = incoming.to(q.device, non_blocking=True) if staged else incoming
    return out
