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
sequence.

The ring is differentiable when a gradient is asked for (grad mode on and
Q, K or V requiring grad): one ``torch.autograd.Function`` around all the
hops, since ``ring_step`` writes the running output in place.  Its forward
is the ring above and keeps Q, this rank's K and V, the output and the
final statistics.  Its backward takes Di = rowsum(O * dO) once, in fp32,
and sends K and V around the ring again in the forward's order, each block
with a dK/dV accumulator (fp32 for fp32 and bf16 inputs alike): at hop s
rank r attends block ``(r - s) mod n`` with the forward's masking
(``causal`` on its own block, none on lower ones, higher ones skipped
under ``causal`` but passed on), by ``kernels/ring_attention.py``
``ring_block_bwd`` (B1's dK/dV and dQ kernels with the final statistics),
adds the block's dK and dV to its accumulator and dQ to its own, and
passes block and accumulator on; after the last hop each accumulator goes
to the rank that owns its block.  So rank r launches the dK/dV and dQ
kernels r + 1 times under ``causal`` (n without) and sends n - 1 blocks of
K and V and n accumulators.  Every rank sends and receives at every hop,
whatever it attends, so the ranks' graphs stay the same.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import torch

__all__ = ["ring_attention", "ring_stats", "reset_ring_stats"]

_HOP_KEYS = ("calls", "hops", "bytes_sent", "hop_s", "wait_s")

_STATS: Dict[str, float] = {}


def reset_ring_stats() -> None:
    """Zero this process's ring counters."""
    _STATS.clear()
    for prefix in ("", "bwd_"):
        _STATS.update({prefix + k: 0.0 if k.endswith("_s") else 0 for k in _HOP_KEYS})


reset_ring_stats()


def ring_stats() -> Dict[str, float]:
    """This process's ring counters since the last reset: ``calls``
    (shape-only calls on meta tensors included), ``hops`` (blocks sent),
    ``bytes_sent`` (K and V, the wire's bytes), ``hop_s`` (seconds from a
    hop's posting to its completion, summed) and ``wait_s`` (of those, the
    seconds the rank waited after its block's attention was queued); the
    backward's under the same names with ``bwd_`` before them, its hops
    the rounds of sends (n - 1 with K, V and an accumulator, one with an
    accumulator alone)."""
    return dict(_STATS)


def _ring(group):
    """(rank count, rank, next rank's and previous rank's global ranks)."""
    import torch.distributed as dist

    if group is None or dist.get_world_size(group) == 1:
        return 1, 0, None, None
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return n, r, dist.get_global_rank(group, (r + 1) % n), dist.get_global_rank(group, (r - 1) % n)


def _staged(t, group, n):
    """gloo moves host tensors only: over gloo a CUDA tensor goes through the host."""
    import torch.distributed as dist

    return t.is_cuda and n > 1 and dist.get_backend(group) == "gloo"


def _count(prefix, t_post, t_wait, nbytes):
    t_done = time.perf_counter()
    _STATS[prefix + "hops"] += 1
    _STATS[prefix + "bytes_sent"] += nbytes
    _STATS[prefix + "hop_s"] += t_done - t_post
    _STATS[prefix + "wait_s"] += t_done - t_wait


def _forward(q, k, v, group, causal, scale):
    """(out, the final row statistics) of the ring on this rank."""
    import torch.distributed as dist

    from paddle_tpu_torch.kernels import ring_attention as kra

    n, r, nxt, prv = _ring(group)
    kv = torch.stack([k, v])  # one message a hop
    staged = _staged(kv, group, n)
    wire = kv.cpu() if staged else kv
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
            _count("", t_post, t_wait, wire.numel() * wire.element_size())
            wire = incoming
            kv = incoming.to(q.device, non_blocking=True) if staged else incoming
    return out, stats


def _backward(q, k, v, out, stats, d_out, group, causal, scale):
    """dQ, dK, dV of the ring on this rank (see the module's docstring)."""
    import torch.distributed as dist

    from paddle_tpu_torch.kernels import ring_attention as kra

    n, r, nxt, prv = _ring(group)
    _STATS["bwd_calls"] += 1
    di = (out.float() * d_out.float()).sum(-1)
    if d_out.stride(-1) != 1:
        d_out = d_out.contiguous()
    kv = torch.stack([k, v])
    dkv = torch.zeros(kv.shape, dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    staged = _staged(kv, group, n)
    wire = kv.cpu() if staged else kv
    for s in range(n):
        reqs, nbytes = [], 0
        t_post = time.perf_counter()
        if s < n - 1:  # K and V leave first, as in the forward
            incoming = torch.empty_like(wire)
            reqs = [dist.isend(wire, nxt, group=group, tag=0),
                    dist.irecv(incoming, prv, group=group, tag=0)]
            nbytes += wire.numel() * wire.element_size()
        src = (r - s) % n
        if not (causal and src > r):
            g = kra.ring_block_bwd(q, kv[0], kv[1], causal and s == 0, scale, d_out, stats, di)
            dq += g[0]
            dkv[0] += g[1]
            dkv[1] += g[2]
        if n > 1:  # the accumulator follows its block; after the last hop, to its owner
            acc_wire = dkv.cpu() if staged else dkv
            acc_in = torch.empty_like(acc_wire)
            reqs += [dist.isend(acc_wire, nxt, group=group, tag=1),
                     dist.irecv(acc_in, prv, group=group, tag=1)]
            nbytes += acc_wire.numel() * acc_wire.element_size()
            t_wait = time.perf_counter()
            for req in reqs:
                req.wait()
            _count("bwd_", t_post, t_wait, nbytes)
            dkv = acc_in.to(q.device) if staged else acc_in
            if s < n - 1:
                wire = incoming
                kv = incoming.to(q.device, non_blocking=True) if staged else incoming
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The ring with its gradient; none reaches the group, causal or scale."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, stats = _forward(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, stats, d_out, ctx.group, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def ring_attention(q, k, v, group=None, causal: bool = True, scale: Optional[float] = None):
    """Exact attention over ring-sharded sequences.

    q/k/v: [B, H, Tl, D], this rank's window of the sequence (rank r of
    ``group`` holds tokens ``[r Tl, (r + 1) Tl)``); ``group`` a
    ``torch.distributed`` process group (None: a world of one rank).
    ``scale=None`` is ``1/sqrt(D)``.  Returns [B, H, Tl, D]: softmax of the
    window's queries against every key (those at or before the query's
    position with ``causal``) times V; differentiable in Q, K and V."""
    D = q.shape[-1]
    scale = float(D ** -0.5 if scale is None else scale)
    _STATS["calls"] += 1
    if q.device.type == "meta":
        return torch.empty_like(q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _RingAttention.apply(q, k, v, group, bool(causal), scale)
    return _forward(q, k, v, group, causal, scale)[0]
