"""Arrival-driven bucket-ladder autotuning (own copy of the JAX package's
``serving/autotune.py``; host arithmetic only).

The default serving ladder is the hardcoded 1/2/4/.../max powers of
two — a shape chosen blind, before a single request arrived.  Every
padded batch pays rent for that guess: ``rung - valid`` rows computed
and sliced away.  The arrival-size histogram the metrics layer collects
(``ServingMetrics.observe_arrival``) is exactly
the information needed to do better, and this module turns it into a
ladder:

* :func:`propose_ladder` — exact DP over the observed request sizes:
  choose at most ``max_rungs`` rungs (the top rung is always
  ``max_batch_size`` — ``BucketPolicy``'s contract) minimizing the
  expected padded-row waste ``sum(count[s] * (rung(s) - s))``.  With
  ``n`` distinct sizes the DP is ``O(n^2 * max_rungs)`` — trivial at
  serving batch scales.  Ties prefer FEWER rungs (each rung is one
  warmed shape per replica per precision variant).
* :func:`propose_timeout_ms` — the coalescing window from the queue's
  observed wait EWMA (``AdmissionQueue``): when requests already queue
  for W ms, a window of ~W/4 buys occupancy at marginal latency cost;
  an idle queue shrinks the window toward the floor so light traffic
  isn't taxed.
* :func:`plan` — one proposal document (ladder + timeout + the
  expected waste both ways) consumed by ``InferenceServer.
  replan_ladder`` (online, behind the warmup barrier so a ladder
  change never serves a cold cache) and by ``tools/autotune_ladder.py``
  (offline replay of a recorded histogram).
* :func:`propose_len_ladder` / :func:`plan_kv_ladder` — the SAME DP
  pointed at the decode path's KV length ladder
  (``serving/kv_pool.py``): waste counted in padded cache positions
  from the observed per-request total sequence lengths
  (``DecodeServer.seq_len_histogram``), replacing the hand-picked
  powers-of-two ``default_len_ladder``.  Offline proposal only: a
  ladder change re-warms the pool, a restart-time decision.

Everything here is pure host-side arithmetic on snapshots — it runs on
the autotuner's own thread (or offline), never inside the dispatch hot
path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "expected_waste",
    "propose_ladder",
    "propose_len_ladder",
    "plan_kv_ladder",
    "propose_id_bucket_ladder",
    "plan_id_ladder",
    "propose_timeout_ms",
    "plan",
]


def _normalize_counts(counts, max_batch_size: int) -> Dict[int, int]:
    out: Dict[int, int] = {}
    for k, v in dict(counts or {}).items():
        k, v = int(k), int(v)
        if v > 0 and 0 < k <= int(max_batch_size):
            out[k] = out.get(k, 0) + v
    return out


def expected_waste(counts, ladder: Sequence[int],
                   max_batch_size: Optional[int] = None
                   ) -> Tuple[int, int]:
    """``(waste_rows, padded_rows)`` the ``ladder`` would pay serving
    one request per histogram entry (requests-as-batches: the
    occupancy-neutral comparison both the tests and the offline tool
    use — coalescing shifts both ladders equally).

    Sizes ABOVE the ladder's top rung are excluded from both totals:
    this ladder cannot serve them at all (``BucketPolicy.bucket_for``
    rejects them), so crediting them with a rung would fabricate
    negative waste and poison the comparison a re-plan is judged by."""
    ladder = sorted(int(b) for b in ladder)
    counts = _normalize_counts(
        counts, min(int(max_batch_size), ladder[-1])
        if max_batch_size is not None else ladder[-1])
    waste = padded = 0
    for size, n in counts.items():
        rung = next(r for r in ladder if r >= size)
        waste += (rung - size) * n
        padded += rung * n
    return waste, padded


def propose_ladder(counts, max_batch_size: int,
                   max_rungs: int = 8) -> Optional[List[int]]:
    """The waste-minimal ladder for an observed arrival histogram, or
    None when the histogram is empty (nothing to plan from — keep the
    current ladder)."""
    M = int(max_batch_size)
    if M < 1:
        raise ValueError("max_batch_size must be >= 1, got %r" % M)
    counts = _normalize_counts(counts, M)
    if not counts:
        return None
    cand = sorted(set(counts) | {M})
    ncand = len(cand)
    k_max = max(1, min(int(max_rungs), ncand))
    # hot-path: begin ladder_plan (pure host arithmetic on a histogram
    # snapshot; the server holds its replan lock while this runs, so a
    # device sync or sleep here would stall every concurrent replan)

    def seg_cost(lo: int, hi: int) -> int:
        # waste of serving every size s with lo < s <= hi at rung hi
        return sum((hi - s) * n for s, n in counts.items() if lo < s <= hi)

    INF = float("inf")
    # dp[k][j]: minimal waste covering all sizes <= cand[j] with k
    # rungs, the largest being cand[j]
    dp = [[INF] * ncand for _ in range(k_max + 1)]
    parent: List[List[Optional[int]]] = [
        [None] * ncand for _ in range(k_max + 1)]
    for j in range(ncand):
        dp[1][j] = seg_cost(0, cand[j])
    for k in range(2, k_max + 1):
        for j in range(ncand):
            for i in range(j):
                if dp[k - 1][i] is INF:
                    continue
                c = dp[k - 1][i] + seg_cost(cand[i], cand[j])
                if c < dp[k][j]:
                    dp[k][j] = c
                    parent[k][j] = i
    top = ncand - 1  # the ladder must top out at max_batch_size
    best_k = 1
    for k in range(2, k_max + 1):
        if dp[k][top] < dp[best_k][top]:  # strict: ties keep fewer rungs
            best_k = k
    ladder = []
    k, j = best_k, top
    while j is not None:
        ladder.append(cand[j])
        j = parent[k][j]
        k -= 1
    ladder = sorted(set(ladder))
    # the reconstruction starts at the M candidate, so the ladder tops
    # out at max_batch_size by construction (BucketPolicy's contract)
    assert ladder[-1] == M
    # hot-path: end ladder_plan
    return ladder


def propose_len_ladder(seq_len_counts, max_seq_len: int,
                       max_rungs: int = 6) -> Optional[List[int]]:
    """The waste-minimal KV length-bucket ladder for an observed
    sequence-length histogram (``DecodeServer`` records total sequence
    length — prompt + generation budget — per admitted request as
    ``seq_len_histogram``), or None when the histogram is empty.

    Same exact DP as :func:`propose_ladder`, with waste counted in
    padded CACHE POSITIONS instead of batch rows: a sequence of total
    length ``s`` decoded on length rung ``r`` carries ``r - s`` dead
    cache slots for its whole lifetime, in HBM and in every attention
    step.  The result drops into ``KVSlotPool(len_ladder=...)`` /
    ``DecodeServer(len_ladder=...)``; each rung is one more warmed entry per
    slot rung at warmup, so ties prefer fewer rungs exactly like the
    batch ladder.  Offline proposal only — replacing a live pool's
    ladder means re-warming, which is a restart-time decision."""
    return propose_ladder(seq_len_counts, max_seq_len,
                          max_rungs=max_rungs)


def plan_kv_ladder(seq_len_histogram, max_seq_len: int,
                   current_ladder: Optional[Sequence[int]] = None,
                   max_rungs: int = 6) -> Dict[str, object]:
    """One KV-ladder proposal document: the waste-minimal length ladder
    for the observed sequence lengths vs the current (default:
    ``kv_pool.default_len_ladder`` — the hand-picked powers of two),
    with expected padded-position waste both ways so the improvement is
    a number, not a claim."""
    from paddle_tpu_torch.serving.kv_pool import default_len_ladder

    current = sorted(int(b) for b in (
        current_ladder if current_ladder is not None
        else default_len_ladder(int(max_seq_len))))
    proposed = propose_len_ladder(seq_len_histogram, max_seq_len,
                                  max_rungs=max_rungs)
    if proposed is None:
        proposed = list(current)
    cur_w, cur_p = expected_waste(seq_len_histogram, current, max_seq_len)
    new_w, new_p = expected_waste(seq_len_histogram, proposed, max_seq_len)
    return {
        "len_ladder": proposed,
        "changed": proposed != current,
        "current_waste_ratio": round(cur_w / cur_p, 6) if cur_p else None,
        "proposed_waste_ratio": round(new_w / new_p, 6) if new_p else None,
        "waste_positions_saved": int(cur_w - new_w),
        "n_lengths_observed": len(
            _normalize_counts(seq_len_histogram, max_seq_len)),
    }


def propose_id_bucket_ladder(uniq_id_counts, max_unique: int,
                             max_rungs: int = 8) -> Optional[List[int]]:
    """The waste-minimal UNIQUE-ID bucket ladder for an observed
    per-batch unique-id-count histogram (the executor's sparse
    prefetch records ``len(unique(batch ids))`` per table per batch as
    ``program._uniq_id_hist``), or None when the histogram is empty.

    Same exact DP as :func:`propose_ladder`, with waste counted in
    padded ID SLOTS: a batch with ``n`` unique ids bucketed to rung
    ``r`` pulls (PS path) or gathers + pushes (mesh path) ``r - n``
    padding rows per table per step.  The result replaces the
    hardcoded power-of-two buckets via
    ``bind_distributed_tables(..., id_bucket_ladder=...)`` /
    ``program._sparse_id_ladder``.  Offline proposal only: each rung
    is one compiled lookup/push shape, so changing a live ladder means
    re-warming — a restart-time decision, exactly like the KV length
    ladder."""
    return propose_ladder(uniq_id_counts, max_unique, max_rungs=max_rungs)


def _pow2_id_ladder(max_unique: int) -> List[int]:
    """The executor's default unique-count buckets: 8, 16, ... up to
    the next power of two covering ``max_unique`` (the bucket rounding
    is the executor's own ``pow2_id_bucket`` — one definition, so this
    comparison baseline can never drift from the runtime)."""
    from paddle_tpu_torch.executor import pow2_id_bucket

    ladder, b = [], 8
    top = pow2_id_bucket(int(max_unique))
    while b < top:
        ladder.append(b)
        b *= 2
    ladder.append(top)
    return ladder


def plan_id_ladder(uniq_id_histogram,
                   max_unique: Optional[int] = None,
                   current_ladder: Optional[Sequence[int]] = None,
                   max_rungs: int = 8) -> Dict[str, object]:
    """One id-ladder proposal document: the waste-minimal unique-id
    bucket ladder for the observed histogram vs the current (default:
    the executor's power-of-two buckets), with the expected padded-slot
    waste both ways.  ``max_unique`` defaults to the largest observed
    count (the histogram IS the traffic)."""
    counts = {int(k): int(v) for k, v in dict(uniq_id_histogram or {}).items()
              if int(v) > 0 and int(k) > 0}
    if max_unique is None:
        if not counts:
            raise ValueError(
                "empty unique-id histogram and no max_unique given — "
                "nothing to plan from")
        max_unique = max(counts)
    current = sorted(int(b) for b in (
        current_ladder if current_ladder is not None
        else _pow2_id_ladder(int(max_unique))))
    proposed = propose_id_bucket_ladder(counts, int(max_unique),
                                        max_rungs=max_rungs)
    if proposed is None:
        proposed = list(current)
    # compare over the shared coverage: the pow2 default always tops
    # out at >= max_unique, so both ladders serve every observed size
    cur_w, cur_p = expected_waste(counts, current, current[-1])
    new_w, new_p = expected_waste(counts, proposed, current[-1])
    return {
        "id_ladder": proposed,
        "changed": proposed != current,
        "current_waste_ratio": round(cur_w / cur_p, 6) if cur_p else None,
        "proposed_waste_ratio": round(new_w / new_p, 6) if new_p else None,
        "waste_slots_saved": int(cur_w - new_w),
        "n_counts_observed": len(counts),
    }


def propose_timeout_ms(queue_wait_ewma_ms: Optional[float],
                       current_ms: Optional[float] = None,
                       min_ms: float = 0.5, max_ms: float = 50.0) -> float:
    """Coalescing window from the observed queue wait: ~W/4, clamped.
    With no signal yet, keep the current window (or the floor)."""
    if not queue_wait_ewma_ms or queue_wait_ewma_ms <= 0:
        return float(current_ms) if current_ms else float(min_ms)
    return round(min(float(max_ms),
                     max(float(min_ms), 0.25 * float(queue_wait_ewma_ms))),
                 3)


def plan(arrival_histogram, max_batch_size: int,
         current_ladder: Sequence[int],
         queue_wait_ewma_ms: Optional[float] = None,
         current_timeout_ms: Optional[float] = None,
         max_rungs: int = 8) -> Dict[str, object]:
    """One autotune proposal: the waste-minimal ladder for the observed
    arrivals plus a queue-wait-derived batch window, with the expected
    waste of both ladders so the improvement is a number, not a claim."""
    current_ladder = sorted(int(b) for b in current_ladder)
    proposed = propose_ladder(arrival_histogram, max_batch_size,
                              max_rungs=max_rungs)
    if proposed is None:
        proposed = list(current_ladder)
    cur_w, cur_p = expected_waste(
        arrival_histogram, current_ladder, max_batch_size)
    new_w, new_p = expected_waste(
        arrival_histogram, proposed, max_batch_size)
    return {
        "ladder": proposed,
        "changed": proposed != current_ladder,
        "batch_timeout_ms": propose_timeout_ms(
            queue_wait_ewma_ms, current_timeout_ms),
        "current_waste_ratio": round(cur_w / cur_p, 6) if cur_p else None,
        "proposed_waste_ratio": round(new_w / new_p, 6) if new_p else None,
        "waste_rows_saved": int(cur_w - new_w),
        "n_sizes_observed": len(
            _normalize_counts(arrival_histogram, max_batch_size)),
    }
