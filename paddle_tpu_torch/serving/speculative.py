"""Speculative decoding: draft-then-verify rounds in the slot pool (the
port's ``serving/speculative.py``).

One token per target step is the autoregressive tax.  Speculative
decoding (Leviathan et al., ICML 2023) pays it with a SMALL draft
model: per round the draft proposes ``k - 1`` tokens one at a time,
then the target verifies all ``k`` consumed positions in ONE K-wide
forward (``decoding.make_transformer_lm_pooled_verify_fn``), so the
whole round is one warmed ``spec_chunk`` entry per (slot, length) rung
pair: on the card, one captured CUDA graph of the K draft steps, the
verify and the acceptance chain, all unrolled.

Acceptance is **greedy-exact**: a drafted token is accepted iff it
equals the target's own greedy argmax at that position, so the emitted
sequence is the non-speculative greedy decode's no matter how bad the
draft is (a weak draft only costs speed).  On the CPU it is bit for bit;
on the card the K-wide verify's products round unlike K single steps'
by an ulp, so a token can differ only where the top two logits are
within that of each other.
The round's algebra, per slot (``pos`` = tokens consumed so far):

* consumption ``j`` eats position ``q_j = pos + j``: the stored prompt
  token while ``q_j < prompt_len`` (teacher forcing — prefill runs
  K-wide through the same call), else the draft's proposal;
* the chain stays alive through ``j`` iff every consumed draft token so
  far matched the target's prediction for its position; the target's
  ``argmax(logits[:, j])`` is the (verified) token for ``q_j + 1`` and
  is emitted while the chain is alive and past the prompt;
* ``pos`` advances by the accepted length (1..k): rejected positions'
  cache rows are simply re-written next round — the pool's
  write-before-read invariant makes rollback free, for the target AND
  the draft cache (both are state leaves the round writes in place).

Non-speculative slots sharing the pool degrade to one exact token per
round (their chain dies at ``j = 1`` by construction); the scheduler
only dispatches ``spec_chunk`` on ticks where some active slot opted
in, so a pool with speculation enabled but unused runs plain chunks.

Telemetry: ``serving_spec_tokens_{proposed,accepted}_total`` counters
(labeled like the decode series) and the per-server accepted-length
histogram in ``DecodeServer.metrics()``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from paddle_tpu_torch import monitor

__all__ = ["SpeculativeConfig", "make_lm_speculative",
           "make_spec_chunk_fn", "dispatch_spec_chunk",
           "SPEC_PROPOSED", "SPEC_ACCEPTED"]

_LABELS = ("server", "instance")
SPEC_PROPOSED = monitor.counter(
    "serving_spec_tokens_proposed_total",
    "draft tokens proposed per speculative decode round (k - 1 per "
    "round per opted-in slot in its decode phase)", _LABELS)
SPEC_ACCEPTED = monitor.counter(
    "serving_spec_tokens_accepted_total",
    "draft tokens accepted by greedy-exact verification (acceptance "
    "rate = accepted / proposed; the speculative speedup lever)",
    _LABELS)


class SpeculativeConfig:
    """Everything a slot pool needs to run draft-then-verify rounds.

    ``verify_fn(cache, tokens [S, K], ts [S]) -> (logits [S, K, V],
    cache)``: the target's K-wide teacher-forced forward, exact-parity
    with its sequential step.  ``draft_step_fn``/``draft_make_cache``:
    the draft model in the same slot-pooled step contract — its cache
    rides the pool state as ``draft_cache`` so both models stay
    position-synced.  ``k``: consumed positions per round (>= 2; the
    draft proposes ``k - 1``).  ``draft_meta``: manifest fields for
    ``save_decode_endpoint`` (the per-endpoint ``draft`` block).
    """

    def __init__(self, verify_fn: Callable, draft_step_fn: Callable,
                 draft_make_cache: Callable, k: int = 4,
                 draft_meta: Optional[Dict[str, object]] = None):
        if int(k) < 2:
            raise ValueError(
                "speculative k must be >= 2 (k=1 is plain decode), "
                "got %r" % k)
        self.verify_fn = verify_fn
        self.draft_step_fn = draft_step_fn
        self.draft_make_cache = draft_make_cache
        self.k = int(k)
        self.draft_meta = dict(draft_meta or {})


def make_lm_speculative(target_state, *, vocab_size: int, d_model: int,
                        n_layer: int, n_head: int, d_inner: int,
                        draft_state, draft_d_model: int,
                        draft_n_layer: int, draft_n_head: int,
                        draft_d_inner: int, k: int = 4,
                        name: str = "lm",
                        draft_name: str = "draft",
                        kv_dtype: str = "fp32",
                        place=None) -> SpeculativeConfig:
    """A :class:`SpeculativeConfig` for a transformer-LM target + a
    (smaller) transformer-LM draft sharing the vocabulary — the pair
    ``save/load_decode_endpoint`` persists.

    ``kv_dtype``: the TARGET's KV-cache storage dtype — must match the
    step fn the pool runs, so the verify call reads/writes the same
    int8-coded cache leaves.  The draft always keeps fp32 KV (it is
    small by construction; quantizing it buys nothing).  ``place``:
    where both run (``cuda:0`` by default, raising without a card)."""
    from paddle_tpu_torch.decoding import (
        make_transformer_lm_pooled_step_fn,
        make_transformer_lm_pooled_verify_fn,
    )

    verify_fn = make_transformer_lm_pooled_verify_fn(
        target_state, vocab_size, d_model, n_layer, n_head, d_inner,
        name=name, kv_dtype=kv_dtype, place=place)
    draft_step_fn, draft_make_cache = make_transformer_lm_pooled_step_fn(
        draft_state, vocab_size, draft_d_model, draft_n_layer,
        draft_n_head, draft_d_inner, name=draft_name, place=place)
    return SpeculativeConfig(
        verify_fn, draft_step_fn, draft_make_cache, k=k,
        draft_meta={
            "d_model": int(draft_d_model), "n_layer": int(draft_n_layer),
            "n_head": int(draft_n_head), "d_inner": int(draft_d_inner),
            "name": draft_name, "k": int(k),
        })


def make_spec_chunk_fn(verify_fn, draft_step_fn, eos_id: int, k: int):
    """The per-round function the pool runs as ``spec_chunk`` for each
    rung pair: draft ``k - 1`` proposals, verify all ``k`` consumptions
    in one target call, commit the accepted run — writing the state's
    tensors in place and returning it.  See the module docstring for the
    algebra; the draft steps and the acceptance chain are unrolled over
    ``j`` (k is fixed per pool)."""
    from paddle_tpu_torch.decoding import assign_tree

    K = int(k)

    def spec_chunk(state):
        with torch.no_grad():
            tokens = state["tokens"]
            pos = state["pos"]
            active = state["active"]
            spec = state["spec"]
            prompt_len = state["prompt_len"]
            total_len = state["total_len"]
            S, T = tokens.shape
            rows = torch.arange(S, device=tokens.device)
            # --- draft phase: K sequential small steps.  Consumption c_0
            # is always the stored buffer token at pos (prompt token, or
            # the previously verified emission); later consumptions
            # teacher-force the prompt while q_j < prompt_len, else take
            # the draft's proposal.  The draft consumes ALL K tokens so
            # its cache rows cover a fully accepted round.
            dcache = state["draft_cache"]
            tok = tokens[rows, torch.clamp_max(pos.long(), T - 1)]
            consumed = []
            for j in range(K):
                qj = pos + j
                consumed.append(tok)
                dlogits, dnew = draft_step_fn(dcache, tok, torch.clamp_max(qj, T - 1))
                assign_tree(dcache, dnew)
                if j < K - 1:
                    prop = torch.argmax(dlogits, dim=-1).to(torch.int32)
                    nxt_q = qj + 1
                    tok = torch.where(
                        nxt_q < prompt_len,
                        tokens[rows, torch.clamp_max(nxt_q.long(), T - 1)], prop)
            ctoks = torch.stack(consumed, dim=1)  # [S, K]
            # --- verify: ONE K-wide target forward; g[:, j] is the
            # target's verified token for position q_j + 1
            logits, cache = verify_fn(state["cache"], ctoks, pos)
            assign_tree(state["cache"], cache)
            g = torch.argmax(logits, dim=-1).to(torch.int32)  # [S, K]
            # --- greedy-exact acceptance chain + commit
            alive = active.clone()
            newly_fin = torch.zeros_like(active)
            n_emit = torch.zeros_like(pos)
            adv = torch.zeros_like(pos)
            for j in range(K):
                qj = pos + j
                if j > 0:
                    # a stored prompt token is correct by construction; a
                    # drafted one must equal the target's own prediction
                    # for its position (and only spec slots draft at all)
                    corr = (qj < prompt_len) | (spec & (ctoks[:, j] == g[:, j - 1]))
                    alive = alive & corr
                adv = adv + alive.to(torch.int32)
                wr = qj + 1
                emit = alive & (wr >= prompt_len) & (wr < total_len)
                wclamp = torch.clamp_max(wr.long(), T - 1)
                tokens[rows, wclamp] = torch.where(emit, g[:, j], tokens[rows, wclamp])
                n_emit = n_emit + emit.to(torch.int32)
                fin = emit & ((g[:, j] == eos_id) | ((qj + 2) >= total_len))
                newly_fin = newly_fin | fin
                alive = alive & ~fin
            pos.add_(adv)
            active.logical_and_(~newly_fin)
            state["finished"].logical_or_(newly_fin)
            state["n_gen"].add_(n_emit)
        return state

    return spec_chunk


def dispatch_spec_chunk(pool, state):
    """Run one speculative round on ``state`` through the pool's warmed
    ``spec_chunk`` entry for its current rung pair (the scheduler's
    tick-path call — mirror of ``KVSlotPool.chunk``)."""
    # hot-path: begin spec_verify (entry lookup + the round's replay; the
    # scheduler materializes results OUTSIDE this region)
    out = pool._dispatch("spec_chunk", state)
    # hot-path: end spec_verify
    return out
