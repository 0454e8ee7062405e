#!/usr/bin/env python
"""Offline bucket-ladder replay: recorded arrival histogram → proposal
(the port's copy of the JAX package's ``tools/autotune_ladder.py``).

The offline half of the serving ladder autotuner
(``paddle_tpu_torch.serving.autotune``): feed it a recorded arrival-size
histogram — the ``arrival_histogram`` field of an
``InferenceServer.metrics()`` / ``/statusz`` snapshot, a bench
``--metrics-out`` dump, or a hand-written document — and it prints the
waste-minimal ladder plus the expected padding waste under both the
current and the proposed ladder, so a ladder change can be evaluated
(and reviewed) before any server re-plans online.

Input JSON (either shape):

    {"arrival_histogram": {"3": 120, "5": 60}, "max_batch_size": 16,
     "ladder": [1, 2, 4, 8, 16],          # optional: current ladder
     "queue_wait_ewma_ms": 12.0,          # optional: window proposal
     "batch_timeout_ms": 2.0}             # optional: current window

    {"metrics": {"arrival_histogram": ..., "bucket_ladder": ...}}
      (a /statusz document — the server block is found automatically)

    {"uniq_id_histogram": {"37": 120, "61": 60},   # sparse-prefetch
     "id_ladder": [64, 128],                        # optional current
     "max_unique": 128}                             # optional cap
      (the per-batch unique-id-count histogram the executor's sparse
      prefetch records as ``program._uniq_id_hist`` — proposes the
      unique-id BUCKET ladder instead, replacing the hardcoded
      power-of-two buckets; apply offline via
      ``bind_distributed_tables(..., id_bucket_ladder=...)``)

    {"decode": {"seq_len_histogram": {"24": 120, "40": 7},
                "max_seq_len": 128, "len_ladder": [32, 64, 128]}}
      (a DecodeServer ``metrics()`` / ``/statusz`` snapshot — the
      ``decode`` block is found at the top level or under ``metrics``,
      or pass the block itself — proposes the KV LENGTH ladder via
      ``plan_kv_ladder``.  Applying it re-warms every (slot, length)
      rung pair, so it is a RESTART-TIME decision: pass the proposal
      to ``DecodeServer(len_ladder=...)`` on the next deploy; never
      re-plan a live decode server)

Usage::

    python -m paddle_tpu_torch.tools.autotune_ladder histogram.json [--max-rungs 8]

Prints one JSON line (the ``serving.autotune.plan`` /
``plan_id_ladder`` document).
"""
from __future__ import annotations

import argparse
import json
import sys


def _find_block(doc):
    """The dict holding ``arrival_histogram`` — the document itself, or
    a ``metrics`` sub-block (a /statusz or bench dump)."""
    if "arrival_histogram" in doc:
        return doc
    inner = doc.get("metrics")
    if isinstance(inner, dict) and "arrival_histogram" in inner:
        return inner
    raise SystemExit(
        "no 'arrival_histogram' found in the input document "
        "(top level or under 'metrics')")


def _find_decode_block(doc):
    """The dict holding ``seq_len_histogram`` — the document itself, its
    ``decode`` block, or the ``decode`` block of a ``metrics`` dump."""
    for cand in (doc, doc.get("decode"),
                 (doc.get("metrics") or {}).get("decode")
                 if isinstance(doc.get("metrics"), dict) else None):
        if isinstance(cand, dict) and "seq_len_histogram" in cand:
            return cand
    return None


def propose(doc, max_rungs: int = 8):
    from paddle_tpu_torch.serving.autotune import (
        plan, plan_id_ladder, plan_kv_ladder)

    blk = _find_decode_block(doc)
    if blk is not None:
        # a decode /statusz snapshot: propose the KV length ladder.
        # Restart-time only — a ladder change re-warms every rung pair,
        # so the proposal feeds DecodeServer(len_ladder=...) on the
        # next deploy, never a live re-plan.
        max_seq = blk.get("max_seq_len")
        if max_seq is None:
            hist = blk["seq_len_histogram"]
            max_seq = max(int(k) for k in hist) if hist else 0
        return plan_kv_ladder(
            blk["seq_len_histogram"], int(max_seq),
            current_ladder=blk.get("len_ladder"),
            max_rungs=max_rungs)
    if "uniq_id_histogram" in doc:
        # the sparse-prefetch unique-id-count document: propose the id
        # BUCKET ladder (offline only — a live change re-warms)
        return plan_id_ladder(
            doc["uniq_id_histogram"],
            max_unique=doc.get("max_unique"),
            current_ladder=doc.get("id_ladder"),
            max_rungs=max_rungs)
    block = _find_block(doc)
    hist = block["arrival_histogram"]
    ladder = block.get("bucket_ladder") or block.get("ladder")
    max_batch = block.get("max_batch_size") or (
        max(int(b) for b in ladder) if ladder else None)
    if max_batch is None:
        raise SystemExit(
            "input needs 'max_batch_size' (or a 'ladder'/'bucket_ladder' "
            "whose top rung defines it)")
    if not ladder:
        # default current: the hardcoded 1/2/4/.../max (PR-1 shape)
        ladder, b = [], 1
        while b < int(max_batch):
            ladder.append(b)
            b *= 2
        ladder.append(int(max_batch))
    return plan(
        hist, int(max_batch), ladder,
        queue_wait_ewma_ms=block.get("queue_wait_ewma_ms"),
        current_timeout_ms=block.get("batch_timeout_ms"),
        max_rungs=max_rungs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="propose a serving bucket ladder from a recorded "
                    "arrival-size histogram")
    parser.add_argument("histogram", help="JSON file (see module doc)")
    parser.add_argument("--max-rungs", type=int, default=8)
    args = parser.parse_args(argv)
    with open(args.histogram) as f:
        doc = json.load(f)
    print(json.dumps(propose(doc, max_rungs=args.max_rungs),
                     sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
