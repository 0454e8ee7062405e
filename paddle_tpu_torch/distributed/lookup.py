"""Distributed lookup-table binding (reference:
transpiler/distribute_lookup_table.py + operators/distributed/
parameter_prefetch.cc).

``layers.embedding(is_distributed=True)`` records table metadata on the
program; this module connects those tables to parameter servers and the
executor does pull-before/push-after around each step
(executor.py _prefetch_distributed_tables).  The port's own copy of the
JAX package's ``distributed/lookup.py``.  The server applies the
optimizer on push (listen_and_serv optimize sub-blocks analog), so pass
the lr that matches the trainer-side optimizer for the dense params.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

from paddle_tpu_torch.distributed.ps import PSClient

__all__ = ["bind_distributed_tables"]


def bind_distributed_tables(
    program,
    endpoints_or_client: Union[Sequence[str], PSClient],
    optimizer: str = "sgd",
    lr: float = 0.1,
    initializer: str = "uniform",
    seed: int = 0,
    async_mode: bool = False,
    id_bucket_ladder: Optional[Sequence[int]] = None,
):
    """Create each of ``program``'s distributed tables on the servers and
    attach the client so the executor can prefetch/push.  Returns the
    client.

    ``async_mode``: grad pushes drain through a background Communicator
    (reference: communicator.h async PS) — next step's pull may miss the
    newest grads (bounded staleness); call
    ``program._ps_communicator.flush()`` before eval/save.  Async mode
    also arms the OVERLAPPED sparse prefetch in ``train_from_dataset``
    (batch N+1's pulls run behind batch N's device compute).

    ``id_bucket_ladder``: an explicit unique-id-count bucket ladder for
    the prefetch, as a list (the JAX package's offline autotuner that
    proposes one, ``autotune.propose_id_bucket_ladder``, is ROADMAP A8);
    without it unique counts pad to power-of-two buckets.  Unique counts
    above the ladder's top rung fall back to power-of-two (a new entry:
    an eager run, then a capture, so size the ladder from a
    representative histogram, ``program._uniq_id_hist``)."""
    tables = getattr(program, "_distributed_tables", None)
    if not tables:
        raise ValueError("program has no distributed lookup tables")
    client = (
        endpoints_or_client
        if isinstance(endpoints_or_client, PSClient)
        else PSClient(list(endpoints_or_client))
    )
    seen = set()
    for meta in tables.values():
        name = meta["table"]
        if name in seen:  # tied embeddings share one server table
            continue
        seen.add(name)
        client.create_table(
            name, meta["dim"], initializer=initializer, seed=seed,
            optimizer=optimizer, lr=lr,
        )
    program._ps_client = client
    if id_bucket_ladder is not None:
        program._sparse_id_ladder = sorted(
            int(b) for b in id_bucket_ladder)
    if async_mode:
        from paddle_tpu_torch.distributed.communicator import Communicator

        # own connections: the send thread must not interleave frames on
        # the executor's pull sockets
        program._ps_communicator = Communicator(PSClient(client.endpoints)).start()
    return client
