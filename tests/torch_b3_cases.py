"""Kernel B3's (int8-KV decode attention) test cases, shared by the CPU
tests (``test_torch_decode_attention_split.py``) and the card tests
(``test_torch_cuda.py``).  Imports neither jax nor paddle_tpu.

The kernel splits the positions 0..T-1 of a (slot, head) into the chunks
of ``split_plan(T)``; the positions worth testing are where a query's
last position ``min(ts + j, T - 1)`` meets a chunk's edge.
"""
import numpy as np
import torch

from paddle_tpu_torch import quant
from paddle_tpu_torch.kernels import decode_attention as kda


def boundary_positions(T, K):
    """``ts`` values for a K-wide query at cache length T: 0, each chunk
    start of ``split_plan(T)`` and one either side of it, the ``ts`` whose
    last query (ts + K - 1) lands on each of those three, T - K and T - 1."""
    C, chunk = kda.split_plan(T)
    ts = {0, T - K, T - 1}
    for r in range(1, C):
        for c in (r * chunk - 1, r * chunk, r * chunk + 1):
            ts.update((c, c - K + 1))
    return sorted(t for t in ts if 0 <= t <= T - 1)


def b3_inputs(rng, T, K, Dh, H=3, q_scale=1.0):
    """One slot a ``boundary_positions(T, K)`` value: q fp32 [S, K, H, Dh]
    times ``q_scale``; codes and scales from ``quant.quantize_rows`` of
    random keys (row norms spread over 0.1 to 4) and values; ts int32 [S].
    numpy arrays, made from ``rng``."""
    ts = np.asarray(boundary_positions(T, K), np.int32)
    S = len(ts)
    q = (rng.randn(S, K, H, Dh) * q_scale).astype(np.float32)
    k = (rng.randn(S, H, T, Dh) * rng.uniform(0.1, 4.0, (S, H, T, 1))).astype(np.float32)
    v = rng.randn(S, H, T, Dh).astype(np.float32)
    kc, ks = quant.quantize_rows(torch.from_numpy(k))
    vc, vs = quant.quantize_rows(torch.from_numpy(v))
    return q, kc.numpy(), ks.numpy(), vc.numpy(), vs.numpy(), ts
