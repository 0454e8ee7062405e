"""Shared helpers for op kernels."""
from __future__ import annotations

import torch


def one(inputs, slot, default=None):
    vals = inputs.get(slot)
    if not vals:
        return default
    return vals[0]


def maybe(inputs, slot):
    vals = inputs.get(slot)
    return vals[0] if vals else None


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from an op's ``seed`` attr,
    12345 where that is 0 (as the JAX package's ``ops/common.py`` ``prng``).
    jax.random draws other bits for the same seed."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) if seed else 12345)
    return g


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest values along the last dim and their indices, in
    ``jax.lax.top_k``'s order: descending, the lower index first among
    equal values (``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
