"""Shared int8 row quantization helpers (the port's ``quant.py``).

One quantization scheme serves the int8 KV cache
(``decoding.make_transformer_lm_pooled_step_fn(kv_dtype="int8")``):
**symmetric per-row absmax** in the LLM.int8() lineage.  A "row" is the
last axis of the tensor; each row gets one fp32 scale ``max|row| / 127``
and the row is stored as ``round(row / scale)`` clipped to
``[-127, 127]``.

Two properties the callers rely on:

* **the max element always lands exactly on ±127**, so
  ``quantize_rows(dequantize_rows(q, s))`` is the identity: a
  gather→dequant→requant→scatter update writes back bit-identical
  (q, scale) for untouched rows;
* **zero rows stay zero** (the scale is floored, not the values), so
  freshly allocated cache storage round-trips as exact zeros.

``torch.round`` rounds half to even, as ``jnp.round`` does, and the
division is IEEE fp32 in both, so codes and scales equal the JAX
package's bit for bit.  Both helpers are torch ops that queue on the
tensor's device; they read nothing back to the host, so they run inside
a captured decode step.  ``tools/check_hot_path.py`` lists this file so
a host sync added here is caught.
"""
from __future__ import annotations

import torch

__all__ = ["quantize_rows", "dequantize_rows", "INT8_SCALE_FLOOR"]

# scale floor: keeps all-zero rows representable (0 / floor == 0) and
# the dequant finite; any real row's absmax dominates it
INT8_SCALE_FLOOR = 1e-8


# hot-path: begin int8_quant (torch ops queued inside the step and verify
# fns, under capture on the card; a host sync here would land in every
# decode tick)
def quantize_rows(x):
    """Quantize ``x [..., row]`` to (int8 values, fp32 scales [...]).

    Symmetric per-row absmax: ``scale = max|row| / 127`` (floored at
    :data:`INT8_SCALE_FLOOR`), values ``round(row / scale)`` clipped to
    ``[-127, 127]``.  The row's max element maps to exactly ±127.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    scale = torch.clamp_min(x.abs().amax(dim=-1) / 127.0, INT8_SCALE_FLOOR)
    q = torch.clamp(torch.round(x / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_rows(q, scale):
    """Inverse of :func:`quantize_rows`: fp32 ``q * scale`` with the
    scale broadcast back over the row axis."""
    return q.to(torch.float32) * scale[..., None]
# hot-path: end int8_quant
