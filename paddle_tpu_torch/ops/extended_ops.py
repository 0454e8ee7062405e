"""Extended ops: the part of the JAX package's ``ops/extended_ops.py``
ported so far.

* ``sampling_id`` (reference: sampling_id_op.cc).  The JAX package
  registers it twice, in ``ops/tensor_ops.py`` and here; this module is
  imported last, so this registration is the one it keeps, and the
  port's is this one.
* ``load`` (reference: load_op.cc), which ``layers.load`` appends.
* The alias lines at the end of the JAX file: names the reference
  registers for ops that another type computes.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.registry import _REGISTRY, register_op
from paddle_tpu_torch.ops.common import generator, one


@register_op("sampling_id", differentiable=False, random=True)
def sampling_id(inputs, attrs, device):
    """One id per row of the probabilities X [B, C], drawn from that row's
    distribution (the Gumbel-max draw ``jax.random.categorical`` makes,
    from a generator seeded with ``seed``, 7919 where that is 0); int64."""
    x = one(inputs, "X")
    if x.device.type == "meta":  # shape inference: no generator there
        return {"Out": torch.empty(x.shape[:1], dtype=torch.int64, device=x.device)}
    u = torch.rand(tuple(x.shape), generator=generator(int(attrs.get("seed", 0)) or 7919, x.device),
                   dtype=torch.float32, device=x.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    logits = torch.log(torch.clamp(x.to(torch.float32), min=1e-30))
    return {"Out": torch.argmax(logits - torch.log(-torch.log(u)), dim=1)}


def _load_array(path):
    try:
        return np.load(path, mmap_mode="r")
    except FileNotFoundError:
        return np.load(path + ".npy", mmap_mode="r")


@register_op("load", differentiable=False, host_read=True)
def load_op(inputs, attrs, device):
    """The array a ``save_vars`` file holds (``file_path``, or with
    ``.npy`` added), on ``device``; float64 comes back as float32, as
    the JAX package's arrays do.  The file is read on the host at every
    run (and its header when the op is appended, for the output's
    shape), so a plan holding the op stays on the interpreter."""
    arr = _load_array(attrs["file_path"])
    dt = core_types.torch_dtype(core_types.canonical_dtype(
        "float32" if arr.dtype == np.float64 else str(arr.dtype)))
    if device.type == "meta":
        return {"Out": torch.empty(arr.shape, dtype=dt, device=device)}
    return {"Out": torch.from_numpy(np.array(arr)).to(device=device, dtype=dt)}


def _alias(new, old):
    if old in _REGISTRY and new not in _REGISTRY:
        _REGISTRY[new] = _REGISTRY[old]


_alias("squeeze", "squeeze2")
_alias("unsqueeze", "unsqueeze2")
_alias("flatten", "flatten2")
_alias("fill_zeros_like2", "fill_zeros_like")
_alias("lstm", "dynamic_lstm")
_alias("lstmp", "dynamic_lstmp")
_alias("gru", "dynamic_gru")
_alias("fill", "fill_constant")
_alias("depthwise_conv2d_transpose", "conv2d_transpose")
