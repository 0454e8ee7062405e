"""Ring attention's step (kernel B2): the CUDA kernel's wrapper and its
plain version.

A rank of the ring attends each K/V block that reaches it and folds the
block into the running output ``acc`` of its queries, by the row
statistics in kernel B1's format (``stats[0]`` the row max m of the
scores, ``stats[1]`` log l, the log of the row sum of exp(s - m); see
``kernels/fused_attention.py`` ``_row_stats`` and ``row_lse``).  The
merge of a block's output o_b into o_a:

    m = max(m_a, m_b),  w = exp((m_x - m) + log l_x) for x = a, b,
    l = w_a + w_b,      out = (o_a w_a + o_b w_b) / max(l, 1e-20),
    stats = (m, log l)

that is o_a e^(lse_a - lse) + o_b e^(lse_b - lse) with lse =
logaddexp(lse_a, lse_b).  A block with no valid key is the masked fill
(``MASKED_FILL``: m = -1e30, log l = -inf) and weighs nothing; two of them
merge to 0 with the masked fill's statistics: the ``max(l, 1e-20)``
guard of the JAX package's ``parallel/ring_attention.py``.

``ring_step(q, k, v, causal, scale, acc=None, acc_stats=None)`` is one
hop: the attention of ``q`` against the block ``k``, ``v`` (no Mask),
merged into ``acc`` and ``acc_stats`` when they are given.  By device:

* on a CUDA tensor, without ``acc`` it launches B1's forward with its
  statistics (``fused_attention._forward(..., want_stats=True)``,
  counted under ``fused_attention.KERNEL_NAME``); with ``acc`` it
  launches B1's forward with the merge in its epilogue
  (``csrc/fused_attention.cu``'s kMerge instantiation, counted under
  ``KERNEL_NAME``), which writes the merged rows and statistics into
  ``acc`` and ``acc_stats`` in place and returns them.  The block's own
  output never leaves the SM, and a hop is one launch.  A failed launch
  raises; there is no fall back to the plain version on the card;
* on a CPU tensor runs ``ring_step_plain``: ``fused_attention_plain``
  with its statistics, then ``ring_merge_plain`` written into ``acc``
  and ``acc_stats`` in place;
* on a meta tensor returns shape-only results.

The ring's backward attends each block again: ``ring_block_bwd(q, k, v,
causal, scale, d_out, stats, di)`` is dQ, dK, dV of one block given the
ring's final statistics (the rows' (m, log l) over every block, so a
block's probabilities sum to less than 1) and Di = rowsum(O * dO) of the
ring's final output.  P = exp((s - m) - log l) of the block's scores is
then that block's share of the softmax, and the block's terms of the
whole attention's gradient are B1's backward with those statistics: on a
CUDA tensor B1's dK/dV and dQ kernels (``fused_attention_bwd_dkv``,
``fused_attention_bwd_dq``, counted under their names) or a raise, on a
CPU tensor ``ring_block_bwd_plain`` (B1's plain backward,
``fused_attention._bwd_plain``), on a meta tensor shapes.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels import count_launch
from paddle_tpu_torch.kernels import fused_attention as fa

__all__ = ["KERNEL_NAME", "MASKED_FILL", "ring_merge_plain", "ring_step", "ring_step_plain",
           "ring_block_bwd", "ring_block_bwd_plain"]

KERNEL_NAME = "ring_step"
MASKED_FILL = (-1e30, float("-inf"))  # (m, log l) of a block with no valid key
_ARGS = ([ctypes.c_void_p] * 5           # q, k, v, acc, acc_stats
         + [ctypes.c_int] * 6             # dtype, n, h, sq, sk, d
         + [ctypes.c_void_p]              # 12 strides (q, k, v, acc)
         + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])  # causal, scale, stream


def ring_merge_plain(o_a, stats_a, o_b, stats_b):
    """(out, stats) of the merge, in torch: fp32 (fp64 for fp64 inputs),
    out in o_a's dtype.  Returns new tensors."""
    ct = torch.promote_types(o_a.dtype, torch.float32)
    sa, sb = stats_a.to(ct), stats_b.to(ct)
    m = torch.maximum(sa[0], sb[0])
    wa = torch.exp((sa[0] - m) + sa[1])
    wb = torch.exp((sb[0] - m) + sb[1])
    l = wa + wb
    out = (o_a.to(ct) * wa[..., None] + o_b.to(ct) * wb[..., None]) / l.clamp_min(1e-20)[..., None]
    return out.to(o_a.dtype), torch.stack([m, torch.log(l)]).to(stats_a.dtype)


def ring_step_plain(q, k, v, causal: bool, scale: float, acc=None, acc_stats=None):
    """``ring_step`` in torch, on any device: B1's plain forward with its
    statistics; with ``acc``, that block merged into ``acc`` and
    ``acc_stats`` by ``ring_merge_plain``, written there in place, and
    those two returned."""
    out, stats = fa.fused_attention_plain(q, k, v, None, causal, scale, return_stats=True)
    if acc is None:
        return out, stats
    merged, merged_stats = ring_merge_plain(acc, acc_stats, out, stats)
    acc.copy_(merged)
    acc_stats.copy_(merged_stats)
    return acc, acc_stats


def _check(q, acc, acc_stats):
    shape = tuple(q.shape[:3])
    if tuple(acc.shape) != tuple(q.shape):
        raise ValueError("ring_step: acc %s must be Q's shape %s"
                         % (tuple(acc.shape), tuple(q.shape)))
    if acc.dtype != q.dtype or acc.device != q.device:
        raise TypeError("ring_step: acc is %s on %s, Q is %s on %s"
                        % (acc.dtype, acc.device, q.dtype, q.device))
    if acc.stride(-1) != 1:
        raise ValueError("ring_step: acc needs a unit stride on its last dim")
    if (acc_stats is None or acc_stats.dtype != torch.float32 or acc_stats.device != q.device
            or tuple(acc_stats.shape) != (2,) + shape or not acc_stats.is_contiguous()):
        raise ValueError("ring_step: acc_stats must be contiguous float32 %s on %s"
                         % ([2] + list(shape), q.device))


def ring_step(q, k, v, causal: bool, scale: float, acc=None, acc_stats=None):
    """(out, stats) of one ring hop over [N, H, T, D] (see the module's
    docstring): the block's attention with its row statistics when
    ``acc`` is None, else the block merged into ``acc`` and ``acc_stats``
    in place, which are returned.  The kernels on a CUDA tensor, the plain
    version on a CPU one, shape-only results on a meta one."""
    if q.device.type == "meta":
        if acc is not None:
            return acc, acc_stats
        return fa._forward(q, k, v, None, causal, scale, want_stats=True)
    if q.device.type == "cpu":
        return ring_step_plain(q, k, v, causal, scale, acc, acc_stats)
    if acc is None:
        return fa._forward(q, k, v, None, causal, scale, want_stats=True)
    if q.device.type != "cuda":
        raise ValueError("ring_step: no kernel for device %s" % q.device)
    fa._check(q, k, v, None, causal)
    _check(q, acc, acc_stats)
    n, h, sq, d = q.shape
    strides = (ctypes.c_int64 * 12)(*fa._strides(q, k, v, acc))
    fn = fa._entry(fa._LIB, "paddle_fused_attention_ring_step", _ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(), acc_stats.data_ptr(),
                 fa._DTYPE_CODES[q.dtype], n, h, sq, k.shape[2], d, ctypes.addressof(strides),
                 int(bool(causal)), float(scale), stream)
    fa._raise_on(err, fa._LIB, "ring_step")
    count_launch(KERNEL_NAME, q.dtype, stream)
    return acc, acc_stats


def ring_block_bwd_plain(q, k, v, causal: bool, scale: float, d_out, stats, di):
    """dQ, dK, dV of one block of the ring, in torch on any device: B1's
    plain backward from the ring's final statistics and Di (fp32 [N, H,
    T]), results in the inputs' dtype."""
    return fa._bwd_plain(q, k, v, None, causal, scale, d_out, stats, di)


def ring_block_bwd(q, k, v, causal: bool, scale: float, d_out, stats, di):
    """dQ, dK, dV of one block of the ring (see the module's docstring):
    B1's dK/dV and dQ kernels on a CUDA tensor, the plain version on a CPU
    one, shape-only results on a meta one."""
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return ring_block_bwd_plain(q, k, v, causal, scale, d_out, stats, di)
    dk, dv = fa.fused_attention_bwd_dkv(q, k, v, None, causal, scale, d_out, stats, di)
    return fa.fused_attention_bwd_dq(q, k, v, None, causal, scale, d_out, stats, di), dk, dv
