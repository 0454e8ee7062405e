"""Ring attention's merge step (kernel B2): the CUDA kernel's wrapper and
its plain version.

``ring_merge(o_a, stats_a, o_b, stats_b)`` folds one K/V block's attention
output ``o_b`` into the running output ``o_a`` of the same queries, by the
two blocks' row statistics in kernel B1's format (``stats[0]`` the row max
m of the scores, ``stats[1]`` log l, the log of the row sum of exp(s - m);
see ``kernels/fused_attention.py`` ``_row_stats`` and ``row_lse``):

    m = max(m_a, m_b),  w = exp((m_x - m) + log l_x) for x = a, b,
    l = w_a + w_b,      out = (o_a w_a + o_b w_b) / max(l, 1e-20),
    stats = (m, log l)

that is o_a e^(lse_a - lse) + o_b e^(lse_b - lse) with lse =
logaddexp(lse_a, lse_b).  A block with no valid key is the masked fill
(``MASKED_FILL``: m = -1e30, log l = -inf) and weighs nothing; two of them
merge to 0 with the masked fill's statistics: the ``max(l, 1e-20)``
guard of the JAX package's ``parallel/ring_attention.py``.

By device, ``ring_merge``:

* on a CUDA tensor launches ``csrc/ring_attention.cu`` (o in fp32 or bf16,
  statistics in fp32), or raises; there is no fall back to the plain
  version on the card;
* on a CPU tensor runs ``ring_merge_plain``, the same arithmetic in
  torch (fp32, or fp64 for fp64 inputs);
* on a meta tensor returns shape-only results.

The kernel counts its launches under ``KERNEL_NAME``
(``paddle_tpu_torch.kernels.launch_counts()``).
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels import build, count_launch

__all__ = ["KERNEL_NAME", "MASKED_FILL", "ring_merge", "ring_merge_plain"]

KERNEL_NAME = "ring_merge"
MASKED_FILL = (-1e30, float("-inf"))  # (m, log l) of a block with no valid key
_LIB = "ring_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_int64] * 9
         + [ctypes.c_void_p])
_bound = {}


def ring_merge_plain(o_a, stats_a, o_b, stats_b):
    """(out, stats) of the merge, in torch: the kernel's arithmetic in fp32
    (fp64 for fp64 inputs), out in o_a's dtype."""
    ct = torch.promote_types(o_a.dtype, torch.float32)
    sa, sb = stats_a.to(ct), stats_b.to(ct)
    m = torch.maximum(sa[0], sb[0])
    wa = torch.exp((sa[0] - m) + sa[1])
    wb = torch.exp((sb[0] - m) + sb[1])
    l = wa + wb
    out = (o_a.to(ct) * wa[..., None] + o_b.to(ct) * wb[..., None]) / l.clamp_min(1e-20)[..., None]
    return out.to(o_a.dtype), torch.stack([m, torch.log(l)]).to(stats_a.dtype)


def _check(o_a, stats_a, o_b, stats_b):
    if o_a.dim() != 4 or o_b.shape != o_a.shape:
        raise ValueError("ring_merge: o_a %s and o_b %s must be one [N, H, T, D] shape"
                         % (tuple(o_a.shape), tuple(o_b.shape)))
    if o_a.dtype not in _DTYPE_CODES or o_b.dtype != o_a.dtype:
        raise TypeError("ring_merge kernel takes float32 or bfloat16 outputs of one type, got "
                        "%s and %s" % (o_a.dtype, o_b.dtype))
    shape = (2,) + tuple(o_a.shape[:3])
    for name, t in (("o_a", o_a), ("o_b", o_b), ("stats_a", stats_a), ("stats_b", stats_b)):
        if t.device != o_a.device:
            raise ValueError("ring_merge: %s on %s, o_a on %s" % (name, t.device, o_a.device))
    for name, t in (("stats_a", stats_a), ("stats_b", stats_b)):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError("ring_merge: %s must be float32 %s, got %s %s"
                             % (name, list(shape), t.dtype, tuple(t.shape)))
    for name, t in (("o_a", o_a), ("o_b", o_b)):
        if t.stride(-1) != 1:
            raise ValueError("ring_merge: %s needs a unit stride on its last dim" % name)


def _entry():
    lib = build.load(_LIB)
    fn = _bound.get(id(lib))
    if fn is None:
        fn = lib.paddle_ring_merge
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _bound[id(lib)] = fn
    return lib, fn


def ring_merge(o_a, stats_a, o_b, stats_b):
    """(out, stats): ``o_b`` merged into ``o_a`` by their row statistics
    (see the module's docstring); the kernel on a CUDA tensor, the plain
    version on a CPU one, shape-only results on a meta one.  Returns new
    tensors; out keeps o_a's memory layout."""
    if o_a.device.type == "meta":
        return torch.empty_like(o_a), torch.empty_like(stats_a)
    if o_a.device.type == "cpu":
        return ring_merge_plain(o_a, stats_a, o_b, stats_b)
    if o_a.device.type != "cuda":
        raise ValueError("ring_merge: no kernel for device %s" % o_a.device)
    _check(o_a, stats_a, o_b, stats_b)
    stats_a, stats_b = stats_a.contiguous(), stats_b.contiguous()
    out = torch.empty_like(o_a)
    stats = torch.empty_like(stats_a)
    n, h, t, d = o_a.shape
    lib, fn = _entry()
    with torch.cuda.device(o_a.device):
        stream = torch.cuda.current_stream(o_a.device).cuda_stream
        err = fn(o_a.data_ptr(), stats_a.data_ptr(), o_b.data_ptr(), stats_b.data_ptr(),
                 out.data_ptr(), stats.data_ptr(), _DTYPE_CODES[o_a.dtype], n, h, t, d,
                 *[s for x in (o_a, o_b, out) for s in x.stride()[:3]], stream)
    if err != 0:
        raise RuntimeError("ring_merge kernel launch failed: %s (cudaError %d)"
                           % (lib.paddle_cuda_error_string(err).decode(), err))
    count_launch(KERNEL_NAME, o_a.dtype, stream)
    return out, stats
