"""Decode attention over an int8 KV cache: the CUDA kernel's wrapper and
its plain version.

``decode_attention(q, k_codes, k_scale, v_codes, v_scale, ts, scale)``
computes, for slot ``s``, query ``j`` and head ``h``,
``softmax_t(q[s, j, h] . k_t * scale) . v_t`` over the positions
``t <= min(ts[s] + j, T - 1)``, where ``k_t = k_codes[s, h, t] *
k_scale[s, h, t]`` (``v_t`` likewise): the attention of the int8 pooled
LM step (one query a slot) and of the K-wide verify fn (K queries a
slot), as the JAX package's ``decoding.py`` computes it with
``dequantize_rows`` and masked einsums.  ``q`` is fp32 [S, K, H, Dh],
the codes int8 [S, H, T, Dh], the scales fp32 [S, H, T], ``ts`` int32
[S]; the result is fp32 [S, K, H, Dh].

By device:

* on CUDA tensors it launches ``csrc/decode_attention.cu`` (the step's
  entry for K = 1, the verify's for K <= 8; Dh of 32, 64 or 128), which
  reads the codes once and dequantizes them in registers, or raises:
  there is no fall back to the plain version on the card.  The positions
  of a (slot, head) are split over ``split_plan(T, S * H, SMs,
  tile_positions(K, Dh))[0]`` CTAs where the (slot, head) pairs alone
  would leave SMs idle, and their partials merged;
* on CPU tensors it runs ``decode_attention_plain``: dequantize, then the
  masked softmax attention in torch ops, the JAX package's math step for
  step;
* on meta tensors it returns a shape-only result.

``decode_attention_kernel`` is the card's path; its ``plan`` argument,
which the path leaves to ``split_plan``, exists for the card tests and
the timing of other splits.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels import build, count_launch

__all__ = ["KERNEL_NAME", "MAX_SPLIT", "MAX_VERIFY", "SPLIT_TILE", "decode_attention",
           "decode_attention_kernel", "decode_attention_plain", "split_plan", "tile_positions",
           "verify_width"]

KERNEL_NAME = "decode_attention_int8"
MAX_VERIFY = 8  # the widest K the verify entry serves
MAX_SPLIT = 8   # CTAs a (slot, head): the portable thread-block cluster size
SPLIT_TILE = 32  # positions: a chunk of the split plan is a multiple of this, the smallest tile
WARPS = 4  # warps a CTA, each staging a tile of positions at a time
CTAS_PER_SM = 2  # CTAs a launch keeps on each SM: its rings then hold enough bytes in flight
_LIB = "decode_attention"
_HEAD_DIMS = (32, 64, 128)
_bound = {}
_sm_count = {}


def tile_positions(K, Dh):
    """The positions a warp stages at once in the instantiation that serves
    K queries at head dim Dh: 64 at verify widths 4 and 8 with Dh <= 64,
    where a lane scores two positions, else SPLIT_TILE."""
    return 64 if verify_width(K) >= 4 and Dh <= 64 else SPLIT_TILE


def split_plan(T, rows=1, sms=132, tile=SPLIT_TILE):
    """``(C, chunk)``: the positions 0..T-1 of one (slot, head) split into
    C chunks of ``chunk`` positions (the last one shorter), one CTA each,
    for a launch over ``rows`` (slot, head) pairs on a card of ``sms``
    SMs, by a kernel whose warps stage ``tile`` positions at a time.  C is
    what keeps about CTAS_PER_SM CTAs on every SM, at most MAX_SPLIT, and
    leaves each CTA at least a tile for each of its WARPS warps (a shorter chunk
    idles warps: at the int8 server's 8- and 16-slot rungs such splits
    measured slower than none); ``chunk`` is a multiple of SPLIT_TILE, so
    every chunk starts on a 32-position boundary; each position falls in
    exactly one chunk."""
    T = int(T)
    if T < 1:
        raise ValueError("split_plan: T = %d, at least 1" % T)
    C = max(1, min(MAX_SPLIT, CTAS_PER_SM * int(sms) // max(1, int(rows)),
                   T // (WARPS * int(tile))))
    chunk = -(-T // C)
    chunk = -(-chunk // SPLIT_TILE) * SPLIT_TILE
    return -(-T // chunk), chunk


def verify_width(K):
    """The queries-a-slot width of the kernel instantiation that serves K:
    the next of 1, 2, 4, 8 at or above K."""
    if not 1 <= K <= MAX_VERIFY:
        raise ValueError("decode_attention kernel: %d queries a slot, 1 to %d" % (K, MAX_VERIFY))
    return next(w for w in (1, 2, 4, 8) if w >= K)


def decode_attention_plain(q, k_codes, k_scale, v_codes, v_scale, ts, scale):
    """The same function in torch ops on any device: the whole cache
    dequantized to fp32, scores masked to -1e9 above each query's
    position, softmax, the weighted sum of values."""
    from paddle_tpu_torch.quant import dequantize_rows

    K = q.shape[1]
    T = k_codes.shape[2]
    dev = q.device
    kf = dequantize_rows(k_codes, k_scale)
    vf = dequantize_rows(v_codes, v_scale)
    p = torch.clamp_max(ts.long()[:, None] + torch.arange(K, device=dev)[None, :], T - 1)
    pos_ok = torch.arange(T, device=dev)[None, None, None, :] <= p[:, :, None, None]
    scores = torch.einsum("skhd,shtd->skht", q, kf) * scale
    w = torch.softmax(torch.where(pos_ok, scores, -1e9), dim=-1)
    return torch.einsum("skht,shtd->skhd", w, vf)


def _entries():
    lib = build.load(_LIB)
    fns = _bound.get(id(lib))
    if fns is None:
        step = lib.paddle_decode_attention_int8_step
        step.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 6
                         + [ctypes.c_void_p] * 2)
        verify = lib.paddle_decode_attention_int8_verify
        verify.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 7
                           + [ctypes.c_void_p] * 2)
        step.restype = verify.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        fns = _bound[id(lib)] = (lib, step, verify)
    return fns


def _sms(device):
    n = _sm_count.get(device)
    if n is None:
        n = _sm_count[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _aligned(t):
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def decode_attention_kernel(q, k_codes, k_scale, v_codes, v_scale, ts, scale, *, plan=None):
    """The kernel on CUDA tensors, with the split ``plan`` ((C, chunk);
    default ``split_plan(T, S * H, the card's SMs, tile_positions(K, Dh))``),
    C > 1 merged over a
    thread-block cluster."""
    S, K, H, Dh = q.shape
    T = k_codes.shape[2]
    if any(t.device != q.device or t.device.type != "cuda"
           for t in (q, k_codes, k_scale, v_codes, v_scale, ts)):
        raise ValueError("decode_attention kernel takes CUDA tensors on one device")
    if Dh not in _HEAD_DIMS:
        raise ValueError("decode_attention kernel: head dim %d is not one of %s" % (Dh, _HEAD_DIMS))
    verify_width(K)
    if (k_codes.dtype, v_codes.dtype) != (torch.int8, torch.int8):
        raise TypeError("decode_attention kernel takes int8 codes, got %s, %s"
                        % (k_codes.dtype, v_codes.dtype))
    if tuple(k_codes.shape) != (S, H, T, Dh) or tuple(v_codes.shape) != (S, H, T, Dh):
        raise ValueError("decode_attention: codes %s, %s do not match q %s"
                         % (tuple(k_codes.shape), tuple(v_codes.shape), tuple(q.shape)))
    if (tuple(k_scale.shape) != (S, H, T) or tuple(v_scale.shape) != (S, H, T)
            or tuple(ts.shape) != (S,)):
        raise ValueError("decode_attention: scales %s, %s and ts %s do not match the codes %s"
                         % (tuple(k_scale.shape), tuple(v_scale.shape), tuple(ts.shape),
                            tuple(k_codes.shape)))
    q = q.float().contiguous()
    k_scale, v_scale = k_scale.float().contiguous(), v_scale.float().contiguous()
    ts = ts.to(torch.int32).contiguous()
    # the kernel's 16-byte copies: the pool's cache leaves are whole
    # contiguous allocations, so only an odd view pays this copy
    k_codes = k_codes if _aligned(k_codes) else k_codes.contiguous().clone()
    v_codes = v_codes if _aligned(v_codes) else v_codes.contiguous().clone()
    ctx = torch.empty_like(q)
    lib, step, verify = _entries()
    if plan is None:
        plan = split_plan(T, S * H, _sms(q.device), tile_positions(K, Dh))
    C, chunk = plan
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
                v_scale.data_ptr(), ts.data_ptr(), float(scale))
        if K == 1:
            err = step(*args, S, H, T, Dh, int(C), int(chunk), ctx.data_ptr(), stream)
        else:
            err = verify(*args, S, K, H, T, Dh, int(C), int(chunk), ctx.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: %s (cudaError %d)"
                           % (lib.paddle_cuda_error_string(err).decode(), err))
    count_launch(KERNEL_NAME, torch.int8, stream)
    return ctx


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, ts, scale):
    """The int8-KV decode attention: the kernel on CUDA tensors, the plain
    version on CPU tensors, shape-only on meta tensors (see the module
    docstring for the layouts)."""
    dev = q.device.type
    if dev == "meta":
        return torch.empty(q.shape, dtype=torch.float32, device="meta")
    if dev == "cpu":
        return decode_attention_plain(q, k_codes, k_scale, v_codes, v_scale, ts, scale)
    if dev != "cuda":
        raise ValueError("decode_attention: no kernel for device %s" % q.device)
    return decode_attention_kernel(q, k_codes, k_scale, v_codes, v_scale, ts, scale)
