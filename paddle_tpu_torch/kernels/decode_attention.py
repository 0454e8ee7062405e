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
  there is no fall back to the plain version on the card;
* on CPU tensors it runs ``decode_attention_plain``: dequantize, then the
  masked softmax attention in torch ops, the JAX package's math step for
  step;
* on meta tensors it returns a shape-only result.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels import build, count_launch

__all__ = ["KERNEL_NAME", "MAX_VERIFY", "decode_attention", "decode_attention_plain"]

KERNEL_NAME = "decode_attention_int8"
MAX_VERIFY = 8  # the widest K the verify entry serves
_LIB = "decode_attention"
_HEAD_DIMS = (32, 64, 128)
_bound = {}


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
        step.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 4
                         + [ctypes.c_void_p] * 2)
        verify = lib.paddle_decode_attention_int8_verify
        verify.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 2)
        step.restype = verify.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        fns = _bound[id(lib)] = (lib, step, verify)
    return fns


def _aligned(t):
    return t.is_contiguous() and t.data_ptr() % 16 == 0


def _kernel(q, k_codes, k_scale, v_codes, v_scale, ts, scale):
    S, K, H, Dh = q.shape
    T = k_codes.shape[2]
    if Dh not in _HEAD_DIMS:
        raise ValueError("decode_attention kernel: head dim %d is not one of %s" % (Dh, _HEAD_DIMS))
    if K > MAX_VERIFY:
        raise ValueError("decode_attention kernel: %d queries a slot, at most %d"
                         % (K, MAX_VERIFY))
    if (k_codes.dtype, v_codes.dtype) != (torch.int8, torch.int8):
        raise TypeError("decode_attention kernel takes int8 codes, got %s, %s"
                        % (k_codes.dtype, v_codes.dtype))
    if tuple(k_codes.shape) != (S, H, T, Dh) or tuple(v_codes.shape) != (S, H, T, Dh):
        raise ValueError("decode_attention: codes %s, %s do not match q %s"
                         % (tuple(k_codes.shape), tuple(v_codes.shape), tuple(q.shape)))
    q = q.float().contiguous()
    k_scale, v_scale = k_scale.float().contiguous(), v_scale.float().contiguous()
    ts = ts.to(torch.int32).contiguous()
    # the kernel's 16-byte loads: the pool's cache leaves are whole
    # contiguous allocations, so only an odd view pays this copy
    k_codes = k_codes if _aligned(k_codes) else k_codes.contiguous().clone()
    v_codes = v_codes if _aligned(v_codes) else v_codes.contiguous().clone()
    ctx = torch.empty_like(q)
    lib, step, verify = _entries()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(), v_codes.data_ptr(),
                v_scale.data_ptr(), ts.data_ptr(), float(scale))
        if K == 1:
            err = step(*args, S, H, T, Dh, ctx.data_ptr(), stream)
        else:
            err = verify(*args, S, K, H, T, Dh, ctx.data_ptr(), stream)
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
    return _kernel(q, k_codes, k_scale, v_codes, v_scale, ts, scale)
