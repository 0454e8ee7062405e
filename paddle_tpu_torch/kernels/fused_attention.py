"""Fused attention forward: the CUDA kernel's wrapper and its plain version.

``fused_attention_fwd`` is the ``fused_attention`` op's compute.  On a
CUDA tensor it launches ``csrc/fused_attention.cu`` (a hand-written
online-softmax attention for sm_90a; the source's head note says which
TPU kernel it replaces and what bounds it) or raises; there is no
fall back to the plain version on the card.  On a CPU tensor it runs
``fused_attention_plain``; on a meta tensor it returns a shape-only
result, which is what shape inference needs.

``fused_attention_plain`` is the op's einsum branch in the JAX package
(its ops/nn_ops.py:709-717) written out in torch: scores and softmax in
fp32, output in Q's dtype.  The CPU tests run it, and the
chip check holds the kernel against it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.kernels import build, count_launch

__all__ = ["fused_attention_fwd", "fused_attention_plain", "KERNEL_NAME"]

KERNEL_NAME = "fused_attention_fwd"
_LIB = "fused_attention"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_GRID_YZ = 65535

_bound = {}  # id(lib) -> bound C function


def fused_attention_plain(q, k, v, mask=None, causal: bool = False, scale: float = 1.0):
    """softmax(Q K^T * scale + causal + padding) V over [N, H, S, D]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    S = q.shape[2]
    if causal:
        idx = torch.arange(S, device=q.device)
        cm = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9)
        s = s + cm
    if mask is not None:
        s = s + ((mask.float() - 1.0) * 1e9)[:, None, None, :]
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _fn(lib):
    fn = _bound.get(id(lib))
    if fn is None:
        fn = lib.paddle_fused_attention_fwd
        fn.argtypes = (
            [ctypes.c_void_p] * 5          # q, k, v, mask, out
            + [ctypes.c_int] * 6           # dtype, n, h, sq, sk, d
            + [ctypes.c_int64] * 13        # q/k/v/out (n, h, s) strides, mask row stride
            + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]  # causal, scale, stream
        )
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _bound[id(lib)] = fn
    return fn


def _check(q, k, v, mask, causal):
    for name, t in (("Q", q), ("K", k), ("V", v)):
        if t.device != q.device:
            raise ValueError("fused_attention: %s on %s, Q on %s" % (name, t.device, q.device))
        if t.dtype != q.dtype:
            raise TypeError("fused_attention: %s is %s, Q is %s" % (name, t.dtype, q.dtype))
        if t.dim() != 4:
            raise ValueError("fused_attention: %s must be [N, H, S, D], got %s" % (name, tuple(t.shape)))
        if t.stride(-1) != 1:
            raise ValueError("fused_attention: %s needs a unit stride on its last dim" % name)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError("fused_attention kernel takes float32 or bfloat16, got %s" % q.dtype)
    n, h, sq, d = q.shape
    if k.shape[:2] != (n, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(
            "fused_attention: Q %s, K %s, V %s do not agree"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not 1 <= d <= _MAX_HEAD_DIM:
        raise ValueError("fused_attention kernel takes head dims 1..%d, got %d" % (_MAX_HEAD_DIM, d))
    if n > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError("fused_attention kernel takes N, H <= %d" % _MAX_GRID_YZ)
    if causal and k.shape[2] != sq:
        raise ValueError("fused_attention: causal needs as many keys as queries")
    if mask is not None:
        if mask.device != q.device:
            raise ValueError("fused_attention: Mask on %s, Q on %s" % (mask.device, q.device))
        if tuple(mask.shape) != (n, k.shape[2]):
            raise ValueError(
                "fused_attention: Mask must be [N, S_k] = %s, got %s"
                % ((n, k.shape[2]), tuple(mask.shape)))


def fused_attention_fwd(q, k, v, mask: Optional[torch.Tensor] = None,
                        causal: bool = False, scale: float = 1.0):
    """Attention over [N, H, S, D]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor, a shape-only result on a meta one."""
    if q.device.type == "meta":
        return torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device="meta")
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, mask, causal, scale)
    if q.device.type != "cuda":
        raise ValueError("fused_attention: no kernel for device %s" % q.device)
    _check(q, k, v, mask, causal)
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    n, h, sq, d = q.shape
    # empty_like keeps Q's memory layout: for the [N, S, H, D] views the
    # model's head split makes, Out comes back in that layout too, and
    # the transpose that follows it is then free
    out = torch.empty_like(q)
    fn = _fn(build.load(_LIB))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            _DTYPE_CODES[q.dtype], n, h, sq, k.shape[2], d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            mask.stride(0) if mask is not None else 0,
            int(bool(causal)), float(scale), stream,
        )
    if err != 0:
        lib = build.load(_LIB)
        raise RuntimeError(
            "fused_attention kernel launch failed: %s (cudaError %d)"
            % (lib.paddle_cuda_error_string(err).decode(), err))
    count_launch(KERNEL_NAME)
    return out
