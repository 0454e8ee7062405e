"""Fused attention: the CUDA kernels' wrappers, the op's gradient, and
their plain versions.

``fused_attention_fwd`` is the ``fused_attention`` op's compute.  When a
gradient is asked for (grad mode on and Q, K or V requiring grad) it
runs through ``FusedAttention``, a ``torch.autograd.Function`` whose
forward also keeps the row log-sum-exp and whose backward is
``fused_attention_bwd``.  Otherwise it runs the forward alone, without
the log-sum-exp, as the serving path does.

By device, each function (forward and backward):

* on a CUDA tensor launches its hand-written kernels for sm_90a, or
  raises; there is no fall back to the plain version on the card.  The
  forward is ``csrc/fused_attention.cu``, the backward is the dK/dV and
  dQ kernels of ``csrc/fused_attention_bwd.cu``; each source's head note
  says which TPU kernel it replaces and what bounds it;
* on a CPU tensor runs the plain version (``fused_attention_plain``,
  ``fused_attention_bwd_plain``);
* on a meta tensor returns shape-only results, which is what shape
  inference needs.

The plain versions are the op's einsum branch in the JAX package (its
ops/nn_ops.py:709-717) and that branch's vjp, written out in torch:
scores and softmax in fp32 (fp64 for fp64 inputs), results in Q's
dtype.  The CPU tests run them, and the chip check holds the kernels
against them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddle_tpu_torch.kernels import build, count_launch

__all__ = ["fused_attention_fwd", "fused_attention_bwd", "fused_attention_bwd_dkv",
           "fused_attention_bwd_dq", "fused_attention_plain", "fused_attention_bwd_plain",
           "FusedAttention", "KERNEL_NAME", "BWD_DKV_NAME", "BWD_DQ_NAME"]

KERNEL_NAME = "fused_attention_fwd"
BWD_DKV_NAME = "fused_attention_bwd_dkv"
BWD_DQ_NAME = "fused_attention_bwd_dq"
_LIB = "fused_attention"
_BWD_LIB = "fused_attention_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_GRID_YZ = 65535

_bound = {}  # (id(lib), entry name) -> bound C function


def _scores(q, k, mask, causal: bool, scale: float):
    """Q K^T * scale + causal + padding over [N, H, S, S], in fp32 (fp64
    for fp64 inputs), the terms added in the op's order."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(ct) * scale
    S = q.shape[2]
    if causal:
        idx = torch.arange(S, device=q.device)
        cm = torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9)
        s = s + cm.to(ct)
    if mask is not None:
        s = s + ((mask.to(ct) - 1.0) * 1e9)[:, None, None, :]
    return s


def fused_attention_plain(q, k, v, mask=None, causal: bool = False, scale: float = 1.0,
                          return_lse: bool = False):
    """softmax(Q K^T * scale + causal + padding) V over [N, H, S, D]; with
    ``return_lse`` also the row log-sum-exp [N, H, S] of the scores taken
    in fp32 from the inputs' values, as the kernel takes them (for bf16
    inputs the output's scores are products rounded to bf16, as in the
    reference)."""
    s = _scores(q, k, mask, causal, scale)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v)
    if return_lse:
        ct = torch.promote_types(q.dtype, torch.float32)
        if q.dtype != ct:
            s = _scores(q.to(ct), k.to(ct), mask, causal, scale)
        return out, torch.logsumexp(s, dim=-1)
    return out


def fused_attention_bwd_plain(q, k, v, mask, causal: bool, scale: float, out, d_out, lse):
    """dQ, dK, dV of ``fused_attention_plain`` given the upstream d_out,
    rebuilt from the forward's output and row log-sum-exp:
    P = exp(s - lse), dV = P^T dO, dS = P * (dO V^T - rowsum(O * dO)),
    dQ = scale * dS K, dK = scale * dS^T Q.  No gradient reaches Mask."""
    ct = torch.promote_types(q.dtype, torch.float32)
    di = (out.to(ct) * d_out.to(ct)).sum(-1)
    return _bwd_plain(q, k, v, mask, causal, scale, d_out, lse, di)


def _bwd_plain(q, k, v, mask, causal, scale, d_out, lse, di):
    """The plain backward from Di = rowsum(O * dO) instead of O.  The
    scores are recomputed from Q and K widened to fp32 (as the kernels
    widen them when they stage a tile), so P = exp(s - lse) matches the
    log-sum-exp the forward kernel wrote for bf16 inputs too."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = _scores(q.to(ct), k.to(ct), mask, causal, scale)
    p = torch.exp(s - lse.to(ct)[..., None])
    do = d_out.to(ct)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.to(ct))
    ds = p * (dp - di.to(ct)[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(ct)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(ct)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _entry(lib_name: str, entry: str, argtypes):
    """The C function ``entry`` of kernel library ``lib_name``, bound once."""
    lib = build.load(lib_name)
    fn = _bound.get((id(lib), entry))
    if fn is None:
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _bound[(id(lib), entry)] = fn
    return fn


_FWD_ARGS = (
    [ctypes.c_void_p] * 6          # q, k, v, mask, out, lse
    + [ctypes.c_int] * 6           # dtype, n, h, sq, sk, d
    + [ctypes.c_int64] * 13        # q/k/v/out (n, h, s) strides, mask row stride
    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]  # causal, scale, stream
)
_BWD_ARGS = (
    [ctypes.c_void_p] * 10         # q, k, v, mask, dout, lse, di, dq, dk, dv
    + [ctypes.c_int] * 6           # dtype, n, h, sq, sk, d
    + [ctypes.c_void_p, ctypes.c_int64]  # 21 strides (q k v dout dq dk dv), mask row stride
    + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p]  # causal, scale, stream
)


def _raise_on(err: int, lib_name: str, what: str) -> None:
    if err != 0:
        msg = build.load(lib_name).paddle_cuda_error_string(err).decode()
        raise RuntimeError("%s kernel launch failed: %s (cudaError %d)" % (what, msg, err))


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


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


def _forward(q, k, v, mask, causal: bool, scale: float, want_lse: bool):
    """(Out, LSE or None) by device: the kernel, the plain version, or
    shape-only results."""
    if q.device.type == "meta":
        out = torch.empty(q.shape[:3] + v.shape[3:], dtype=q.dtype, device="meta")
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device="meta") if want_lse else None
        return out, lse
    if q.device.type == "cpu":
        if want_lse:
            return fused_attention_plain(q, k, v, mask, causal, scale, return_lse=True)
        return fused_attention_plain(q, k, v, mask, causal, scale), None
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
    lse = torch.empty((n, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
    fn = _entry(_LIB, "paddle_fused_attention_fwd", _FWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr() if mask is not None else None, out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            _DTYPE_CODES[q.dtype], n, h, sq, k.shape[2], d,
            *_strides(q, k, v, out),
            mask.stride(0) if mask is not None else 0,
            int(bool(causal)), float(scale), stream,
        )
    _raise_on(err, _LIB, "fused_attention")
    count_launch(KERNEL_NAME)
    return out, lse


def _launch_bwd(entry: str, name: str, q, k, v, mask, causal, scale, d_out, lse, di,
                dq=None, dk=None, dv=None):
    """One backward kernel on tensors ``fused_attention_bwd`` has checked."""
    n, h, sq, d = q.shape
    outs = [t if t is not None else q for t in (dq, dk, dv)]  # strides of unused outputs
    strides = (ctypes.c_int64 * 21)(*_strides(q, k, v, d_out, *outs))
    ptrs = [t.data_ptr() if t is not None else None
            for t in (q, k, v, mask, d_out, lse, di, dq, dk, dv)]
    fn = _entry(_BWD_LIB, entry, _BWD_ARGS)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*ptrs, _DTYPE_CODES[q.dtype], n, h, sq, k.shape[2], d,
                 ctypes.addressof(strides), mask.stride(0) if mask is not None else 0,
                 int(bool(causal)), float(scale), stream)
    _raise_on(err, _BWD_LIB, name)
    count_launch(name)


def _bwd_inputs(q, k, v, mask, causal, d_out, lse, di):
    """Check and lay out a CUDA backward's inputs."""
    if q.device.type != "cuda":
        raise ValueError("fused_attention: no kernel for device %s" % q.device)
    _check(q, k, v, mask, causal)
    n, h, sq, _ = q.shape
    if d_out.device != q.device or d_out.dtype != q.dtype or d_out.shape != q.shape:
        raise ValueError("fused_attention backward: dOut is %s %s on %s, Q is %s %s"
                         % (d_out.dtype, tuple(d_out.shape), d_out.device, q.dtype, tuple(q.shape)))
    for name, t in (("LSE", lse), ("Di", di)):
        if t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (n, h, sq):
            raise ValueError("fused_attention backward: %s must be float32 [N, H, S_q] on %s"
                             % (name, q.device))
    if d_out.stride(-1) != 1:  # autograd may hand over any layout
        d_out = d_out.contiguous()
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    return mask, d_out, lse.contiguous(), di.contiguous()


def fused_attention_bwd_dkv(q, k, v, mask, causal: bool, scale: float, d_out, lse, di):
    """dK, dV: the dK/dV kernel on a CUDA tensor, the plain backward's
    dK, dV on a CPU tensor.  ``di`` is rowsum(O * dO), fp32 [N, H, S_q]."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, mask, causal, scale, d_out, lse, di)[1:]
    mask, d_out, lse, di = _bwd_inputs(q, k, v, mask, causal, d_out, lse, di)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("paddle_fused_attention_bwd_dkv", BWD_DKV_NAME, q, k, v, mask, causal, scale,
                d_out, lse, di, dk=dk, dv=dv)
    return dk, dv


def fused_attention_bwd_dq(q, k, v, mask, causal: bool, scale: float, d_out, lse, di):
    """dQ: the dQ kernel on a CUDA tensor, the plain backward's dQ on a
    CPU tensor.  ``di`` is rowsum(O * dO), fp32 [N, H, S_q]."""
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, mask, causal, scale, d_out, lse, di)[0]
    mask, d_out, lse, di = _bwd_inputs(q, k, v, mask, causal, d_out, lse, di)
    dq = torch.empty_like(q)
    _launch_bwd("paddle_fused_attention_bwd_dq", BWD_DQ_NAME, q, k, v, mask, causal, scale,
                d_out, lse, di, dq=dq)
    return dq


def fused_attention_bwd(q, k, v, mask, causal: bool, scale: float, out, d_out, lse):
    """dQ, dK, dV of the attention, given its output, the upstream
    gradient d_out and the forward's row log-sum-exp: the dK/dV and dQ
    kernels on a CUDA tensor, the plain version on a CPU tensor,
    shape-only results on a meta one."""
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, mask, causal, scale, out, d_out, lse)
    if out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError("fused_attention backward: Out is %s %s on %s, Q is %s %s"
                         % (out.dtype, tuple(out.shape), out.device, q.dtype, tuple(q.shape)))
    # Di = rowsum(O * dO): a reduction beside the kernels, as XLA did it
    # beside the TPU's
    di = (out.float() * d_out.float()).sum(-1)
    dk, dv = fused_attention_bwd_dkv(q, k, v, mask, causal, scale, d_out, lse, di)
    dq = fused_attention_bwd_dq(q, k, v, mask, causal, scale, d_out, lse, di)
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The op with its gradient: forward keeps Out and the row
    log-sum-exp, backward is ``fused_attention_bwd``.  No gradient
    reaches Mask, causal or scale."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        out, lse = _forward(q, k, v, mask, causal, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, mask, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, mask, ctx.causal, ctx.scale, out, d_out, lse)
        return dq, dk, dv, None, None, None


def fused_attention_fwd(q, k, v, mask: Optional[torch.Tensor] = None,
                        causal: bool = False, scale: float = 1.0, return_lse: bool = False):
    """Attention over [N, H, S, D]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor, a shape-only result on a meta one.

    Differentiable in Q, K and V: when a gradient is asked for, this runs
    ``FusedAttention``.  ``return_lse`` also returns the row
    log-sum-exp (fp32 [N, H, S]), outside autograd."""
    if return_lse:
        return _forward(q, k, v, mask, causal, scale, want_lse=True)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FusedAttention.apply(q, k, v, mask, bool(causal), float(scale))
    return _forward(q, k, v, mask, causal, scale, want_lse=False)[0]
