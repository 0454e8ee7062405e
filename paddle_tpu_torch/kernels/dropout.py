"""Dropout's training branch: the CUDA kernel's wrapper, its gradient,
and its plain version.

The mask is a pure function of the op's ``seed`` and each element's
index: Philox4x32-10 (Salmon et al., SC'11, "Random123") with key
(seed, 0) and counter (i // 4 as two 32-bit words, 0, 0) draws four
32-bit words, and element ``i`` takes word ``i % 4``; the element is kept
when the word's top 24 bits fall below ``keep_threshold(p)``.  So the
generic vjp grad op, which runs the forward again, sees the forward's
mask, and a captured CUDA graph replays the same bits: the op needs no
generator state.  (The JAX package's mask is a pure function of the seed
too, through ``jax.random``; the bits differ.)

By device, ``dropout_train``:

* on a CUDA tensor launches ``csrc/dropout.cu`` (fp32 or bf16), or
  raises; there is no fall back to the plain version on the card;
* on a CPU tensor runs ``dropout_plain``, the same Philox in torch int64
  ops, bit for bit the kernel's;
* on a meta tensor returns shape-only results.

Its gradient (``Dropout``, a ``torch.autograd.Function``) is
dX = where(Mask, dOut, 0), divided by the divisor under
``upscale_in_train``, as the JAX op's vjp gives it.
"""
from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.kernels import build, count_launch

__all__ = ["KERNEL_NAME", "Dropout", "divisor", "dropout_plain", "dropout_train",
           "keep_threshold", "philox4x32_10", "philox_words"]

KERNEL_NAME = "dropout"
_LIB = "dropout"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M0, _M1 = 0xD2511F53, 0xCD9E8D57    # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85    # its key increments
_MASK32 = 0xFFFFFFFF
_bound = {}


def keep_threshold(p: float) -> int:
    """round((1 - p) * 2**24) in float64: an element is kept when its
    word's top 24 bits are below it (all of them at p = 0)."""
    return int(round((1.0 - float(p)) * (1 << 24)))


def divisor(p: float, dtype: torch.dtype) -> float:
    """1 - p in ``dtype`` (as the JAX package's weakly typed scalar is
    rounded to X's type), returned as the float it is."""
    return float(torch.tensor(1.0 - float(p), dtype=dtype))


def _seed_word(seed: int) -> int:
    # 12345 where the op's seed is 0, as the JAX package's ops/common.py prng
    return (int(seed) if seed else 12345) & _MASK32


def _mulhilo(m: int, a):
    """(hi, lo) 32-bit halves of the 64-bit product m * a, for a constant
    m < 2**32 and an int64 tensor ``a`` of values < 2**32.  An int64
    product of two 32-bit values overflows the sign, so m is split into
    16-bit limbs: each partial product stays below 2**48."""
    p_lo = a * (m & 0xFFFF)
    t = a * (m >> 16) + (p_lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10 over int64 tensors holding 32-bit words: ``ctr`` a
    list of four tensors, ``key`` two ints.  Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_words(n: int, seed: int, device) -> torch.Tensor:
    """The int64 [n] words of elements 0..n-1 under ``seed``."""
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10([g & _MASK32, g >> 32, zero, zero], (_seed_word(seed), 0))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def dropout_plain(x, p: float, seed: int, upscale: bool):
    """(Out, Mask) of the training branch, in torch ops on any device:
    the kernel's arithmetic, bit for bit."""
    keep = ((philox_words(x.numel(), seed, x.device) >> 8) < keep_threshold(p)).reshape(x.shape)
    out = x
    if upscale:
        xf = x.float()
        out = (xf / torch.full_like(xf, divisor(p, x.dtype))).to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep, out, zero), keep.to(x.dtype)


def _entry():
    lib = build.load(_LIB)
    fn = _bound.get(id(lib))
    if fn is None:
        fn = lib.paddle_dropout
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_uint,
                                               ctypes.c_uint, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        _bound[id(lib)] = fn
    return lib, fn


def _kernel(x, p: float, seed: int, upscale: bool):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("dropout kernel takes float32 or bfloat16, got %s" % x.dtype)
    x = x.contiguous()
    out, mask = torch.empty_like(x), torch.empty_like(x)
    if x.numel() == 0:
        return out, mask
    lib, fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), mask.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype],
                 _seed_word(seed), keep_threshold(p), int(bool(upscale)),
                 divisor(p, x.dtype), stream)
    if err != 0:
        raise RuntimeError("dropout kernel launch failed: %s (cudaError %d)"
                           % (lib.paddle_cuda_error_string(err).decode(), err))
    count_launch(KERNEL_NAME, x.dtype, stream)
    return out, mask


def _forward(x, p, seed, upscale):
    if x.device.type == "meta":
        return torch.empty_like(x), torch.empty_like(x)
    if x.device.type == "cpu":
        return dropout_plain(x, p, seed, upscale)
    if x.device.type != "cuda":
        raise ValueError("dropout: no kernel for device %s" % x.device)
    return _kernel(x, p, seed, upscale)


class Dropout(torch.autograd.Function):
    """(Out, Mask) with Out's gradient where(Mask, dOut, 0), divided by
    the divisor under upscale_in_train.  No gradient reaches Mask."""

    @staticmethod
    def forward(ctx, x, p, seed, upscale):
        out, mask = _forward(x, p, seed, upscale)
        ctx.mark_non_differentiable(mask)
        ctx.save_for_backward(mask)
        ctx.div = divisor(p, x.dtype) if upscale else None
        return out, mask

    @staticmethod
    def backward(ctx, d_out, _d_mask):
        mask, = ctx.saved_tensors
        g = d_out
        if ctx.div is not None:  # a true division by a tensor, as the forward's
            gf = d_out.float()
            g = (gf / torch.full_like(gf, ctx.div)).to(d_out.dtype)
        return torch.where(mask != 0, g, torch.zeros((), dtype=g.dtype, device=g.device)), None, None, None


def dropout_train(x, p: float, seed: int, upscale: bool):
    """(Out, Mask) of dropout's training branch: the kernel on a CUDA
    tensor, the plain version on a CPU one, shape-only on a meta one;
    differentiable in X when a gradient is asked for."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Dropout.apply(x, float(p), int(seed), bool(upscale))
    return _forward(x, float(p), int(seed), bool(upscale))
