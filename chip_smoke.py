#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: the card's name and power limit, torch / CUDA / nvcc /
   triton versions; TF32 is switched off for matmuls and cuDNN.
2. build: every CUDA source under ``paddle_tpu_torch/csrc/`` compiles
   with nvcc (one process per source, all at once); ptxas' register
   report is printed, each attention kernel's SASS (forward, dK/dV, dQ,
   every type and head dim) must hold wgmma (HGMMA) and no atomics, and
   its launch configuration (threads, rows, walked tile, shared memory)
   is printed.
3. kernel check: each kernel's wrapper runs on the card at the main
   paths' shapes (and a ragged one) and is held against its plain
   PyTorch version; the kernel, the plain version and one PyTorch
   library call of the same function are timed with CUDA events, with
   the calls queued behind a spin kernel so that the events measure
   device time, not the host's launch overhead.  The forward kernel
   (with and without its row statistics output) comes first, then the
   backward's dK/dV and dQ kernels, whose library yardstick is the
   backward of ``scaled_dot_product_attention``.  Every kernel is also
   held on batches with an all-pad row, and two launches on the same
   inputs must give the same bits.
4. serving slice: full-width BERT-base (12 layers, d_model 768, 12
   heads, seq 128, random weights from a seed) is built with the port's
   layers, initialised on the card, saved with
   ``io.save_inference_model``, loaded by ``AnalysisPredictor`` and
   served by ``InferenceServer`` (max_batch_size 16) to concurrent
   ``Client`` requests.  Every answer must be finite, match the same
   request run alone, and the served path must have launched the
   attention kernel 12 times per dispatch.  One request is also held
   against the CPU predictor (plain PyTorch attention) on the same saved
   model.
5. training slice: full-width BERT-base pretraining (``bert_pretrain``,
   MLM + NSP, fused attention, dropout off, ``AdamOptimizer(1e-4)``,
   fp32) runs its startup on the card, one warm-up step and 3 steps on
   one batch of 32 rows.  Every loss must be finite, the 3rd step's
   below the 1st's, and each step must launch 12 dK/dV, 12 dQ and 24
   forward attention kernels (each grad op runs the forward again for
   its log-sum-exp).  Two steps at batch 2 are held against the port's
   own CPU run of the same steps from the same state (the losses, and
   three parameters' gradients in the first step).

Output: progress lines, then a ``{"kernels": [...]}`` line, the card's
``nvidia-smi`` name and power limit, and last ``{"ok": true, "device":
{...}}``.  Without a CUDA device it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 1234

# the attention kernel's checks: (N, H, S, D, dtype, causal, layout).
# "nshd" is the head-transposed [N, S, H, D] view the model feeds it.
ATTN_CASES = [
    (1, 12, 128, 64, "float32", False, "nshd"),
    (1, 12, 128, 64, "float32", True, "nshd"),
    (16, 12, 128, 64, "float32", False, "nshd"),
    (16, 12, 128, 64, "float32", True, "nshd"),
    (1, 12, 128, 64, "bfloat16", False, "nshd"),
    (16, 12, 128, 64, "bfloat16", False, "nshd"),
    (16, 12, 128, 64, "bfloat16", True, "nshd"),
    (3, 4, 77, 32, "float32", True, "contiguous"),
    (3, 4, 77, 32, "bfloat16", False, "contiguous"),
    (32, 12, 128, 64, "float32", False, "nshd"),
]
# the forward on a batch whose last row is all pad (checked, not timed), with
# and without the row statistics output
ATTN_ALL_PAD_CASES = [
    (8, 12, 128, 64, "float32", False, "nshd"),
    (8, 12, 128, 64, "float32", True, "nshd"),
    (8, 12, 128, 64, "bfloat16", False, "nshd"),
    (8, 12, 128, 64, "bfloat16", True, "nshd"),
    (3, 4, 77, 32, "float32", True, "contiguous"),
    (3, 4, 77, 32, "bfloat16", False, "contiguous"),
]
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # fp32 summation order; 1-2 bf16 ulps
MAIN_CASE = (16, 12, 128, 64, "float32", False, "nshd")  # the served path's top bucket
TRAIN_CASE = (32, 12, 128, 64, "float32", False, "nshd")  # the training slice's shape
# the backward kernels' checks, same layout of a case
BWD_CASES = [
    (32, 12, 128, 64, "float32", False, "nshd"),
    (32, 12, 128, 64, "float32", True, "nshd"),
    (32, 12, 128, 64, "bfloat16", False, "nshd"),
    (32, 12, 128, 64, "bfloat16", True, "nshd"),
    (1, 12, 128, 64, "float32", False, "nshd"),
    (3, 4, 77, 32, "float32", False, "contiguous"),
    (3, 4, 77, 32, "bfloat16", True, "contiguous"),
]
# the backward kernels on a batch whose last row is all pad (checked, not timed)
BWD_ALL_PAD_CASES = [
    (8, 12, 128, 64, "float32", False, "nshd"),
    (8, 12, 128, 64, "float32", True, "nshd"),
    (8, 12, 128, 64, "bfloat16", False, "nshd"),
    (8, 12, 128, 64, "bfloat16", True, "nshd"),
    (3, 4, 77, 32, "float32", True, "contiguous"),
]
LSE_TOL = 1e-4  # fp32 log-sum-exp and row max, each row relative to max(1, |ref|)

# H100 SXM published peaks (NVIDIA data sheet, dense).  Operations are
# bounded at the tensor cores' rate: bf16 at 989 TFLOP/s; fp32 as 3xTF32
# (three TF32 products per product, the least tensor-core work that keeps
# fp32's accuracy) at 495 TFLOP/s.  (factor, op/s) by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": (3, 495e12), "bfloat16": (1, 989e12)}

BERT_BASE = dict(vocab_size=30522, d_model=768, n_layer=12, n_head=12, d_inner=3072,
                 max_pos=512, seq_len=128)
SERVE_ROWS = [1, 3, 16, 5, 8, 2, 12, 7]   # concurrent requests, rows each
SERVE_TOL = 1e-4       # served vs the same request alone (batch shapes differ)
CPU_REF_TOL = 1e-3     # card vs CPU predictor: fp32 summation order over 12 layers
TRAIN_BATCH = 32
TRAIN_MASKS = int(0.15 * BERT_BASE["seq_len"])  # masked positions per row, as bench_bert.py
TRAIN_STEPS = 3        # timed steps, after one warm-up step
CHECK_BATCH = 2        # the card-vs-CPU training step
TRAIN_TOL = 1e-3       # card vs CPU step, relative: fp32 sums over 12 layers, forward and back
CHECK_GRADS = ["bert_word_emb", "bert_enc_0_att_q_w", "bert_enc_11_ffn_fc1_w"]


def log(*args):
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def device_info(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from paddle_tpu_torch.kernels import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_ver = triton.__version__
    except ImportError as e:
        triton_ver = "not importable (%s)" % e
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc,
        "triton": triton_ver,
        "device": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
    }
    log("[device]", json.dumps(info))
    return info


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def build_kernels():
    from paddle_tpu_torch.kernels import build

    t0 = time.perf_counter()
    res = build.build()
    log("[build] %d source(s) in %.2f s" % (len(res), time.perf_counter() - t0))
    for name, r in res.items():
        log("[build] %s: %.2f s -> %s" % (name, r["seconds"], os.path.relpath(r["path"], REPO)))
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("[build]   " + line.strip())
    check_build(res["fused_attention"]["path"], res["fused_attention_bwd"]["path"])
    return res


def check_build(fwd_path, bwd_path):
    """Each attention kernel instantiation (forward, dK/dV, dQ; fp32 and
    bf16; D32, 64, 128) issues wgmma (HGMMA in its SASS, read with
    cuobjdump) and no atomics; and its launch configuration."""
    import ctypes
    import re

    from paddle_tpu_torch.kernels import build

    counts = {}
    for path in (fwd_path, bwd_path):
        sass = subprocess.run([os.path.join(os.path.dirname(build._nvcc()), "cuobjdump"), "-sass",
                               path], capture_output=True, text=True, check=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            name = chunk.split(None, 1)[0]
            kind = re.search(r"fused_attention_(fwd|bwd_dkv|bwd_dq)_kernel", name)
            if kind is None:
                continue
            label = "%s %s D%s" % (kind.group(1).replace("bwd_", ""),
                                   "bf16" if "bfloat16" in name else "fp32",
                                   re.search(r"Li(\d+)E", name).group(1))
            counts[label] = {"HGMMA": len(re.findall(r"\bHGMMA\.", chunk)),
                             "atomics": len(re.findall(r"\b(ATOM|ATOMS|RED)\.", chunk))}
    log("[build] attention SASS", json.dumps(counts, sort_keys=True))
    if len(counts) != 18 or any(c["HGMMA"] == 0 or c["atomics"] for c in counts.values()):
        raise AssertionError("attention kernels without wgmma or with atomics: %s" % counts)
    cfg = (ctypes.c_int * 4)()
    fwd_config = ctypes.CDLL(fwd_path).paddle_fused_attention_fwd_config
    fwd_config.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)]
    bwd_config = ctypes.CDLL(bwd_path).paddle_fused_attention_bwd_config
    bwd_config.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fwd_config.restype = bwd_config.restype = None
    for kind in ("fwd", "dkv", "dq"):
        for dtype, tname in ((0, "fp32"), (1, "bf16")):
            for dp in (32, 64, 128):
                if kind == "fwd":
                    fwd_config(dtype, dp, cfg)
                else:
                    bwd_config(0 if kind == "dkv" else 1, dtype, dp, cfg)
                log("[build] %s %s D%d: %d threads, %d rows a block, walked tiles of %d, "
                    "%d bytes of shared memory" % (kind, tname, dp, *cfg))


# ---------------------------------------------------------------------------
# phase 3: kernel check
# ---------------------------------------------------------------------------
def _time_ms(torch, fn, samples=21, per_sample=10):
    """Device time of one call of ``fn``, in ms: the median over
    ``samples`` of the mean of ``per_sample`` back-to-back calls.

    Each sample first queues a spin kernel (``torch.cuda._sleep``) that
    lasts at least three times as long as the host takes to enqueue the
    calls, so every call is queued before the card reaches it and the
    events bracket device work only.  Timing single calls between two
    events measures the host's launch overhead instead, whenever that
    is longer than the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(per_sample):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 1 << 20
    while True:
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        b.synchronize()
        if a.elapsed_time(b) > 3e3 * host_s:
            break
        cycles *= 2
    times = []
    for _ in range(samples):
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(per_sample):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_sample)
    return statistics.median(times)


def _ops_s(ops, dtype):
    factor, rate = PEAK_OPS[dtype]
    return factor * ops / rate


def _attn_inputs(torch, case, gen, all_pad=False):
    n, h, s, d, dtype, causal, layout = case
    dt = getattr(torch, dtype)

    def make():
        if layout == "nshd":
            return torch.randn(n, s, h, d, generator=gen, device="cuda").to(dt).permute(0, 2, 1, 3)
        return torch.randn(n, h, s, d, generator=gen, device="cuda").to(dt)

    q, k, v = make(), make(), make()
    lens = torch.randint(1, s + 1, (n,), generator=gen, device="cuda")
    lens[0] = s  # one all-real row
    if all_pad:
        lens[-1] = 0  # and one all-pad row
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None]).float()
    return q, k, v, mask


def _attn_bound(case):
    n, h, s, d, dtype, _, _ = case
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * n * h * s * d * item + n * s * 4   # Q, K, V read, Out written, Mask read
    ops = 4 * n * h * s * s * d                     # Q K^T and P V
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, _ops_s(ops, dtype)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _bias(torch, mask, causal, s):
    """The additive bias of Mask and the causal term, [N, 1, S, S] or [N, 1, 1, S]."""
    bias = ((mask - 1.0) * 1e9)[:, None, None, :]
    if causal:
        idx = torch.arange(s, device="cuda")
        bias = bias + torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9)[None, None]
    return bias


def _rel_err(got, ref):
    """(max abs err, whether every element is within LSE_TOL * max(1, |ref|))."""
    err = (got - ref).abs()
    return err.max().item(), bool((err <= LSE_TOL * ref.abs().clamp(min=1.0)).all().item())


def check_kernels(torch):
    """The forward kernel against ``fused_attention_plain`` on the same
    inputs; a second launch gives the same bits.  ATTN_CASES are timed
    beside the plain version and one SDPA call.  ATTN_ALL_PAD_CASES (a
    batch with an all-pad row) are checked only, with and without the row
    statistics: Out against the plain version both times, the statistics'
    row max against the plain version's and their log-sum-exp against
    torch.logsumexp of the fp32 scores, and both launches repeated bit
    for bit."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for case, all_pad in [(c, False) for c in ATTN_CASES] + [(c, True) for c in ATTN_ALL_PAD_CASES]:
        n, h, s, d, dtype, causal, layout = case
        q, k, v, mask = _attn_inputs(torch, case, gen, all_pad)
        scale = 1.0 / float(np.sqrt(d))
        out = fa.fused_attention_fwd(q, k, v, mask, causal, scale)
        again = fa.fused_attention_fwd(q, k, v, mask, causal, scale)
        ref = fa.fused_attention_plain(q, k, v, mask, causal, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all().item())
        repeat = bool(torch.equal(out, again))
        ok = finite and repeat and err <= ATTN_TOL[dtype]
        row = {"shape": [n, h, s, d], "dtype": dtype, "causal": causal, "layout": layout,
               "all_pad_row": all_pad, "repeat_bit_equal": repeat, "max_abs_err": err,
               "tol": ATTN_TOL[dtype]}
        bias = _bias(torch, mask, causal, s)
        if all_pad:
            # with the row statistics: the same Out, and statistics that
            # carry the all-pad row's uniform softmax
            out_s, stats = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_stats=True)
            out_s2, stats2 = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_stats=True)
            _, ref_stats = fa.fused_attention_plain(q, k, v, mask, causal, scale, return_stats=True)
            scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale + bias
            m_err, m_ok = _rel_err(stats[0], ref_stats[0])
            lse_err, lse_ok = _rel_err(fa.row_lse(stats), torch.logsumexp(scores, dim=-1))
            out_err = (out_s.float() - ref.float()).abs().max().item()
            row["stats_max_abs_err"] = {"out": out_err, "row_max": m_err, "lse": lse_err}
            row["stats_repeat_bit_equal"] = bool(torch.equal(out_s, out_s2) and torch.equal(stats, stats2))
            row["stats_out_bit_equal"] = bool(torch.equal(out_s, out))
            ok = (ok and row["stats_repeat_bit_equal"] and row["stats_out_bit_equal"]
                  and m_ok and lse_ok and out_err <= ATTN_TOL[dtype])
        else:
            # the library yardstick: one SDPA call with the same additive bias
            bias = bias.to(q.dtype)
            row["ms"] = _time_ms(torch, lambda: fa.fused_attention_fwd(q, k, v, mask, causal, scale))
            row["plain_ms"] = _time_ms(torch, lambda: fa.fused_attention_plain(
                q, k, v, mask, causal, scale))
            row["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=scale))
            row["bound_ms"], row["bound_by"] = _attn_bound(case)
            if case == TRAIN_CASE:  # the grad ops run it with the row statistics output
                row["ms_with_stats"] = _time_ms(torch, lambda: fa.fused_attention_fwd(
                    q, k, v, mask, causal, scale, return_stats=True))
        log("[kernel] fused_attention_fwd", json.dumps(row))
        if not ok:
            raise AssertionError("fused_attention_fwd disagrees with its plain version: %s" % row)
        results.append((case, row))
    return results


def _bwd_bounds(case):
    """{kernel name: (bound ms, what bounds it)} for the two backward kernels."""
    n, h, s, d, dtype, _, _ = case
    item = 4 if dtype == "float32" else 2
    nhsd = n * h * s * d
    small = 3 * n * h * s * 4 + n * s * 4  # row max, log row sum, Di read (fp32), Mask read
    work = {  # bytes (each input read once, each output written once), operations
        "dkv": (6 * nhsd * item + small, 8 * n * h * s * s * d),  # Q K V dO in, dK dV out
        "dq": (5 * nhsd * item + small, 6 * n * h * s * s * d),   # Q K V dO in, dQ out
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, _ops_s(ops, dtype)
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def _within(got, ref, dtype):
    """The backward checks' limits: fp32 max abs err <= 1e-4 * max(1,
    max|ref|); bf16 atol 2e-2 plus rtol 2^-7, the forward's bf16 rule."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if dtype == "float32":
        return err.max().item(), bool(err.max().item() <= 1e-4 * max(1.0, ref.abs().max().item()))
    return err.max().item(), bool((err <= 2e-2 + 2.0 ** -7 * ref.abs()).all().item())


def _bwd_fp64(torch, fa, q, k, v, mask, causal, scale, d_out):
    """dQ, dK, dV in float64 from the op's fp32 scores: the softmax and
    every product in float64, nothing taken from the kernels.  The scores
    stay those of fp32 (an fp64 score would keep q.k on an all-pad row,
    where fp32's -1e9 absorbs it and the softmax is uniform)."""
    s = fa._scores(q.float(), k.float(), mask, causal, scale).double()
    p = torch.softmax(s, dim=-1)
    q, k, v, do = q.double(), k.double(), v.double(), d_out.double()
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale,
            torch.einsum("bhqk,bhqd->bhkd", ds, q) * scale,
            torch.einsum("bhqk,bhqd->bhkd", p, do))


def check_bwd_kernels(torch):
    """The dK/dV and dQ kernels against ``fused_attention_bwd_plain`` on the
    same inputs (the forward kernel's Out and row statistics), fp32 also
    against a float64 reference; two launches on the same inputs give the
    same bits; the log-sum-exp rebuilt from the row statistics against
    torch.logsumexp of the plain fp32 scores.  BWD_CASES are timed;
    BWD_ALL_PAD_CASES (a batch with an all-pad row) are checked only."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    results = []
    for case, all_pad in [(c, False) for c in BWD_CASES] + [(c, True) for c in BWD_ALL_PAD_CASES]:
        n, h, s, d, dtype, causal, layout = case
        q, k, v, mask = _attn_inputs(torch, case, gen, all_pad)
        d_out = _attn_inputs(torch, case, gen)[0]  # dO arrives in the head split's layout too
        scale = 1.0 / float(np.sqrt(d))
        out, stats = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_stats=True)
        lse = fa.row_lse(stats)
        bias = _bias(torch, mask, causal, s)
        scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale + bias
        lse_err, lse_ok = _rel_err(lse, torch.logsumexp(scores, dim=-1))
        di = (out.float() * d_out.float()).sum(-1)

        def kernels_once():
            dk_, dv_ = fa.fused_attention_bwd_dkv(q, k, v, mask, causal, scale, d_out, stats, di)
            return fa.fused_attention_bwd_dq(q, k, v, mask, causal, scale, d_out, stats, di), dk_, dv_

        dq, dk, dv = kernels_once()
        again = kernels_once()
        rq, rk, rv = fa.fused_attention_bwd_plain(q, k, v, mask, causal, scale, out, d_out, stats)
        torch.cuda.synchronize()
        repeat = all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
        errs = {name: _within(g, r, dtype) for name, g, r in (("dq", dq, rq), ("dk", dk, rk),
                                                              ("dv", dv, rv))}
        if dtype == "float32":
            # the plain version on the card may round as the kernels do, so
            # also hold the kernels to a float64 reference, with the same limit
            r64 = _bwd_fp64(torch, fa, q, k, v, mask, causal, scale, d_out)
            errs.update({name + "_vs_fp64": _within(g, r, dtype) for name, g, r in
                         (("dq", dq, r64[0]), ("dk", dk, r64[1]), ("dv", dv, r64[2]))})
        finite = all(bool(torch.isfinite(g.float()).all().item()) for g in (dq, dk, dv))
        row = {"shape": [n, h, s, d], "dtype": dtype, "causal": causal, "layout": layout,
               "all_pad_row": all_pad, "repeat_bit_equal": repeat,
               "max_abs_err": {name: e for name, (e, _) in errs.items()}, "lse_max_abs_err": lse_err}
        if not all_pad:
            row["dkv_ms"] = _time_ms(torch, lambda: fa.fused_attention_bwd_dkv(
                q, k, v, mask, causal, scale, d_out, stats, di))
            row["dq_ms"] = _time_ms(torch, lambda: fa.fused_attention_bwd_dq(
                q, k, v, mask, causal, scale, d_out, stats, di))
            row["plain_ms"] = _time_ms(torch, lambda: fa.fused_attention_bwd_plain(
                q, k, v, mask, causal, scale, out, d_out, stats))
            # the library yardstick: the backward of one SDPA call with the
            # same additive bias, timed without its forward
            qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bias.to(q.dtype), scale=scale)
            row["library_ms"] = _time_ms(torch, lambda: torch.autograd.grad(
                o, (qs, ks, vs), d_out, retain_graph=True))
            for key, (bound, by) in _bwd_bounds(case).items():
                row[key + "_bound_ms"], row[key + "_bound_by"] = bound, by
        log("[kernel] fused_attention_bwd", json.dumps(row))
        if not (finite and lse_ok and repeat and all(ok for _, ok in errs.values())):
            raise AssertionError("fused_attention backward disagrees with its plain version: %s"
                                 % row)
        results.append((case, row))
    return results


# ---------------------------------------------------------------------------
# phase 4: the serving slice at full width
# ---------------------------------------------------------------------------
def _feed(rng, rows, seq_len, vocab):
    ids = rng.randint(0, vocab, (rows, seq_len)).astype("int64")
    lens = rng.randint(1, seq_len + 1, rows)
    lens[0] = seq_len
    mask = (np.arange(seq_len)[None, :] < lens[:, None]).astype("float32")
    return {"src_ids": ids, "input_mask": mask}


def run_slice(torch, workdir):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, serving
    from paddle_tpu_torch.kernels.fused_attention import KERNEL_NAME
    from paddle_tpu_torch.models import transformer

    seq = BERT_BASE["seq_len"]
    stats = {}
    kernels.reset_launch_counts()  # counts from here on belong to the main path
    t0 = time.perf_counter()
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [seq], dtype="int64")
        mask = fluid.layers.data("input_mask", [seq], dtype="float32")
        enc = transformer.bert_encoder(ids, mask, dropout_rate=0.0, is_test=True,
                                       fused_attention=True, **BERT_BASE)
    stats["build_s"] = time.perf_counter() - t0
    exe = fluid.Executor()  # cuda:0
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    stats["startup_s"] = time.perf_counter() - t0
    model_dir = os.path.join(workdir, "bert_base")
    t0 = time.perf_counter()
    fluid.io.save_inference_model(model_dir, ["src_ids", "input_mask"], [enc], exe,
                                  main_program=main, scope=scope)
    stats["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred = fluid.inference.create_paddle_predictor(fluid.inference.AnalysisConfig(model_dir))
    stats["load_s"] = time.perf_counter() - t0
    if pred.device.type != "cuda":
        raise AssertionError("default predictor is on %s, not the card" % pred.device)
    server = serving.InferenceServer(pred, max_batch_size=16, batch_timeout_ms=5.0)
    t0 = time.perf_counter()
    server.warmup()
    stats["warmup_s"] = time.perf_counter() - t0

    rng = np.random.RandomState(SEED)
    feeds = [_feed(rng, r, seq, BERT_BASE["vocab_size"]) for r in SERVE_ROWS]
    client = serving.Client(server)
    answers, lat = [None] * len(feeds), [None] * len(feeds)
    errors = []

    def one(i):
        t = time.perf_counter()
        try:
            answers[i] = client.infer(feeds[i])
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append((i, repr(e)))
        lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(feeds))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    wall = time.perf_counter() - t0
    server.stop(drain=True, timeout=60)
    counts = kernels.launch_counts()  # read right after the main path
    m = server.metrics()
    if errors or any(a is None for a in answers) or any(t.is_alive() for t in threads):
        raise AssertionError("requests failed: %s" % errors)

    dispatches = m["batches"] + m["warmup_runs"]
    launches = counts.get(KERNEL_NAME, 0)
    stats.update(dispatches=dispatches, batches=m["batches"], warmup_runs=m["warmup_runs"],
                 launches=launches, rows=sum(SERVE_ROWS), wall_s=wall,
                 rows_per_s=sum(SERVE_ROWS) / wall,
                 latency_ms_p50=1e3 * statistics.median(lat), latency_ms_max=1e3 * max(lat))
    if launches != BERT_BASE["n_layer"] * dispatches or launches == 0:
        raise AssertionError(
            "%s launched %d times over %d dispatches (expected %d per dispatch)"
            % (KERNEL_NAME, launches, dispatches, BERT_BASE["n_layer"]))

    worst = 0.0
    for f, (out,) in zip(feeds, answers):
        rows = f["src_ids"].shape[0]
        if out.shape != (rows, seq, BERT_BASE["d_model"]) or not np.isfinite(out).all():
            raise AssertionError("bad served output: shape %s" % (out.shape,))
        alone, = pred.run(f)
        worst = max(worst, float(np.abs(out - alone).max()))
    stats["served_vs_alone_max_abs"] = worst
    if not worst <= SERVE_TOL:
        raise AssertionError("served answers differ from the request alone by %g" % worst)

    cpu_cfg = fluid.inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    cpu_pred = fluid.inference.create_paddle_predictor(cpu_cfg)
    ref, = cpu_pred.run(feeds[1])
    cpu_err = float(np.abs(answers[1][0] - ref).max())
    stats["card_vs_cpu_max_abs"] = cpu_err
    if not cpu_err <= CPU_REF_TOL:
        raise AssertionError("card and CPU predictors differ by %g" % cpu_err)
    log("[slice]", json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 5: the training slice at full width
# ---------------------------------------------------------------------------
def pretrain_program(fluid, transformer):
    """(main, startup, [total, mlm_loss, nsp_acc], params_grads) of fused
    BERT-base pretraining with Adam."""
    s = BERT_BASE["seq_len"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ins = [fluid.layers.data(name, [w], dtype=dt) for name, w, dt in (
            ("src_ids", s, "int64"), ("sent_ids", s, "int64"), ("input_mask", s, "float32"),
            ("mask_pos", 1, "int64"), ("mask_label", 1, "int64"), ("nsp_label", 1, "int64"))]
        outs = transformer.bert_pretrain(*ins, dropout_rate=0.0, fused_attention=True, **BERT_BASE)
        _, params_grads = fluid.optimizer.AdamOptimizer(1e-4).minimize(outs[0])
    return main, startup, list(outs), params_grads


def pretrain_feed(rng, rows):
    """Random pad tails leave each row half to all of its tokens real; the
    masked positions (flattened into [rows * seq]) and [CLS] lie on real
    tokens; sentence B is the second half of the real tokens."""
    s, vocab, masks = BERT_BASE["seq_len"], BERT_BASE["vocab_size"], TRAIN_MASKS
    lens = rng.randint(s // 2, s + 1, rows)
    lens[0] = s
    pos = np.stack([rng.choice(np.arange(1, lens[i]), masks, replace=False) + i * s
                    for i in range(rows)])
    return {
        "src_ids": rng.randint(0, vocab, (rows, s)).astype("int64"),
        "sent_ids": (np.arange(s)[None, :] >= (lens[:, None] // 2)).astype("int64"),
        "input_mask": (np.arange(s)[None, :] < lens[:, None]).astype("float32"),
        "mask_pos": pos.reshape(-1, 1).astype("int64"),
        "mask_label": rng.randint(0, vocab, (rows * masks, 1)).astype("int64"),
        "nsp_label": rng.randint(0, 2, (rows, 1)).astype("int64"),
    }


def _profile_step(torch, step):
    """One step under torch.profiler: its wall time, the device time of its
    kernels and the card's idle share, the host's own time in ops, the
    attention kernels' device time and share, and the top kernels and host
    ops; None when the profiler reports no device time.  The profiler's
    own cost lengthens the host side of this step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels_, host_ops = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:  # a kernel (or copy) on the card
            kernels_.append((e.key, e.self_device_time_total / 1e3, e.count))
        else:  # a host-side op: its own CPU time, children excluded
            host_ops.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    if not kernels_:
        return None
    kernels_.sort(key=lambda r: -r[1])
    host_ops.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kernels_)
    attention = [{"name": k[:90], "ms": t, "calls": c} for k, t, c in kernels_
                 if "fused_attention" in k]
    return {"step_ms": wall_ms, "device_ms": device_ms, "device_idle_share": 1 - device_ms / wall_ms,
            "host_self_ms": sum(r[1] for r in host_ops),
            "launches": sum(r[2] for r in kernels_),
            "attention_kernels": attention,
            "attention_share_of_device": sum(r["ms"] for r in attention) / device_ms,
            "top_kernels": [{"name": k[:90], "ms": t, "calls": c} for k, t, c in kernels_[:12]],
            "top_host_ops": [{"name": k[:60], "ms": t, "calls": c} for k, t, c in host_ops[:12]]}


def run_train(torch):
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import fused_attention as fa
    from paddle_tpu_torch.models import transformer

    sync = torch.cuda.synchronize
    batch, n_layer = TRAIN_BATCH, BERT_BASE["n_layer"]
    names = (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME)
    per_step = {fa.KERNEL_NAME: 2 * n_layer, fa.BWD_DKV_NAME: n_layer, fa.BWD_DQ_NAME: n_layer}
    stats = {"batch": batch, "seq_len": BERT_BASE["seq_len"], "masks_per_row": TRAIN_MASKS}
    t0 = time.perf_counter()
    main, startup, outs, params_grads = pretrain_program(fluid, transformer)
    stats["build_s"] = time.perf_counter() - t0
    stats["ops"] = len(main.global_block().ops)
    exe = fluid.Executor()  # cuda:0
    scope = fluid.Scope()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    sync()
    stats["startup_s"] = time.perf_counter() - t0
    feed = pretrain_feed(np.random.RandomState(SEED), batch)
    stats["real_tokens"] = int(feed["input_mask"].sum())

    def step(fetch=outs):
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope)

    kernels.reset_launch_counts()  # counts from here on belong to the training path
    losses, times, deltas = [], [], []
    for _ in range(1 + TRAIN_STEPS):
        before = kernels.launch_counts()
        sync()
        t = time.perf_counter()
        total, mlm, acc = step()
        sync()
        times.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        deltas.append({k: after.get(k, 0) - before.get(k, 0) for k in names})
        losses.append({"total": float(total), "mlm": float(mlm), "nsp_acc": float(acc[0])})
    counts = kernels.launch_counts()  # read right after the training path
    stats["launches"] = {k: counts.get(k, 0) for k in names}
    stats["launches_per_step"] = deltas
    stats["losses"] = losses
    stats["step_s"] = times
    step_s = statistics.median(times[1:])
    stats["step_ms_median"] = 1e3 * step_s
    stats["tokens_per_s"] = batch * BERT_BASE["seq_len"] / step_s
    stats["real_tokens_per_s"] = stats["real_tokens"] / step_s
    stats["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    bad = [i for i, d in enumerate(deltas) if d != per_step]
    if bad:
        raise AssertionError("step(s) %s launched %s, expected %s per step"
                             % (bad, [deltas[i] for i in bad], per_step))
    if not all(np.isfinite([l["total"], l["mlm"]]).all() for l in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    if not losses[-1]["total"] < losses[1]["total"]:
        raise AssertionError("loss did not fall over the timed steps: %s" % losses)

    # what the step costs without its backward: the forward alone, which is
    # also what the generic vjp grad ops recompute
    test_prog = main.clone(for_test=True)
    fwd_times = []
    for _ in range(1 + TRAIN_STEPS):
        sync()
        t = time.perf_counter()
        exe.run(test_prog, feed=feed, fetch_list=[outs[0].name], scope=scope)
        sync()
        fwd_times.append(time.perf_counter() - t)
    stats["forward_only_ms_median"] = 1e3 * statistics.median(fwd_times[1:])
    try:
        stats["profile"] = _profile_step(torch, step)
    except RuntimeError as e:  # the profiler's own failure: the numbers are then not measured
        stats["profile"] = "not measured (%s)" % e
    log("[train]", json.dumps(stats))
    return stats


def check_train_against_cpu():
    """Two steps at ``batch`` from the same state on the card and on the
    CPU: the first step's loss and gradients of CHECK_GRADS, and the
    second step's loss (after each device's Adam update), agree within
    TRAIN_TOL, relative to the CPU's largest magnitude."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.scope import to_numpy

    main, startup, outs, params_grads = pretrain_program(fluid, transformer)
    grads = {p.name: g.name for p, g in params_grads}
    fetch = [outs[0].name] + [grads[n] for n in CHECK_GRADS]
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    fluid.io.set_params_from_numpy(
        cpu_scope, {n: to_numpy(v) for n, v in card_scope.vars.items()}, "cpu")
    feed = pretrain_feed(np.random.RandomState(SEED + 2), CHECK_BATCH)
    t0 = time.perf_counter()
    card = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    t1 = time.perf_counter()
    cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    t2 = time.perf_counter()
    # a second step: the loss after each device's own Adam update
    card2 = card_exe.run(main, feed=feed, fetch_list=fetch[:1], scope=card_scope)
    cpu2 = cpu_exe.run(main, feed=feed, fetch_list=fetch[:1], scope=cpu_scope)
    stats = {"batch": CHECK_BATCH, "card_s": t1 - t0, "cpu_s": t2 - t1,
             "loss_card": [float(card[0]), float(card2[0])],
             "loss_cpu": [float(cpu[0]), float(cpu2[0])], "rel_err": {}}
    ok = True
    for name, a, b in zip(["total", "total_step2"] + CHECK_GRADS,
                          [card[0], card2[0]] + card[1:], [cpu[0], cpu2[0]] + cpu[1:]):
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        stats["rel_err"][name] = rel
        ok = ok and bool(np.isfinite(a).all()) and rel <= TRAIN_TOL
    log("[train-check]", json.dumps(stats))
    if not ok:
        raise AssertionError("card and CPU training steps differ: %s" % stats)
    return stats


# ---------------------------------------------------------------------------
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import paddle_tpu_torch  # noqa: F401 — fails outside a checkout of the repo
    from paddle_tpu_torch.kernels import fused_attention as fa

    t_start = time.perf_counter()
    info = device_info(torch)
    build_kernels()
    checks = check_kernels(torch)
    bwd_checks = check_bwd_kernels(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stats = run_slice(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    train = run_train(torch)
    check_train_against_cpu()

    def row_of(rows, case):  # the timed row of a case
        return dict(next(row for c, row in rows if c == case and not row["all_pad_row"]))

    main_row, train_row = row_of(checks, MAIN_CASE), row_of(checks, TRAIN_CASE)
    bwd_row = row_of(bwd_checks, TRAIN_CASE)
    fwd_launches = {"serve": stats["launches"], "train": train["launches"][fa.KERNEL_NAME]}
    replaced = ("jax/experimental/pallas/ops/tpu/flash_attention.py:%d (%s), reached from "
                "paddle_tpu/ops/nn_ops.py:694 through the vjp grad paddle_tpu/core/registry.py:131")
    entries = [{
        "name": fa.KERNEL_NAME,
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_attention.cu",
        "replaces": "paddle_tpu/ops/nn_ops.py:694 (pallas flash_attention fwd, "
                    "jax/experimental/pallas/ops/tpu/flash_attention.py:758)",
        "launches": sum(fwd_launches.values()),
        "launches_by_path": fwd_launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
        "train_shape": train_row,
        "cases": [row for _, row in checks],
    }]
    for name, key, line, fn, errs in (
            (fa.BWD_DKV_NAME, "dkv", 1121, "_flash_attention_bwd_dkv", ("dk", "dv")),
            (fa.BWD_DQ_NAME, "dq", 1456, "_flash_attention_bwd_dq", ("dq",))):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_attention_bwd.cu",
            "replaces": replaced % (line, fn),
            "launches": train["launches"][name],
            "max_abs_err": max(bwd_row["max_abs_err"][e] for e in errs),
            "ms": bwd_row[key + "_ms"],
            # one plain backward and one SDPA backward compute dQ, dK and dV together
            "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row[key + "_bound_ms"],
            "bound_by": bwd_row[key + "_bound_by"],
            "library_ms": bwd_row["library_ms"],
            "shape": bwd_row["shape"],
            "dtype": bwd_row["dtype"],
            "cases": [row for _, row in bwd_checks],
        })
    log("[done] %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": entries}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
