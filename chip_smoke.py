#!/usr/bin/env python3
"""Chip smoke test of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on failure:

1. device: the card's name and power limit, torch / CUDA / nvcc /
   triton versions; TF32 is switched off for matmuls and cuDNN.
2. build: every CUDA source under ``paddle_tpu_torch/csrc/`` compiles
   with nvcc (one process per source, all at once); ptxas' register
   and shared-memory report is printed.
3. kernel check: each kernel's wrapper runs on the card at the serving
   path's shapes (and a ragged one) and is held against its plain
   PyTorch version; the kernel, the plain version and one PyTorch
   library call of the same function are timed with CUDA events, with
   the calls queued behind a spin kernel so that the events measure
   device time, not the host's launch overhead.
4. slice: full-width BERT-base (12 layers, d_model 768, 12 heads, seq
   128, random weights from a seed) is built with the port's layers,
   initialised on the card, saved with ``io.save_inference_model``,
   loaded by ``AnalysisPredictor`` and served by ``InferenceServer``
   (max_batch_size 16) to concurrent ``Client`` requests.  Every answer
   must be finite, match the same request run alone, and the served
   path must have launched the attention kernel 12 times per dispatch.
   One request is also held against the CPU predictor (plain PyTorch
   attention) on the same saved model.

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
]
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # fp32 summation order; 1-2 bf16 ulps
MAIN_CASE = (16, 12, 128, 64, "float32", False, "nshd")  # the served path's top bucket

# H100 SXM published peaks (NVIDIA data sheet, dense): bytes/s and op/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}

BERT_BASE = dict(vocab_size=30522, d_model=768, n_layer=12, n_head=12, d_inner=3072,
                 max_pos=512, seq_len=128)
SERVE_ROWS = [1, 3, 16, 5, 8, 2, 12, 7]   # concurrent requests, rows each
SERVE_TOL = 1e-4       # served vs the same request alone (batch shapes differ)
CPU_REF_TOL = 1e-3     # card vs CPU predictor: fp32 summation order over 12 layers


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
    return res


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


def _attn_inputs(torch, case, gen):
    n, h, s, d, dtype, causal, layout = case
    dt = getattr(torch, dtype)

    def make():
        if layout == "nshd":
            return torch.randn(n, s, h, d, generator=gen, device="cuda").to(dt).permute(0, 2, 1, 3)
        return torch.randn(n, h, s, d, generator=gen, device="cuda").to(dt)

    q, k, v = make(), make(), make()
    lens = torch.randint(1, s + 1, (n,), generator=gen, device="cuda")
    lens[0] = s  # one all-real row
    mask = (torch.arange(s, device="cuda")[None, :] < lens[:, None]).float()
    return q, k, v, mask


def _attn_bound(case):
    n, h, s, d, dtype, _, _ = case
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * n * h * s * d * item + n * s * 4   # Q, K, V read, Out written, Mask read
    ops = 4 * n * h * s * s * d                     # Q K^T and P V
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(torch):
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    results = []
    for case in ATTN_CASES:
        n, h, s, d, dtype, causal, layout = case
        q, k, v, mask = _attn_inputs(torch, case, gen)
        scale = 1.0 / float(np.sqrt(d))
        out = fa.fused_attention_fwd(q, k, v, mask, causal, scale)
        ref = fa.fused_attention_plain(q, k, v, mask, causal, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out.float()).all().item())
        # the library yardstick: one SDPA call with the same additive bias
        bias = ((mask - 1.0) * 1e9)[:, None, None, :]
        if causal:
            idx = torch.arange(s, device="cuda")
            bias = bias + torch.where(idx[None, :] <= idx[:, None], 0.0, -1e9)[None, None]
        bias = bias.to(q.dtype)
        kernel_ms = _time_ms(torch, lambda: fa.fused_attention_fwd(q, k, v, mask, causal, scale))
        plain_ms = _time_ms(torch, lambda: fa.fused_attention_plain(q, k, v, mask, causal, scale))
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=scale))
        bound_ms, bound_by = _attn_bound(case)
        row = {"shape": [n, h, s, d], "dtype": dtype, "causal": causal, "layout": layout,
               "max_abs_err": err, "tol": ATTN_TOL[dtype], "ms": kernel_ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log("[kernel] fused_attention_fwd", json.dumps(row))
        if not finite or not err <= ATTN_TOL[dtype]:
            raise AssertionError("fused_attention_fwd disagrees with its plain version: %s" % row)
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
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import paddle_tpu_torch  # noqa: F401 — fails outside a checkout of the repo
    from paddle_tpu_torch.kernels.fused_attention import KERNEL_NAME

    t_start = time.perf_counter()
    info = device_info(torch)
    build_kernels()
    checks = check_kernels(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stats = run_slice(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    main_row = dict(next(row for case, row in checks if case == MAIN_CASE))
    entry = {
        "name": KERNEL_NAME,
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/fused_attention.cu",
        "replaces": "paddle_tpu/ops/nn_ops.py:694 (pallas flash_attention fwd, "
                    "jax/experimental/pallas/ops/tpu/flash_attention.py:758)",
        "launches": stats["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
        "cases": [row for _, row in checks],
    }
    log("[done] %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [entry]}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
