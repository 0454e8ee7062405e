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
   ``Client`` requests.  The warm-up runs each bucket once (eagerly);
   a bucket's second served batch captures it as a CUDA graph.  Every
   answer must be finite, match the same request run alone, and the
   served path must have launched the attention kernel 12 times per
   dispatch and built no cache entry after the warm-up.  Each request
   through the captured predictor is held against the eager executor
   (``use_program_cache=False``) on the same saved model, and one
   against the CPU predictor (plain PyTorch attention).
5. training slice: full-width BERT-base pretraining (``bert_pretrain``,
   MLM + NSP, fused attention, dropout off, ``AdamOptimizer(1e-4)``,
   fp32) runs its startup on the card, then steps on one batch of 32
   rows: the entry's eager step, its captured step, and 5 timed
   replays.  Every loss must be finite, the last step's below the
   2nd's, and each step must launch 12 dK/dV, 12 dQ and 24 forward
   attention kernels (each grad op runs the forward again for its row
   statistics), in fp32.  Two steps at batch 2 are held against the
   port's own CPU run of the same steps from the same state (the
   losses, and three parameters' gradients in the first step).
6. captured against eager: the fp32 training slice from one initial
   state, three steps through the cached (captured) executor against
   three eager ones (``use_program_cache=False``), and ``steps=3,
   per_step_feed=True`` against three single captured runs; with the
   unprofiled step time of both paths.
7. AMP training slice: phase 5 with ``contrib.mixed_precision.decorate(
   AdamOptimizer(1e-4))`` (bf16 AMP, as bench_bert.py trains it): the
   same checks, with every attention launch in bf16, and two steps at
   batch 2 against the CPU within the AMP tolerance.
8. ResNet-50 training in bf16 AMP, as bench.py's run_resnet runs it
   (224x224x3 NHWC, 1000 classes, ``decorate(MomentumOptimizer(0.1,
   0.9))``, batch 256, batches staged on the card): the card's startup,
   the entry's eager step, its captured step and 5 timed replays; step
   time, images/s, the share of the bf16 dense peak (bench.py's 3 x 4.09
   GFLOP an image), peak memory, the graph pool, one profiled replay
   (idle share, kernels by class) and one eager step's device time by op
   type (each grad op apart from the forward the generic vjp runs again
   inside it).  Losses finite, the step captured, no attention kernel
   launched.  Then two steps at batch 2 against the port's CPU run from
   the same state (phase 7's measures, the relative L2 distance of all
   the gradients, and the CPU's own distance under a 1e-6 nudge of the
   images as the yardstick), and each step's Momentum update against a
   float64 numpy one.
9. ResNet-50 training in fp32 (NCHW, batch 128, no TF32): phase 8's
   run and checks.
10. ResNet-50 captured against eager (fp32, NCHW, batch 32): three steps
   from one state, the losses, parameters, velocities and batch_norm
   running statistics (which batch_norm reads and writes in place);
   then a checkpoint round trip: ``save_persistables`` after two steps,
   ``load_persistables`` into a fresh scope, and the next step's loss
   there against the uninterrupted run's.
11. ResNet-50 served: ``resnet50(..., is_test=True)`` with two training
   steps' weights and statistics through ``save_inference_model``,
   ``AnalysisPredictor`` and ``InferenceServer``, concurrent requests,
   held against the request alone, the eager executor and the CPU
   predictor.
12. LeNet-5: Momentum steps on the card; the loss must fall.
13. causal kernel check (after phase 3): the three attention kernels
   with causal on and no Mask, as the transformer LM runs them, at its
   training shape [64, 8, 256, 64] and its served path's top bucket
   [4, 8, 256, 64], fp32 and bf16: forward (with and without its row
   statistics) and the dK/dV + dQ pair against their plain versions and
   a float64 reference, repeated bit for bit; timed beside the plain
   version, ``scaled_dot_product_attention(is_causal=True)`` and the
   same kernels without causal (which walk the same tiles).
14. dropout kernel check (after phase 13): ``csrc/dropout.cu`` against
   its plain version (the same Philox in torch's int64 ops, on the card)
   bit for bit, at the LM's FFN and attention-weight shapes and an odd
   size, fp32 and bf16, p 0.1 and 0.5, both implementations, also on an
   unaligned view; the keep rate within 5 standard deviations; timed at
   the unfused LM's three dropout sites against its bytes bound.
15. LM served: ``transformer_lm`` at its defaults (vocab 32,000,
   d_model 512, 6 layers, 8 heads, seq 256, random weights from a seed),
   fused, logits only, through ``save_inference_model``,
   ``AnalysisPredictor`` and ``InferenceServer`` (max_batch_size 4), two
   bursts of 8 concurrent requests of 1 to 4 rows; held against the
   request alone, the eager executor and the CPU predictor, 6 causal
   forward launches a dispatch.
16. LM trained, fused, fp32 (batch 64, Adam 1e-4): eager, captured and
   5 replayed steps, each launching 12 forward, 6 dK/dV and 6 dQ causal
   kernels; step time, tokens/s, peak memory, graph pool, a profiled
   replay (idle share, kernels by class) and an eager step's device time
   by op type; then two steps at batch 2 against the CPU, and 3 captured
   steps against 3 eager ones.
17. LM trained, fused, bf16 AMP: phase 16's run and CPU check.
18. LM trained, unfused, as the Transformer recipe trains it: dropout
   0.1, ``noam_decay(512, 4000)``, Adam (beta2 0.98, epsilon 1e-9),
   ``GradientClipByGlobalNorm(1.0)``, ``L2Decay(1e-4)``, bf16 AMP, batch
   64: captured, 48 dropout launches a step, the learning rate against
   noam's formula in float64, captured against eager from one state, and
   at dropout 0 its first loss against the fused build's.
19. BERT-base trained with LAMB through the reader (the LAMB paper's BERT
   recipe under bench_bert.py's AMP): phase 7's program with
   ``decorate(LambOptimizer(1e-4, lamb_weight_decay=0.01))`` and
   ``ExponentialMovingAverage(0.999).update()``, batch 32, numpy sample
   tuples through ``DataFeeder`` into ``PyReader(capacity=4,
   use_double_buffer=True)``, staged on the card on the reader's own
   stream; the eager, captured and 5 replayed steps each on a batch of its
   own, 24 / 12 / 12 bf16 attention launches a step.  Held, under
   deterministic algorithms: the losses bit for bit against the same
   batches fed as numpy dicts to a second executor; the EMA under
   ``apply()`` against its float64 recurrence, with a captured eval step
   there, and after ``restore()`` the next step bit for bit against the
   uninterrupted run (the backup must be a copy: a replay under apply
   writes the averages into the tensors the scope held); two
   ``device_buffered(steps=4)`` chunks into ``run(steps=4,
   per_step_feed=True)`` against single steps.  Measured: step time,
   tokens/s, peak memory, graph pool, the reader's stall counters, a
   profiled replay, and an eager step's device time of the ``lamb`` ops
   and the EMA's.  Then Lamb's update of three parameters against a
   float64 numpy Lamb, and two steps at batch 2 against the CPU (phase
   7's AMP limits).
20. The other optimizers: each new update op (lars_momentum, adagrad,
   decayed_adagrad, adamax, adadelta, rmsprop plain and centered, ftrl,
   lamb, dgc_momentum before and after rampup, average_accumulates across
   spills and window restarts) captured at [30522, 768] fp32 against a
   float64 numpy step, its replay timed against its bytes bound; each
   optimizer class trains LeNet-5 for 10 captured steps (loss falls);
   ModelAverage on Momentum is held as phase 19 holds the EMA.
21. On phase 19's state: ``io.save_program``, ``load_inference_model``
   into a fresh scope and its next step against the uninterrupted one,
   bit for bit; ``gradients(total, [bert_word_emb])`` against
   ``append_backward``'s gradient; ``FLAGS_check_nan_inf`` passes a clean
   replay and raises on an ``inf`` in ``input_mask``, naming the vars,
   with replays timed with the flag off and on.

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
    (32, 12, 128, 64, "bfloat16", False, "nshd"),
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
AMP_CASE = (32, 12, 128, 64, "bfloat16", False, "nshd")  # the AMP training slice's shape
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
SERVE_BURSTS = 3       # the same burst three times: the later ones meet captured buckets
SERVE_TOL = 1e-4       # served vs the same request alone (batch shapes differ)
CPU_REF_TOL = 1e-3     # card vs CPU predictor: fp32 summation order over 12 layers
TRAIN_BATCH = 32
TRAIN_MASKS = int(0.15 * BERT_BASE["seq_len"])  # masked positions per row, as bench_bert.py
TRAIN_STEPS = 5        # timed (replayed) steps, after the eager and the captured step
CHECK_BATCH = 2        # the card-vs-CPU training step
TRAIN_TOL = 1e-3       # card vs CPU step, relative: fp32 sums over 12 layers, forward and back
# AMP card vs CPU step (loss, gradients), relative to the CPU's largest
# magnitude: bf16 rounds each product's inputs and output to 8 bits of
# mantissa (2**-8 = 3.9e-3 a rounding); the loss averages such differences,
# a gradient gathers some 20 roundings a layer through 12 layers forward and
# back (a random walk of them is about 6e-2 at most), and the two devices
# sum in different orders
AMP_TOL = (5e-3, 6e-2)
AMP_SPREAD_SEEDS = 4   # more batches on which the AMP step's gradients are held to AMP_TOL
# the card's Adam update against a float64 numpy Adam over the card's own
# gradient: the parameter in units of lr (fp32 rounds the parameter to
# about 1e-7 of itself and the update to about 1e-6 of lr; a wrong update
# is off by the order of lr), the moments relative to their largest value
ADAM_TOL = 1e-2
# captured vs eager fp32 steps, relative to the largest magnitude: the same
# kernels in the same order, but index_select's and gather's backward
# (index_add_, scatter_add_) add with atomics whose order varies run to run
CAPTURE_TOL = 1e-5
CAPTURE_TIMED_STEPS = 5  # steps timed on each path after the three compared
CHECK_GRADS = ["bert_word_emb", "bert_enc_0_att_q_w", "bert_enc_11_ffn_fc1_w"]

# ResNet-50 as bench.py's run_resnet trains it: 224x224x3, 1000 classes,
# MomentumOptimizer(0.1, 0.9); AMP NHWC at bench.py's batch of 256
RESNET_HW, RESNET_CLASSES = 224, 1000
RESNET_LR, RESNET_MU = 0.1, 0.9
RESNET_AMP_BATCH = 256
RESNET_FP32_BATCH = 128  # fp32 without TF32: half bench.py's batch keeps the phase's time down
RESNET_STEPS = 5         # timed (replayed) steps, after the eager and the captured step
RESNET50_FWD_FLOPS_PER_IMG = 4.09e9  # bench.py's count; a training step is 3x the forward
BF16_DENSE_PEAK = 989e12  # H100 SXM bf16 dense, NVIDIA's data sheet
RESNET_CHECK_BATCH = 2   # the card-vs-CPU ResNet-50 steps
RESNET_CHECK_LR = 1e-3   # their learning rate (see check_resnet_against_cpu)
RESNET_CHECK_GRADS = ["conv2d_0.w_0", "conv2d_26.w_0", "fc_0.w_0"]  # first, middle, last layer
# card vs CPU ResNet-50 steps (readings on an H100 80GB HBM3 at 700 W).
# The loss relative to the CPU's: fp32 sums in other orders through 53
# conv and batch_norm layers; AMP as phase 7's bf16 rounding (read 1.1e-3
# and 8.7e-3).  The first step's
# gradient of a random ResNet-50 is ill-conditioned: nudging the images by
# 1e-6 relative moves the CPU's own gradient by 3.4% (fp32) and 116%
# (AMP: bf16 rounding flips) in relative L2, so all the gradients'
# distance is held to RESNET_YARDSTICK times that nudge's, measured on
# the same step (the card read 0.68x and 0.95x on the first step); in
# fp32 the last layer's gradient, which sits above the chaos, is also
# held to RESNET_FC_GRAD_TOL (read 4.9e-5)
RESNET_LOSS_TOL = {False: 1e-3, True: 2e-2}
RESNET_YARDSTICK = 2.0
RESNET_FC_GRAD_TOL = 1e-3
MOMENTUM_TOL = 1e-4      # the card's Momentum update vs float64 numpy, in lr (fp32 rounding)
RESNET_CAPTURE_BATCH = 32
RESNET_SERVE_ROWS = [1, 3, 16, 5, 8, 2]
RESNET_STAT_STEPS = 20   # steps at learning rate 0 that give the served model its statistics
# classes of the kernels of a ResNet-50 step, matched in order on the name
RESNET_KERNEL_CLASSES = [
    ("copies and casts", ("memcpy", "memset", "copy")),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit", "winograd",
                             "nchwtonhwc", "nhwctonchw")),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "sm80_")),
    ("reductions", ("reduce", "welford")),
    ("pooling", ("pool",)),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise",)),
]
LENET_BATCH, LENET_STEPS, LENET_LR = 64, 20, 0.01

# the causal transformer LM at transformer_lm's own defaults (the JAX
# package's models/transformer.py:233-246; Transformer-base widths)
LM = dict(vocab_size=32000, d_model=512, n_layer=6, n_head=8, d_inner=2048, max_pos=2048,
          seq_len=256)
LM_BATCH = 64            # 16,384 tokens a training step
LM_STEPS = 5             # timed (replayed) steps, after the eager and the captured step
LM_SERVE_ROWS = [1, 3, 4, 2, 4, 1, 2, 3]  # concurrent requests, rows each (32.8 MB of logits a row)
LM_SERVE_BURSTS = 2
LM_CHECK_BATCH = 2       # the card-vs-CPU LM step
LM_CHECK_GRADS = ["lm_word_emb", "lm_dec_0_att_q_w", "lm_head_w"]
LM_CAPTURE_STEPS = 3
# the Transformer recipe the unfused LM trains with (Vaswani et al. 2017, §5.3-5.4)
LM_DROPOUT = 0.1
LM_NOAM = (512, 4000)    # noam_decay(d_model, warmup_steps)
LM_ADAM = dict(beta1=0.9, beta2=0.98, epsilon=1e-9)
LM_CLIP_NORM = 1.0       # GradientClipByGlobalNorm
LM_L2 = 1e-4             # L2Decay
NOAM_TOL = 1e-6          # the fp32 learning rate against noam's formula in float64, relative
# the causal kernels at the LM's shapes: training (N = 64) and the served
# path's top bucket (N = 4); (N, H, S, D, dtype)
LM_ATTN_CASES = [(64, 8, 256, 64, "float32"), (64, 8, 256, 64, "bfloat16"),
                 (4, 8, 256, 64, "float32"), (4, 8, 256, 64, "bfloat16")]
# the dropout kernel's checks: shapes (the unfused LM's FFN hidden, its
# attention weights, and an odd size), both types, both rates
DROPOUT_SHAPES = [(64, 256, 2048), (64, 8, 256, 256), (7, 1001)]
DROPOUT_RATES = [0.1, 0.5]
# timed at the unfused AMP LM's three dropout sites: (shape, dtype)
DROPOUT_TIMED = [((64, 256, 2048), "bfloat16"), ((64, 8, 256, 256), "float32"),
                 ((64, 256, 512), "bfloat16")]
# classes of the kernels of an LM step, matched in order on the name
# (cuBLAS's runtime-built bf16 GEMMs are named nvjet_*)
LM_KERNEL_CLASSES = [
    ("attention", ("fused_attention",)),
    ("dropout", ("dropout_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("softmax", ("softmax",)),
    ("copies and casts", ("memcpy", "memset", "copy")),
    ("reductions", ("reduce", "welford")),
    ("elementwise", ("elementwise",)),
]

# BERT-base pretraining with LAMB (You et al. 2019, "Large Batch
# Optimization for Deep Learning: Training BERT in 76 minutes"), under
# bench_bert.py's bf16 AMP, fed by PyReader's double buffer, with an EMA of
# the weights
LAMB_LR, LAMB_WD = 1e-4, 0.01
EMA_DECAY = 0.999
LAMB_STEPS = 7           # eager, captured, 5 replays, each on a batch of its own
READER_CAPACITY = 4
LAMB_CHECK = ["bert_word_emb", "bert_enc_0_att_q_w", "bert_enc_0_ln1_scale"]
# the card's Lamb update against a float64 numpy Lamb over the card's own
# gradient, as ADAM_TOL: the parameter in units of lr times the trust
# ratio (the size of the step), the moments relative to their largest value
LAMB_TOL = ADAM_TOL
# the EMA under apply() against the float64 recurrence of the fetched
# parameters (the fp32 decay and 1 - decay the program holds; over the
# bias correction the scope holds), relative to the largest magnitude:
# three fp32 roundings a step over LAMB_STEPS steps; and the fp32 decay
# power against its float64 product (one rounding a step)
EMA_TOL = 1e-5
DPOW_TOL = 1e-6
CHUNK_STEPS = 4          # device_buffered(steps=4) into run(steps=4, per_step_feed=True)
# every new update op once under capture at the word embedding's shape
OPT_SHAPE = (30522, 768)
# an op's captured step against float64 numpy over the same fp32 inputs,
# relative to the largest magnitude of each output (fp32 rounds each of a
# few operations to 6e-8; Lars' and Lamb's norms sum 23.4M squares)
OPT_TOL = 1e-5
# a parameter in units of its largest move: fp32 rounds a parameter of
# magnitude 5 to 3e-7, 6e-6 of a move of 0.05 (lr 0.05)
OPT_PARAM_TOL = 1e-4
OPT_TIMED_REPLAYS = 10
# each optimizer class trains LeNet-5 (LENET_BATCH) for OPT_LENET_STEPS
# captured steps after its eager one; learning rates that move LeNet
# within those steps (Lars scales its step by lars_coeff * |p| / |g|)
OPT_LENET_STEPS = 10
OPT_LENET = {
    "lars": lambda O: O.LarsMomentumOptimizer(0.2, 0.9, lars_coeff=0.01),
    "adagrad": lambda O: O.AdagradOptimizer(1e-3),
    "decayed_adagrad": lambda O: O.DecayedAdagradOptimizer(3e-4),
    "adamax": lambda O: O.AdamaxOptimizer(3e-4),
    "adadelta": lambda O: O.AdadeltaOptimizer(1.0, epsilon=1e-8),
    "rmsprop": lambda O: O.RMSPropOptimizer(1e-4),
    "rmsprop_centered": lambda O: O.RMSPropOptimizer(1e-4, momentum=0.9, centered=True),
    "ftrl": lambda O: O.FtrlOptimizer(1e-3),
    "dgc": lambda O: O.DGCMomentumOptimizer(0.01, 0.9, rampup_begin_step=3),
    "lamb": lambda O: O.LambOptimizer(0.01),
}


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


def _attn_bound(case, stats=False):
    n, h, s, d, dtype, _, _ = case
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * n * h * s * d * item + n * s * 4   # Q, K, V read, Out written, Mask read
    if stats:
        nbytes += 2 * n * h * s * 4                 # row max and log row sum written (fp32)
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
            if case in (TRAIN_CASE, AMP_CASE):  # the grad ops run it with the row statistics
                row["ms_with_stats"] = _time_ms(torch, lambda: fa.fused_attention_fwd(
                    q, k, v, mask, causal, scale, return_stats=True))
                row["bound_ms_with_stats"] = _attn_bound(case, stats=True)[0]
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


def _serve_bursts(client, feeds, n):
    """``n`` bursts of one concurrent ``client.infer`` a feed, each on a
    thread of its own: each burst's (answers, latencies, wall seconds).
    Raises if a request failed or did not return."""
    bursts, errors, threads = [], [], []
    for _ in range(n):
        answers, lat = [None] * len(feeds), [None] * len(feeds)

        def one(i, answers=answers, lat=lat):
            t = time.perf_counter()
            try:
                answers[i] = client.infer(feeds[i])
            except Exception as e:  # noqa: BLE001 — reported and failed below
                errors.append((i, repr(e)))
            lat[i] = time.perf_counter() - t

        burst = [threading.Thread(target=one, args=(i,)) for i in range(len(feeds))]
        threads += burst
        t0 = time.perf_counter()
        for t in burst:
            t.start()
        for t in burst:
            t.join(120)
        bursts.append((answers, lat, time.perf_counter() - t0))
    if (errors or any(a is None for answers, _, _ in bursts for a in answers)
            or any(t.is_alive() for t in threads)):
        raise AssertionError("requests failed: %s" % errors)
    return bursts


def _burst_stats(bursts, rows):
    return [{"wall_s": wall, "rows_per_s": rows / wall,
             "latency_ms_p50": 1e3 * statistics.median(lat),
             "latency_ms_max": 1e3 * max(lat)} for _, lat, wall in bursts]


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
    # one entry a rung, each run once (eagerly, on this thread); a bucket's
    # graph is captured at its second served batch on the server's worker
    stats["cache_after_warmup"] = pred.jit_cache_stats()

    rng = np.random.RandomState(SEED)
    feeds = [_feed(rng, r, seq, BERT_BASE["vocab_size"]) for r in SERVE_ROWS]
    try:
        bursts = _serve_bursts(serving.Client(server), feeds, SERVE_BURSTS)
    finally:
        server.stop(drain=True, timeout=60)
    counts = kernels.launch_counts()  # read right after the main path
    m = server.metrics()
    stats["cache_after_traffic"] = pred.jit_cache_stats()
    if stats["cache_after_traffic"]["misses"] != stats["cache_after_warmup"]["misses"]:
        raise AssertionError("served traffic built new entries after the warm-up: %s"
                             % stats["cache_after_traffic"])

    dispatches = m["batches"] + m["warmup_runs"]
    launches = counts.get(KERNEL_NAME, 0)
    # each burst's numbers; the first holds the buckets' eager runs on the
    # worker and their captures, the last is the steady state
    stats["bursts"] = _burst_stats(bursts, sum(SERVE_ROWS))
    stats.update(dispatches=dispatches, batches=m["batches"], warmup_runs=m["warmup_runs"],
                 launches=launches, rows=sum(SERVE_ROWS) * SERVE_BURSTS)
    if launches != BERT_BASE["n_layer"] * dispatches or launches == 0:
        raise AssertionError(
            "%s launched %d times over %d dispatches (expected %d per dispatch)"
            % (KERNEL_NAME, launches, dispatches, BERT_BASE["n_layer"]))

    worst = 0.0
    for f, (out,) in [(f, a) for answers, _, _ in bursts for f, a in zip(feeds, answers)]:
        rows = f["src_ids"].shape[0]
        if out.shape != (rows, seq, BERT_BASE["d_model"]) or not np.isfinite(out).all():
            raise AssertionError("bad served output: shape %s" % (out.shape,))
        alone, = pred.run(f)
        worst = max(worst, float(np.abs(out - alone).max()))
    stats["served_vs_alone_max_abs"] = worst
    if not worst <= SERVE_TOL:
        raise AssertionError("served answers differ from the request alone by %g" % worst)

    # unchanged under capture: each request alone through the captured
    # predictor (by its entry's third run, a replay) against the eager
    # interpreter (use_program_cache=False) on the same saved model
    eager_exe, eager_scope = fluid.Executor(), fluid.Scope()
    prog, feed_names, fetch_vars = fluid.io.load_inference_model(model_dir, eager_exe,
                                                                 scope=eager_scope)
    worst_eager, bit_equal = 0.0, True
    for f in feeds:
        pred.run(f)
        replayed, = pred.run(f)
        eager, = eager_exe.run(prog, feed=f, fetch_list=fetch_vars, scope=eager_scope,
                               use_program_cache=False)
        worst_eager = max(worst_eager, float(np.abs(replayed - eager).max()))
        bit_equal = bit_equal and bool(np.array_equal(replayed, eager))
    stats["captured_vs_eager_max_abs"] = worst_eager
    stats["captured_vs_eager_bit_equal"] = bit_equal
    stats["cache_after_checks"] = pred.jit_cache_stats()
    if not worst_eager <= SERVE_TOL:
        raise AssertionError("captured predictor differs from the eager one by %g" % worst_eager)

    cpu_cfg = fluid.inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    cpu_pred = fluid.inference.create_paddle_predictor(cpu_cfg)
    ref, = cpu_pred.run(feeds[1])
    cpu_err = float(np.abs(bursts[-1][0][1][0] - ref).max())
    stats["card_vs_cpu_max_abs"] = cpu_err
    if not cpu_err <= CPU_REF_TOL:
        raise AssertionError("card and CPU predictors differ by %g" % cpu_err)
    log("[slice]", json.dumps(stats))
    return stats


# ---------------------------------------------------------------------------
# phase 5: the training slice at full width
# ---------------------------------------------------------------------------
PRETRAIN_FEEDS = (("src_ids", "int64"), ("sent_ids", "int64"), ("input_mask", "float32"),
                  ("mask_pos", "int64"), ("mask_label", "int64"), ("nsp_label", "int64"))


def pretrain_program(fluid, transformer, amp=False, lamb=False):
    """(main, startup, [total, mlm_loss, nsp_acc], params_grads, ema) of
    fused BERT-base pretraining with Adam; with ``amp``, under
    ``contrib.mixed_precision.decorate`` (bf16 AMP), as bench_bert.py
    builds it.  With ``lamb``: LambOptimizer(LAMB_LR, LAMB_WD) and an
    ExponentialMovingAverage(EMA_DECAY) of the weights (``ema``, else
    None), the LAMB paper's BERT recipe."""
    from paddle_tpu_torch.contrib import mixed_precision

    s = BERT_BASE["seq_len"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    ema = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ins = [fluid.layers.data(name, [1 if name in ("mask_pos", "mask_label", "nsp_label") else s],
                                 dtype=dt) for name, dt in PRETRAIN_FEEDS]
        outs = transformer.bert_pretrain(*ins, dropout_rate=0.0, fused_attention=True, **BERT_BASE)
        if lamb:
            opt = fluid.optimizer.LambOptimizer(learning_rate=LAMB_LR, lamb_weight_decay=LAMB_WD)
        else:
            opt = fluid.optimizer.AdamOptimizer(1e-4)
        if amp:
            opt = mixed_precision.decorate(opt)
        _, params_grads = opt.minimize(outs[0])
        if lamb:
            ema = fluid.optimizer.ExponentialMovingAverage(EMA_DECAY)
            ema.update()
    return main, startup, list(outs), params_grads, ema


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


def _profile_step(torch, step, all_kernels=False):
    """One step under torch.profiler: its wall time, the device time of its
    kernels and the card's idle share, the host's own time in ops, the
    attention kernels' device time and share, and the top kernels and host
    ops (with ``all_kernels``, every kernel too); None when the profiler
    reports no device time.  The profiler's own cost lengthens the host
    side of this step."""
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
    out = {"step_ms": wall_ms, "device_ms": device_ms, "device_idle_share": 1 - device_ms / wall_ms,
           "host_self_ms": sum(r[1] for r in host_ops),
           "launches": sum(r[2] for r in kernels_),
           "attention_kernels": attention,
           "attention_share_of_device": sum(r["ms"] for r in attention) / device_ms,
           "top_kernels": [{"name": k[:90], "ms": t, "calls": c} for k, t, c in kernels_[:12]],
           "top_host_ops": [{"name": k[:60], "ms": t, "calls": c} for k, t, c in host_ops[:12]]}
    if all_kernels:
        out["all_kernels"] = [{"name": k, "ms": t, "calls": c} for k, t, c in kernels_]
    return out


class _deterministic:
    """``torch.use_deterministic_algorithms`` (warnings only where an op has
    no deterministic kernel, as cuBLAS' workspace check) and cuDNN's
    deterministic algorithms, for a block whose runs are compared bit for
    bit: the embedding's and gather's backward (index_add_, scatter_add_)
    and cuDNN's weight gradients otherwise add with atomics."""

    def __init__(self, torch):
        self.torch = torch

    def __enter__(self):
        self.cudnn = self.torch.backends.cudnn.deterministic
        self.torch.backends.cudnn.deterministic = True
        self.torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        self.torch.use_deterministic_algorithms(False)
        self.torch.backends.cudnn.deterministic = self.cudnn


def _free_device_memory(torch):
    """Release what earlier phases left to the collector, so each phase's
    peak memory is its own."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def run_train(torch, amp=False):
    """The training slice through the cached executor: the entry's first
    step runs eagerly, its second is captured into a CUDA graph and
    replayed, and TRAIN_STEPS replays are timed.  Every step must launch
    24 forward, 12 dK/dV and 12 dQ attention kernels, in fp32 or (with
    ``amp``) bf16, and the loss must fall."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import fused_attention as fa
    from paddle_tpu_torch.models import transformer

    sync = torch.cuda.synchronize
    batch, n_layer = TRAIN_BATCH, BERT_BASE["n_layer"]
    names = (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME)
    per_step = {fa.KERNEL_NAME: 2 * n_layer, fa.BWD_DKV_NAME: n_layer, fa.BWD_DQ_NAME: n_layer}
    kernel_dtype = "bfloat16" if amp else "float32"
    stats = {"amp": amp, "batch": batch, "seq_len": BERT_BASE["seq_len"],
             "masks_per_row": TRAIN_MASKS,
             "allocated_before_bytes": _free_device_memory(torch)}
    t0 = time.perf_counter()
    main, startup, outs, params_grads, _ = pretrain_program(fluid, transformer, amp)
    stats["build_s"] = time.perf_counter() - t0
    stats["ops"] = len(main.global_block().ops)
    stats["casts"] = sum(op.type == "cast" for op in main.global_block().ops)
    exe = fluid.Executor()  # cuda:0
    scope = fluid.Scope()
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
    for _ in range(2 + TRAIN_STEPS):  # eager, captured and replayed, then replays
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
    by_dtype = kernels.launch_counts_by_dtype()
    stats["launches"] = {k: counts.get(k, 0) for k in names}
    stats["launches_by_dtype"] = {k: by_dtype.get(k, {}) for k in names}
    stats["launches_per_step"] = deltas
    stats["losses"] = losses
    stats["step_s"] = times
    stats["eager_first_step_ms"], stats["capture_step_ms"] = 1e3 * times[0], 1e3 * times[1]
    step_s = statistics.median(times[2:])
    stats["step_ms_median"] = 1e3 * step_s
    stats["tokens_per_s"] = batch * BERT_BASE["seq_len"] / step_s
    stats["real_tokens_per_s"] = stats["real_tokens"] / step_s
    stats["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    stats["cache"] = exe.jit_cache_stats()
    bad = [i for i, d in enumerate(deltas) if d != per_step]
    if bad:
        raise AssertionError("step(s) %s launched %s, expected %s per step"
                             % (bad, [deltas[i] for i in bad], per_step))
    if any(set(by_dtype.get(k, {})) != {kernel_dtype} for k in names):
        raise AssertionError("attention launches by type %s, expected %s only"
                             % (by_dtype, kernel_dtype))
    if stats["cache"]["graphs"] != 1:
        raise AssertionError("the training step was not captured: %s" % stats["cache"])
    if not all(np.isfinite([l["total"], l["mlm"]]).all() for l in losses):
        raise AssertionError("non-finite loss: %s" % losses)
    if not losses[-1]["total"] < losses[1]["total"]:
        raise AssertionError("loss did not fall over the timed steps: %s" % losses)

    # what the step costs without its backward: the forward alone, which is
    # also what the generic vjp grad ops recompute (captured too)
    test_prog = main.clone(for_test=True)
    fwd_times = []
    for _ in range(2 + TRAIN_STEPS):
        sync()
        t = time.perf_counter()
        exe.run(test_prog, feed=feed, fetch_list=[outs[0].name], scope=scope)
        sync()
        fwd_times.append(time.perf_counter() - t)
    stats["forward_only_ms_median"] = 1e3 * statistics.median(fwd_times[2:])
    try:
        stats["profile"] = _profile_step(torch, step)
    except RuntimeError as e:  # the profiler's own failure: the numbers are then not measured
        stats["profile"] = "not measured (%s)" % e
    exe.close()
    log("[train-amp]" if amp else "[train]", json.dumps(stats))
    return stats


def _clone_state(scope):
    return {n: v.clone() for n, v in scope.vars.items()}


def _load_state(scope, state):
    """Put copies of ``state`` into ``scope`` (new tensors: a captured
    entry copies them into its buffers before its next replay)."""
    for n, v in state.items():
        scope.vars[n] = v.clone()


def _max_rel(a, b):
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def run_capture_check(torch):
    """The fp32 training slice captured against eager, from the same
    initial state: three steps each (the cached executor's captured and
    replayed steps, its entry warmed first on a scope of its own, against
    ``use_program_cache=False``), the first loss bit for bit, the losses
    and the CHECK_GRADS parameters after three steps within CAPTURE_TOL;
    then ``steps=3, per_step_feed=True`` against three single captured
    runs from one state; and each path's step time, unprofiled."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer

    sync = torch.cuda.synchronize
    _free_device_memory(torch)
    main, startup, outs, _, _ = pretrain_program(fluid, transformer)
    boot_exe, boot = fluid.Executor(), fluid.Scope()
    boot_exe.run(startup, scope=boot)
    init = _clone_state(boot)
    rng = np.random.RandomState(SEED + 3)
    feeds = [pretrain_feed(rng, TRAIN_BATCH) for _ in range(3)]
    paths = {}
    for name, cached in (("eager", False), ("captured", True)):
        exe, scope = fluid.Executor(), fluid.Scope()
        if cached:  # the entry's eager warm-up, on a scope of its own
            warm = fluid.Scope()
            _load_state(warm, init)
            exe.run(main, feed=feeds[0], fetch_list=[outs[0]], scope=warm)
            del warm
        _load_state(scope, init)
        losses, times = [], []
        for i in range(3 + CAPTURE_TIMED_STEPS):
            sync()
            t = time.perf_counter()
            total, = exe.run(main, feed=feeds[i % 3], fetch_list=[outs[0]], scope=scope,
                             use_program_cache=cached)
            sync()
            times.append(time.perf_counter() - t)
            losses.append(float(total))
            if i == 2:
                params = {n: scope.vars[n].cpu().numpy() for n in CHECK_GRADS}
        paths[name] = {"exe": exe, "scope": scope, "losses": losses, "params": params,
                       "step_s": times, "step_ms_median": 1e3 * statistics.median(times[3:])}
    eager, cap = paths["eager"], paths["captured"]
    stats = {
        "batch": TRAIN_BATCH,
        "losses": {"eager": eager["losses"], "captured": cap["losses"]},
        "first_loss_bit_equal": eager["losses"][0] == cap["losses"][0],
        "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(cap["losses"][:3],
                                                                  eager["losses"][:3])),
        "param_rel_err": {n: _max_rel(cap["params"][n], eager["params"][n]) for n in CHECK_GRADS},
        "eager_step_ms_median": eager["step_ms_median"],
        "captured_step_ms_median": cap["step_ms_median"],
        "eager_step_s": eager["step_s"], "captured_step_s": cap["step_s"],
        "cache": {"eager": eager["exe"].jit_cache_stats(), "captured": cap["exe"].jit_cache_stats()},
    }

    # steps=3 with a feed a step, against three single captured runs, from one state
    state = _clone_state(cap["scope"])
    singles = []
    for f in feeds:
        singles.append(float(cap["exe"].run(main, feed=f, fetch_list=[outs[0]],
                                            scope=cap["scope"])[0]))
    single_params = {n: cap["scope"].vars[n].cpu().numpy() for n in CHECK_GRADS}
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    multi_exe, multi_scope = fluid.Executor(), fluid.Scope()
    for _ in range(2):  # the entry's eager warm-up, then its captured run
        _load_state(multi_scope, state)
        last, = multi_exe.run(main, feed=stacked, fetch_list=[outs[0]], scope=multi_scope,
                              steps=3, per_step_feed=True)
    stats["steps3"] = {
        "singles": singles, "last": float(last),
        "loss_rel_err": abs(float(last) - singles[-1]) / abs(singles[-1]),
        "param_rel_err": {n: _max_rel(multi_scope.vars[n].cpu().numpy(), single_params[n])
                          for n in CHECK_GRADS},
        "cache": multi_exe.jit_cache_stats(),
    }
    for exe in (eager["exe"], cap["exe"], multi_exe):
        exe.close()
    log("[capture-check]", json.dumps(stats))
    errs = ([stats["loss_rel_err"], stats["steps3"]["loss_rel_err"]]
            + list(stats["param_rel_err"].values()) + list(stats["steps3"]["param_rel_err"].values()))
    if not (stats["first_loss_bit_equal"] and max(errs) <= CAPTURE_TOL
            and all(np.isfinite(cap["losses"]))
            and stats["cache"]["captured"]["graphs"] == 1 == stats["steps3"]["cache"]["graphs"]
            and stats["cache"]["eager"]["entries"] == 0):
        raise AssertionError("captured and eager training steps differ: %s" % stats)
    return stats


def _update_ops(main, params):
    """{param: the adam or lamb op that updates it} for ``params``."""
    return {op.input("Param")[0]: op for op in main.global_block().ops
            if op.type in ("adam", "lamb") and op.input("Param")[0] in params}


def _adam_state(scope, ops):
    """Host copies of what the adam (or lamb) ops read: parameters,
    moments, beta powers and learning rates."""
    from paddle_tpu_torch.scope import to_numpy

    names = {n for op in ops.values()
             for slot in ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")
             for n in op.input(slot)}
    return {n: to_numpy(scope.vars[n]).astype(np.float64) for n in names}


def _adam_errors(ops, before, after, grads):
    """For each parameter: how far the card's Adam or Lamb update
    (``before`` -> ``after``) lies from a float64 numpy one over the card's
    own gradient.  Adam (paddle's adam_op.h): moments first, then p -= lr
    * sqrt(1 - beta2^t) / (1 - beta1^t) * m / (sqrt(v) + eps).  Lamb (You
    et al. 2019, the JAX package's lamb op): r = m_hat / (sqrt(v_hat) +
    eps) + wd * p, p -= lr * ratio * r with the trust ratio |p| / |r| over
    the whole parameter (1 where a norm is 0).  The parameter's error is
    in units of the step's learning rate (times Lamb's trust ratio, the
    size of its step), the moments' relative to their largest magnitude."""
    errs = {}
    for p, op in ops.items():
        one = {slot: before[op.input(slot)[0]] for slot in
               ("Param", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow", "LearningRate")}
        b1, b2 = op.attr("beta1", 0.9), op.attr("beta2", 0.999)
        eps = op.attr("epsilon", 1e-6 if op.type == "lamb" else 1e-8)
        g = grads[p].astype(np.float64).reshape(one["Param"].shape)
        lr = float(one["LearningRate"].reshape(()))
        b1p, b2p = one["Beta1Pow"].reshape(()), one["Beta2Pow"].reshape(())
        m = b1 * one["Moment1"] + (1 - b1) * g
        v = b2 * one["Moment2"] + (1 - b2) * g * g
        if op.type == "lamb":
            r = (m / (1 - b1p)) / (np.sqrt(v / (1 - b2p)) + eps) + op.attr("weight_decay") * one["Param"]
            pn, rn = np.sqrt(np.sum(one["Param"] ** 2)), np.sqrt(np.sum(r * r))
            ratio = pn / rn if pn > 0 and rn > 0 else 1.0
            ref, unit = one["Param"] - lr * ratio * r, lr * ratio
        else:
            ratio = None
            ref, unit = one["Param"] - lr * np.sqrt(1 - b2p) / (1 - b1p) * m / (np.sqrt(v) + eps), lr
        errs[p] = {"param_in_lr": float(np.abs(after[p] - ref).max() / unit),
                   "moment1": _max_rel(after[op.input("Moment1")[0]], m),
                   "moment2": _max_rel(after[op.input("Moment2")[0]], v)}
        if ratio is not None:
            errs[p]["trust_ratio"] = float(ratio)
    return errs


def check_train_against_cpu(amp=False, lamb=False):
    """Two steps at CHECK_BATCH from the same state on the card and on
    the CPU.  With ``lamb`` the program is phase 19's (Lamb and the EMA,
    AMP) with no spread batches, and the float64 check is of Lamb's
    update of LAMB_CHECK (its gradients beyond CHECK_GRADS are fetched and
    reported against the CPU's, not held: a layer_norm scale's gradient
    sums bf16-rounded products over every token).  On the card the entry
    is first warmed on a scope of its own, so both compared steps run the
    captured graph (its capture, then a replay).  Checked: the first step's loss and gradients of CHECK_GRADS
    against the CPU's, within TRAIN_TOL (AMP_TOL with ``amp``) relative to
    the CPU's largest magnitude; the second step's loss against the CPU's;
    and each step's Adam update of CHECK_GRADS (parameters and moments)
    against a float64 numpy Adam over the card's own gradients, within
    ADAM_TOL.  In fp32 each device's second step starts from its own Adam
    update.  With ``amp`` the CPU's starts from the card's updated state:
    Adam's first update is lr times about the sign of each gradient
    element, so an element whose gradient is within bf16 rounding of zero
    moves lr one way on one device and lr the other way on the other, and
    at random weights one update moves the loss by a third; a loss after
    two different updates would measure that, not the second step (the
    update itself is held to the numpy Adam instead).  With ``amp`` the
    first step's check is then repeated from the initial state on
    AMP_SPREAD_SEEDS more batches, each held to AMP_TOL, for the spread of
    the bf16 gradient error."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.scope import to_numpy

    upd = LAMB_CHECK if lamb else CHECK_GRADS  # the updates held to float64
    names = CHECK_GRADS + [n for n in upd if n not in CHECK_GRADS]  # the gradients fetched
    main, startup, outs, params_grads, _ = pretrain_program(fluid, transformer, amp, lamb)
    grads = {p.name: g.name for p, g in params_grads}
    fetch = [outs[0].name] + [grads[n] for n in names]
    ops = _update_ops(main, upd)
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    init = {n: to_numpy(v) for n, v in card_scope.vars.items()}
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    fluid.io.set_params_from_numpy(cpu_scope, init, "cpu")
    feed = pretrain_feed(np.random.RandomState(SEED + 2), CHECK_BATCH)
    warm = fluid.Scope()  # the entry's eager warm-up, on a scope of its own
    _load_state(warm, card_scope.vars)
    card_exe.run(main, feed=feed, fetch_list=fetch, scope=warm)
    del warm
    s0 = _adam_state(card_scope, ops)
    t0 = time.perf_counter()
    card = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)  # captured
    t1 = time.perf_counter()
    cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    t2 = time.perf_counter()
    s1 = _adam_state(card_scope, ops)
    # a second step, the same fetches: on the card a replay
    if amp:
        fluid.io.set_params_from_numpy(
            cpu_scope, {n: to_numpy(v) for n, v in card_scope.vars.items()}, "cpu")
    card2 = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    cpu2 = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    s2 = _adam_state(card_scope, ops)
    loss_tol, grad_tol = AMP_TOL if amp else (TRAIN_TOL, TRAIN_TOL)
    stats = {"amp": amp, "lamb": lamb, "batch": CHECK_BATCH, "card_s": t1 - t0, "cpu_s": t2 - t1,
             "loss_card": [float(card[0]), float(card2[0])],
             "loss_cpu": [float(cpu[0]), float(cpu2[0])], "tol": [loss_tol, grad_tol],
             "adam_tol": ADAM_TOL, "rel_err": {},
             "adam_err": {"step1": _adam_errors(ops, s0, s1, dict(zip(names, card[1:]))),
                          "step2": _adam_errors(ops, s1, s2, dict(zip(names, card2[1:])))},
             "card_cache": card_exe.jit_cache_stats()}
    ok = stats["card_cache"]["graphs"] == 1
    for name, a, b in zip(["total", "total_step2"] + names,
                          [card[0], card2[0]] + card[1:], [cpu[0], cpu2[0]] + cpu[1:]):
        rel = _max_rel(a, b)
        stats["rel_err"][name] = rel
        ok = ok and bool(np.isfinite(a).all()) and (name not in CHECK_GRADS + ["total", "total_step2"]
                                                    or rel <= (grad_tol if name in CHECK_GRADS
                                                               else loss_tol))
    ok = ok and all(e["param_in_lr"] <= ADAM_TOL and e["moment1"] <= ADAM_TOL
                    and e["moment2"] <= ADAM_TOL
                    for step in stats["adam_err"].values() for e in step.values())
    if amp and not lamb:  # the first step from the initial state on more batches: the spread
        spread = []
        for k in range(1, 1 + AMP_SPREAD_SEEDS):
            f = pretrain_feed(np.random.RandomState(SEED + 2 + k), CHECK_BATCH)
            fluid.io.set_params_from_numpy(card_scope, init, card_scope.device)
            fluid.io.set_params_from_numpy(cpu_scope, init, "cpu")
            a = card_exe.run(main, feed=f, fetch_list=fetch, scope=card_scope)  # a replay
            b = cpu_exe.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
            spread.append({name: _max_rel(x, y)
                           for name, x, y in zip(["total"] + names, a, b)})
        stats["spread"] = spread
        ok = ok and all(r["total"] <= loss_tol and max(r[n] for n in names) <= grad_tol
                        for r in spread)
        stats["grad_rel_err_max_over_batches"] = max(
            [stats["rel_err"][n] for n in names] + [r[n] for r in spread for n in names])
    card_exe.close()
    log("[train-check-lamb]" if lamb else "[train-check-amp]" if amp else "[train-check]",
        json.dumps(stats))
    if not ok:
        raise AssertionError("card and CPU training steps differ: %s" % stats)
    return stats

# ---------------------------------------------------------------------------
# phases 8 to 13: the LeNet / ResNet slice at full width
# ---------------------------------------------------------------------------
def resnet_program(fluid, fmt, amp=False, is_test=False):
    """(main, startup, avg_loss, prediction, params_grads) of ResNet-50 at
    224x224, 1000 classes, under ``MomentumOptimizer(0.1, 0.9)`` (with
    ``amp``, ``decorate``d: bf16 AMP), as bench.py's run_resnet builds it;
    no optimizer with ``is_test``."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.contrib import mixed_precision

    hw = RESNET_HW
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, hw, hw] if fmt == "NCHW" else [hw, hw, 3])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, _, pred = models.resnet50(img, lbl, class_num=RESNET_CLASSES, is_test=is_test,
                                        data_format=fmt)
        params_grads = None
        if not is_test:
            opt = fluid.optimizer.MomentumOptimizer(learning_rate=RESNET_LR, momentum=RESNET_MU)
            if amp:
                opt = mixed_precision.decorate(opt)
            _, params_grads = opt.minimize(loss)
    return main, startup, loss, pred, params_grads


def resnet_feed(torch, rng, rows, fmt, device=None):
    """Images uniform in [-1, 1) and labels, as bench.py makes them; with
    ``device``, staged there (bench.py stages its batches on the device:
    the measurement is of the card, not of the host's copy)."""
    hw = RESNET_HW
    shape = (rows, 3, hw, hw) if fmt == "NCHW" else (rows, hw, hw, 3)
    feed = {"img": rng.uniform(-1, 1, shape).astype(np.float32),
            "lbl": rng.randint(0, RESNET_CLASSES, (rows, 1)).astype(np.int64)}
    if device is not None:
        feed = {n: torch.from_numpy(v).to(device) for n, v in feed.items()}
    return feed


def _kernel_class(name, classes=None):
    """The class of a kernel (or copy) on the card, from its name."""
    low = name.lower()
    for cls, keys in classes or RESNET_KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _op_breakdown(torch, step):
    """Device ms of one eager step by op type, from CUDA events recorded on
    the stream around each op kernel: each ``<type>_grad`` op's own time
    (its autograd backward, which runs on autograd's thread but on the
    same stream) apart from the forward it runs again inside it (the
    generic vjp's recompute).  A spin kernel queued first lets the host
    enqueue ahead of the card, so the events bracket device work rather
    than the host's gaps."""
    from paddle_tpu_torch.core import registry

    in_grad = [False]  # a grad op's recompute runs on this thread, inside the grad op
    saved, marks = {}, []

    def wrap(name, kernel):
        grad = name.endswith("_grad")

        def wrapped(inputs, attrs, device):
            kind = "grad" if grad else "recompute" if in_grad[0] else "op"
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            in_grad[0] = in_grad[0] or grad
            try:
                return kernel(inputs, attrs, device)
            finally:
                if grad:
                    in_grad[0] = False
                b.record()
                marks.append((kind, name[:-len("_grad")] if grad else name, a, b))
        return wrapped

    for name, opdef in list(registry._REGISTRY.items()):
        if opdef.kernel is not None:
            saved[name] = opdef.kernel
            opdef.kernel = wrap(name, opdef.kernel)
    try:
        torch.cuda.synchronize()
        torch.cuda._sleep(1 << 32)  # about two seconds: the host enqueues the step meanwhile
        step()
        torch.cuda.synchronize()
    finally:
        for name, kernel in saved.items():
            registry._REGISTRY[name].kernel = kernel
    by_type = {}
    for kind, name, a, b in marks:
        row = by_type.setdefault(name, {"forward_ms": 0.0, "grad_ms": 0.0, "recompute_ms": 0.0,
                                        "ops": 0, "grad_ops": 0})
        ms = a.elapsed_time(b)
        if kind == "op":
            row["forward_ms"] += ms
            row["ops"] += 1
        elif kind == "recompute":
            row["recompute_ms"] += ms
        else:
            row["grad_ms"] += ms
            row["grad_ops"] += 1
    for row in by_type.values():
        row["grad_own_ms"] = row["grad_ms"] - row["recompute_ms"]  # the grad op less its recompute
    total = sum(r["forward_ms"] + r["grad_ms"] for r in by_type.values())
    return {"device_ms_in_ops": total,
            "recompute_ms": sum(r["recompute_ms"] for r in by_type.values()),
            "by_type": dict(sorted(by_type.items(),
                                   key=lambda kv: -(kv[1]["forward_ms"] + kv[1]["grad_ms"])))}


def _kernel_classes(prof_stats, classes=None):
    """The profiled replay's kernels summed by class, with each class's
    largest kernels by name."""
    out = {}
    for k in prof_stats.get("all_kernels", []):  # largest first
        row = out.setdefault(_kernel_class(k["name"], classes),
                             {"ms": 0.0, "calls": 0, "largest": []})
        row["ms"] += k["ms"]
        row["calls"] += k["calls"]
        if len(row["largest"]) < 4:
            row["largest"].append({"name": k["name"][:100], "ms": k["ms"], "calls": k["calls"]})
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def run_resnet_train(torch, amp):
    """ResNet-50 training as bench.py runs it (AMP: NHWC, batch
    RESNET_AMP_BATCH) or in fp32 (NCHW, batch RESNET_FP32_BATCH), through
    the cached executor: the card's startup, the entry's eager step, its
    captured step, then RESNET_STEPS timed replays; one replay profiled
    (idle share, kernels by class), then a warm eager step timed and one
    more eager step's device time taken by op type (``_op_breakdown``).
    Every loss must be finite, the step captured, and no attention kernel
    launched (the path runs none)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    sync = torch.cuda.synchronize
    fmt, batch = ("NHWC", RESNET_AMP_BATCH) if amp else ("NCHW", RESNET_FP32_BATCH)
    stats = {"amp": amp, "layout": fmt, "batch": batch, "image": RESNET_HW,
             "classes": RESNET_CLASSES, "allocated_before_bytes": _free_device_memory(torch)}
    t0 = time.perf_counter()
    main, startup, loss, _, _ = resnet_program(fluid, fmt, amp)
    stats["build_s"] = time.perf_counter() - t0
    ops = [op.type for op in main.global_block().ops]
    stats["ops"] = len(ops)
    stats["op_types"] = {t: ops.count(t) for t in sorted(set(ops))}
    exe, scope = fluid.Executor(), fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    sync()
    stats["startup_s"] = time.perf_counter() - t0
    feed = resnet_feed(torch, np.random.RandomState(SEED), batch, fmt, device="cuda")

    def step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope)

    kernels.reset_launch_counts()  # counts from here on belong to the ResNet path
    losses, times = [], []
    for _ in range(2 + RESNET_STEPS):  # eager, captured and replayed, then replays
        sync()
        t = time.perf_counter()
        l, = step()
        sync()
        times.append(time.perf_counter() - t)
        losses.append(float(l))
    stats["launches"] = kernels.launch_counts()  # read right after the ResNet path
    stats["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    stats["cache"] = exe.jit_cache_stats()
    stats["losses"] = losses
    stats["step_s"] = times
    stats["eager_first_step_ms"], stats["capture_step_ms"] = 1e3 * times[0], 1e3 * times[1]
    step_s = statistics.median(times[2:])
    stats["step_ms_median"] = 1e3 * step_s
    stats["images_per_s"] = batch / step_s
    flops = 3 * RESNET50_FWD_FLOPS_PER_IMG * batch  # bench.py's reckoning of a step
    stats["tflop_per_s"] = flops / step_s / 1e12
    stats["share_of_bf16_dense_peak"] = flops / step_s / BF16_DENSE_PEAK
    prof = _profile_step(torch, step, all_kernels=True)
    if prof is not None:
        prof["kernel_classes"] = _kernel_classes(prof)
        del prof["all_kernels"]
    stats["profile"] = prof
    exe.close()  # release the graph and its pool before the eager steps

    def eager_step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope, use_program_cache=False)

    sync()
    t = time.perf_counter()
    eager_step()
    sync()
    stats["eager_step_ms"] = 1e3 * (time.perf_counter() - t)  # the interpreter, warm
    stats["eager_op_breakdown"] = _op_breakdown(torch, eager_step)
    log("[resnet-amp]" if amp else "[resnet]", json.dumps(stats))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite ResNet-50 loss: %s" % losses)
    if stats["cache"]["graphs"] != 1:
        raise AssertionError("the ResNet-50 step was not captured: %s" % stats["cache"])
    if stats["launches"]:
        raise AssertionError("the ResNet-50 path launched attention kernels: %s"
                             % stats["launches"])
    return stats


def _lr_name(main):
    """The learning-rate var the program's Momentum ops read."""
    return next(op.input("LearningRate")[0] for op in main.global_block().ops
                if op.type == "momentum")


def _global_rel(a, b):
    """Relative L2 distance of two lists of arrays taken as one vector (0
    when both are zero)."""
    num = sum(float(np.sum((np.asarray(x, np.float64) - y) ** 2)) for x, y in zip(a, b))
    den = sum(float(np.sum(np.asarray(y, np.float64) ** 2)) for y in b)
    return float(np.sqrt(num / den)) if den else (0.0 if num == 0 else float("inf"))


def _momentum_errors(main, names, before, after, grads):
    """For each parameter in ``names``: how far the card's Momentum update
    lies from a float64 numpy one (v = mu v + g; p -= lr v) over the
    card's own gradient; the parameter in units of lr, the velocity
    relative to its largest magnitude."""
    ops = {op.input("Param")[0]: op for op in main.global_block().ops if op.type == "momentum"}
    errs = {}
    for p in names:
        op = ops[p]
        v0 = before[op.input("Velocity")[0]]
        lr = float(before[op.input("LearningRate")[0]].reshape(()))
        v = op.attr("mu") * v0 + grads[p].astype(np.float64).reshape(v0.shape)
        errs[p] = {"param_in_lr": float(np.abs(after[p] - (before[p] - lr * v)).max() / lr),
                   "velocity": _max_rel(after[op.input("Velocity")[0]], v)}
    return errs


def check_resnet_against_cpu(amp):
    """Two ResNet-50 steps at RESNET_CHECK_BATCH from the same state on the
    card (its entry warmed on a scope of its own, so a capture and a
    replay) and on the CPU.  Each loss relative to the CPU's is held to
    RESNET_LOSS_TOL.  The gradients: phase 7's measure for the layers of
    RESNET_CHECK_GRADS (max abs difference over the CPU's largest
    magnitude) and the relative L2 distance of all the gradients taken as
    one vector.  The yardstick of how far apart two correct gradients of
    this network lie is the same distances between the CPU's gradient and
    the CPU's on the same state and images nudged by 1e-6 relative, taken
    for each step; all the gradients' distance is held to
    RESNET_YARDSTICK times that step's yardstick, and in fp32 the last
    layer's (which sits above the chaos of the deep layers) to
    RESNET_FC_GRAD_TOL.  A deep layer's largest element moves with the
    single element that holds it (fp32 ``conv2d_26.w_0`` read 0.020 to
    0.139 on the second step in three runs on an H100), so those are reported
    beside their yardsticks, not held.  The learning rate var is set to
    RESNET_CHECK_LR: at bench.py's 0.1 one step on a batch of 2 saturates
    the softmax (the next loss reads 0 or -log(1e-8), with zero
    gradients), which would leave the second step nothing to check.  The
    second step takes another batch and, on the CPU, starts from the
    card's updated state, so it checks the replayed step alone.  Each
    step's Momentum update of RESNET_CHECK_GRADS is held to a float64
    numpy one over the card's own gradient (MOMENTUM_TOL)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    fmt = "NHWC" if amp else "NCHW"
    main, startup, loss, _, pg = resnet_program(fluid, fmt, amp)
    grads = [g.name for _, g in pg]
    check = [grads[[p.name for p, _ in pg].index(n)] for n in RESNET_CHECK_GRADS]
    fetch = [loss.name] + grads
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    card_scope.set(_lr_name(main), np.array([RESNET_CHECK_LR], np.float32))
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    rng = np.random.RandomState(SEED + 5)
    feeds = [resnet_feed(None, rng, RESNET_CHECK_BATCH, fmt) for _ in range(2)]
    warm = fluid.Scope()  # the entry's eager warm-up, on a scope of its own
    _load_state(warm, card_scope.vars)
    card_exe.run(main, feed=feeds[0], fetch_list=fetch, scope=warm)
    del warm

    def cpu_step(state, feed):
        scope = fluid.Scope()
        fluid.io.set_params_from_numpy(scope, state, "cpu")
        return cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=scope)

    names = dict(zip(grads, (p.name for p, _ in pg)))

    def measures(a, b):  # phase 7's per-gradient measure, and all gradients' relative L2
        out = {names[g]: _max_rel(a[1 + grads.index(g)], b[1 + grads.index(g)]) for g in check}
        out["all_rel_l2"] = _global_rel(a[1:], b[1:])
        return out

    steps, times = [], []
    for feed in feeds:  # the capture, then a replay
        state = {n: to_numpy(v) for n, v in card_scope.vars.items()}
        t0 = time.perf_counter()
        card = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
        t1 = time.perf_counter()
        cpu = cpu_step(state, feed)
        times.append((t1 - t0, time.perf_counter() - t1))
        nudged = dict(feed, img=(feed["img"] * (1 + 1e-6 * rng.standard_normal(
            feed["img"].shape))).astype(np.float32))
        yard = cpu_step(state, nudged)
        after = {n: to_numpy(v).astype(np.float64) for n, v in card_scope.vars.items()}
        steps.append({
            "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
            "loss_rel_err": _max_rel(card[0], cpu[0]),
            "grads": measures(card, cpu),
            "yardstick_nudged_cpu": measures(yard, cpu),
            "finite": all(bool(np.isfinite(a).all()) for a in card),
            "momentum_err": _momentum_errors(
                main, RESNET_CHECK_GRADS, {n: v.astype(np.float64) for n, v in state.items()},
                after, dict(zip([names[g] for g in grads], card[1:])))})
    stats = {"amp": amp, "layout": fmt, "batch": RESNET_CHECK_BATCH,
             "card_and_cpu_s": times, "loss_tol": RESNET_LOSS_TOL[amp],
             "yardstick_factor": RESNET_YARDSTICK, "steps": steps,
             "card_cache": card_exe.jit_cache_stats()}
    card_exe.close()
    log("[resnet-check-amp]" if amp else "[resnet-check]", json.dumps(stats))
    ok = stats["card_cache"]["graphs"] == 1
    for st in steps:
        ok = (ok and st["finite"] and st["loss_rel_err"] <= RESNET_LOSS_TOL[amp]
              and st["grads"]["all_rel_l2"]
              <= RESNET_YARDSTICK * st["yardstick_nudged_cpu"]["all_rel_l2"]
              and (amp or st["grads"]["fc_0.w_0"] <= RESNET_FC_GRAD_TOL)
              and all(e["param_in_lr"] <= MOMENTUM_TOL and e["velocity"] <= MOMENTUM_TOL
                      for e in st["momentum_err"].values()))
    if not ok:
        raise AssertionError("card and CPU ResNet-50 steps differ: %s" % stats)
    return stats


def run_resnet_capture_check(torch, workdir):
    """ResNet-50 (fp32, NCHW, batch RESNET_CAPTURE_BATCH, the learning-rate
    var at RESNET_CHECK_LR: at 0.1 this batch's loss climbs to the
    softmax's saturation in three steps) captured against eager from one
    state, with cuDNN held to its deterministic algorithms for the phase:
    its default weight gradients add with atomics, so two eager runs
    already differ, and a random ResNet's gradients amplify that (the
    velocities of two such runs read 22% apart on an H100).  Three steps each (the
    cached executor's capture and replays, its entry warmed on a scope of
    its own, against ``use_program_cache=False``): every loss, and the
    parameters, velocities and batch_norm running statistics (which
    batch_norm reads and writes in place), bit for bit.  Then the
    checkpoint round trip: the captured run's state after two steps saved
    with ``save_persistables``, loaded with ``load_persistables`` into a
    fresh scope, and the next step there (a capture over the new scope)
    against the uninterrupted run's third step (a replay): the same loss
    and running statistics, bit for bit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    sync = torch.cuda.synchronize
    _free_device_memory(torch)
    main, startup, loss, _, _ = resnet_program(fluid, "NCHW")
    boot_exe, boot = fluid.Executor(), fluid.Scope()
    boot_exe.run(startup, scope=boot)
    boot.set(_lr_name(main), np.array([RESNET_CHECK_LR], np.float32))
    init = _clone_state(boot)
    rng = np.random.RandomState(SEED + 6)
    feeds = [resnet_feed(torch, rng, RESNET_CAPTURE_BATCH, "NCHW", "cuda") for _ in range(3)]
    ckpt = os.path.join(workdir, "resnet50_ckpt")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    paths = {}
    for name, cached in (("eager", False), ("captured", True)):
        exe, scope = fluid.Executor(), fluid.Scope()
        if cached:  # the entry's eager warm-up, on a scope of its own
            warm = fluid.Scope()
            _load_state(warm, init)
            exe.run(main, feed=feeds[0], fetch_list=[loss], scope=warm)
            del warm
        _load_state(scope, init)
        losses, times = [], []
        for i in range(3):
            if cached and i == 2:
                fluid.io.save_persistables(exe, ckpt, main, scope=scope)
            sync()
            t = time.perf_counter()
            l, = exe.run(main, feed=feeds[i], fetch_list=[loss], scope=scope,
                         use_program_cache=cached)
            sync()
            times.append(time.perf_counter() - t)
            losses.append(float(l))
        paths[name] = {"exe": exe, "scope": scope, "losses": losses, "step_s": times,
                       "state": {n: to_numpy(v) for n, v in scope.vars.items()}}
    eager, cap = paths["eager"], paths["captured"]
    groups = {"running_stats": [n for n in init if n.endswith((".mean_0", ".variance_0"))],
              "velocities": [n for n in init if n.endswith("_velocity_0")],
              "params": [p.name for p in main.all_parameters()]}
    stats = {
        "batch": RESNET_CAPTURE_BATCH, "cudnn_deterministic": True,
        "losses": {n: p["losses"] for n, p in paths.items()},
        "losses_bit_equal": eager["losses"] == cap["losses"],
        "state_bit_equal": {g: all(np.array_equal(cap["state"][n], eager["state"][n])
                                   for n in ns) for g, ns in groups.items()},
        "running_stats_moved": all(not np.array_equal(cap["state"][n], to_numpy(init[n]))
                                   for n in groups["running_stats"]),
        "step_s": {n: p["step_s"] for n, p in paths.items()},
        "cache": {"eager": eager["exe"].jit_cache_stats(),
                  "captured": cap["exe"].jit_cache_stats()},
    }
    # the checkpoint round trip, on the captured run's executor: a fresh
    # scope gets a graph of its own
    fresh = fluid.Scope()
    fluid.io.load_persistables(cap["exe"], ckpt, main, scope=fresh)
    resumed, = cap["exe"].run(main, feed=feeds[2], fetch_list=[loss], scope=fresh)
    torch.backends.cudnn.deterministic = deterministic
    stats["checkpoint"] = {
        "vars": len(fresh.vars), "files": len(os.listdir(ckpt)),
        "resumed_loss": float(resumed), "uninterrupted_loss": cap["losses"][2],
        "loss_bit_equal": float(resumed) == cap["losses"][2],
        "running_stats_bit_equal": all(np.array_equal(to_numpy(fresh.vars[n]), cap["state"][n])
                                       for n in groups["running_stats"]),
        "graphs": cap["exe"].jit_cache_stats()["graphs"]}
    for p in paths.values():
        p["exe"].close()
    log("[resnet-capture-check]", json.dumps(stats))
    ck = stats["checkpoint"]
    if not (stats["losses_bit_equal"] and all(stats["state_bit_equal"].values())
            and stats["running_stats_moved"] and all(np.isfinite(cap["losses"]))
            and stats["cache"]["captured"]["graphs"] == 1 == ck["graphs"] - 1
            and stats["cache"]["eager"]["entries"] == 0 and ck["vars"] == len(init)
            and ck["loss_bit_equal"] and ck["running_stats_bit_equal"]):
        raise AssertionError("captured and eager ResNet-50 steps, or the checkpoint, "
                             "differ: %s" % stats)
    return stats


def run_resnet_serving(torch, workdir):
    """ResNet-50 served: ``resnet50(..., is_test=True)`` (fp32, NHWC) with
    the startup's weights and the running statistics of RESNET_STAT_STEPS
    training steps at learning rate 0 (at 0.1 two steps saturate the
    softmax, and every comparison would read 0), through
    ``save_inference_model``, ``AnalysisPredictor`` and ``InferenceServer``
    (max_batch_size 16) to RESNET_SERVE_ROWS concurrent requests, twice.
    Every answer finite, of shape [rows, 1000], within SERVE_TOL of the
    same request alone; each request alone through the captured predictor
    against the eager executor on the saved model (SERVE_TOL), and one
    against the CPU predictor (CPU_REF_TOL).  The answers' mean top
    probability must stay below 0.9, so that the comparisons see
    unsaturated probabilities."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    _free_device_memory(torch)
    main, startup, loss, _, _ = resnet_program(fluid, "NHWC")
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set(_lr_name(main), np.zeros(1, np.float32))
    rng = np.random.RandomState(SEED + 7)
    for _ in range(RESNET_STAT_STEPS):  # the data's running statistics; the weights stay put
        exe.run(main, feed=resnet_feed(torch, rng, 16, "NHWC", "cuda"), fetch_list=[loss],
                scope=scope)
    exe.close()
    test_main, _, _, pred, _ = resnet_program(fluid, "NHWC", is_test=True)
    model_dir = os.path.join(workdir, "resnet50")
    fluid.io.save_inference_model(model_dir, ["img"], [pred], exe, main_program=test_main,
                                  scope=scope)
    predictor = fluid.inference.create_paddle_predictor(fluid.inference.AnalysisConfig(model_dir))
    server = serving.InferenceServer(predictor, max_batch_size=16, batch_timeout_ms=5.0)
    stats = {}
    t0 = time.perf_counter()
    server.warmup()
    stats["warmup_s"] = time.perf_counter() - t0
    feeds = [{"img": resnet_feed(None, rng, r, "NHWC")["img"]} for r in RESNET_SERVE_ROWS]
    try:
        bursts = _serve_bursts(serving.Client(server), feeds, 2)
    finally:
        server.stop(drain=True, timeout=60)
    m = server.metrics()
    stats["bursts"] = _burst_stats(bursts, sum(RESNET_SERVE_ROWS))
    stats.update(batches=m["batches"], warmup_runs=m["warmup_runs"])
    worst = 0.0
    for f, (out,) in [(f, a) for answers, _, _ in bursts for f, a in zip(feeds, answers)]:
        if out.shape != (f["img"].shape[0], RESNET_CLASSES) or not np.isfinite(out).all():
            raise AssertionError("bad served ResNet-50 output: shape %s" % (out.shape,))
        alone, = predictor.run(f)
        worst = max(worst, float(np.abs(out - alone).max()))
    stats["served_vs_alone_max_abs"] = worst
    stats["mean_top_probability"] = float(np.mean(np.concatenate(
        [a[0].max(1) for answers, _, _ in bursts for a in answers])))
    eager_exe, eager_scope = fluid.Executor(), fluid.Scope()
    prog, _, fetch_vars = fluid.io.load_inference_model(model_dir, eager_exe, scope=eager_scope)
    worst_eager = 0.0
    for f in feeds:
        predictor.run(f)
        replayed, = predictor.run(f)
        eager, = eager_exe.run(prog, feed=f, fetch_list=fetch_vars, scope=eager_scope,
                               use_program_cache=False)
        worst_eager = max(worst_eager, float(np.abs(replayed - eager).max()))
    stats["captured_vs_eager_max_abs"] = worst_eager
    stats["cache"] = predictor.jit_cache_stats()
    cpu_cfg = fluid.inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    ref, = fluid.inference.create_paddle_predictor(cpu_cfg).run(feeds[1])
    stats["card_vs_cpu_max_abs"] = float(np.abs(bursts[-1][0][1][0] - ref).max())
    log("[resnet-serve]", json.dumps(stats))
    if not (worst <= SERVE_TOL and worst_eager <= SERVE_TOL
            and stats["card_vs_cpu_max_abs"] <= CPU_REF_TOL and stats["cache"]["graphs"] >= 1
            and stats["mean_top_probability"] < 0.9):
        raise AssertionError("served ResNet-50 answers differ: %s" % stats)
    return stats


def run_lenet(torch):
    """LeNet-5 (the tests' parity config) on the card: LENET_STEPS Momentum
    steps on one batch of LENET_BATCH, captured after the first; the loss
    must fall below 0.7 of its first value."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [1, 28, 28])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, acc, _ = models.lenet5(img, lbl)
        fluid.optimizer.MomentumOptimizer(LENET_LR, 0.9).minimize(loss)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED)
    feed = {"img": rng.uniform(0, 1, (LENET_BATCH, 1, 28, 28)).astype(np.float32),
            "lbl": rng.randint(0, 10, (LENET_BATCH, 1)).astype(np.int64)}
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
              for _ in range(LENET_STEPS)]
    stats = {"batch": LENET_BATCH, "lr": LENET_LR, "losses": losses,
             "cache": exe.jit_cache_stats()}
    exe.close()
    log("[lenet]", json.dumps(stats))
    if not (all(np.isfinite(losses)) and losses[-1] < 0.7 * losses[0]
            and stats["cache"]["graphs"] == 1):
        raise AssertionError("LeNet-5 did not train on the card: %s" % stats)
    return stats


# ---------------------------------------------------------------------------
# ---------------------------------------------------------------------------
# phases 13 to 19: the causal transformer LM slice, and the dropout kernel
# ---------------------------------------------------------------------------
def _causal_bound(case, stats=False):
    """Bytes (Q, K, V read, Out written, row statistics written with
    ``stats``) and operations (the two products over the causal triangle:
    4 N H D S (S + 1) / 2) of a causal forward without Mask."""
    n, h, s, d, dtype = case
    item = 4 if dtype == "float32" else 2
    nbytes = 4 * n * h * s * d * item + (2 * n * h * s * 4 if stats else 0)
    ops = 4 * n * h * d * s * (s + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, _ops_s(ops, dtype)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _causal_bwd_bounds(case):
    n, h, s, d, dtype = case
    item = 4 if dtype == "float32" else 2
    nhsd, pairs = n * h * s * d, n * h * s * (s + 1) // 2
    small = 3 * n * h * s * 4  # row max, log row sum, Di read (fp32)
    out = {}
    for name, nbytes, ops in (("dkv", 6 * nhsd * item + small, 8 * pairs * d),
                              ("dq", 5 * nhsd * item + small, 6 * pairs * d)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, _ops_s(ops, dtype)
        out[name] = (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")
    return out


def check_causal_kernels(torch):
    """The three attention kernels in the LM's case, causal with no Mask,
    at the LM's training and serving shapes (LM_ATTN_CASES, in the head
    split's [N, S, H, D] layout): the forward without and with its row
    statistics, and the dK/dV + dQ pair, each against its plain version
    (and fp32 also against a float64 reference) to the limits the
    padded cases use, and repeated bit for bit.  Each is timed beside the
    plain version and ``scaled_dot_product_attention(is_causal=True)``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows = []
    for case in LM_ATTN_CASES:
        n, h, s, d, dtype = case
        q, k, v = _attn_inputs(torch, (n, h, s, d, dtype, True, "nshd"), gen)[:3]
        d_out = _attn_inputs(torch, (n, h, s, d, dtype, True, "nshd"), gen)[0]
        scale = 1.0 / float(np.sqrt(d))
        out = fa.fused_attention_fwd(q, k, v, None, True, scale)
        again = fa.fused_attention_fwd(q, k, v, None, True, scale)
        out_s, stats = fa.fused_attention_fwd(q, k, v, None, True, scale, return_stats=True)
        ref, ref_stats = fa.fused_attention_plain(q, k, v, None, True, scale, return_stats=True)
        scores = fa._scores(q.float(), k.float(), None, True, scale)
        di = (out_s.float() * d_out.float()).sum(-1)

        def bwd():
            dk_, dv_ = fa.fused_attention_bwd_dkv(q, k, v, None, True, scale, d_out, stats, di)
            return fa.fused_attention_bwd_dq(q, k, v, None, True, scale, d_out, stats, di), dk_, dv_

        grads, grads2 = bwd(), bwd()
        rgrads = fa.fused_attention_bwd_plain(q, k, v, None, True, scale, out_s, d_out, stats)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        m_err, m_ok = _rel_err(stats[0], ref_stats[0])
        lse_err, lse_ok = _rel_err(fa.row_lse(stats), torch.logsumexp(scores, dim=-1))
        errs = {nm: _within(g, r, dtype) for nm, g, r in zip(("dq", "dk", "dv"), grads, rgrads)}
        if dtype == "float32":
            r64 = _bwd_fp64(torch, fa, q, k, v, None, True, scale, d_out)
            errs.update({nm + "_vs_fp64": _within(g, r, dtype)
                         for nm, g, r in zip(("dq", "dk", "dv"), grads, r64)})
            o64 = torch.softmax(scores.double(), -1) @ v.double()
            errs["out_vs_fp64"] = _within(out, o64, dtype)
        repeat = (torch.equal(out, again) and torch.equal(out_s, out)
                  and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
        finite = all(bool(torch.isfinite(t.float()).all().item()) for t in (out,) + tuple(grads))
        row = {"shape": [n, h, s, d], "dtype": dtype, "causal": True, "mask": None,
               "layout": "nshd", "max_abs_err": err, "tol": ATTN_TOL[dtype],
               "stats_max_abs_err": {"row_max": m_err, "lse": lse_err},
               "bwd_max_abs_err": {nm: e for nm, (e, _) in errs.items()},
               "repeat_bit_equal": bool(repeat)}
        row["ms"] = _time_ms(torch, lambda: fa.fused_attention_fwd(q, k, v, None, True, scale))
        row["ms_with_stats"] = _time_ms(torch, lambda: fa.fused_attention_fwd(
            q, k, v, None, True, scale, return_stats=True))
        row["plain_ms"] = _time_ms(torch, lambda: fa.fused_attention_plain(q, k, v, None, True, scale),
                                   samples=7, per_sample=3)
        row["library_ms"] = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale))
        row["bound_ms"], row["bound_by"] = _causal_bound(case)
        row["bound_ms_with_stats"] = _causal_bound(case, stats=True)[0]
        row["dkv_ms"] = _time_ms(torch, lambda: fa.fused_attention_bwd_dkv(
            q, k, v, None, True, scale, d_out, stats, di))
        row["dq_ms"] = _time_ms(torch, lambda: fa.fused_attention_bwd_dq(
            q, k, v, None, True, scale, d_out, stats, di))
        # the same kernels without causal: they walk the same tiles (the
        # causal ones above the diagonal add exactly 0), so the times show
        # what skipping those tiles could save; SDPA skips them
        _, full_stats = fa.fused_attention_fwd(q, k, v, None, False, scale, return_stats=True)
        row["noncausal_ms"] = {
            "fwd": _time_ms(torch, lambda: fa.fused_attention_fwd(q, k, v, None, False, scale)),
            "dkv": _time_ms(torch, lambda: fa.fused_attention_bwd_dkv(
                q, k, v, None, False, scale, d_out, full_stats, di)),
            "dq": _time_ms(torch, lambda: fa.fused_attention_bwd_dq(
                q, k, v, None, False, scale, d_out, full_stats, di)),
            "library_fwd": _time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale))}
        row["bwd_plain_ms"] = _time_ms(torch, lambda: fa.fused_attention_bwd_plain(
            q, k, v, None, True, scale, out_s, d_out, stats), samples=7, per_sample=3)
        qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, scale=scale)
        row["bwd_library_ms"] = _time_ms(torch, lambda: torch.autograd.grad(
            o, (qs, ks, vs), d_out, retain_graph=True))
        for key, (bound, by) in _causal_bwd_bounds(case).items():
            row[key + "_bound_ms"], row[key + "_bound_by"] = bound, by
        log("[kernel] causal LM case", json.dumps(row))
        if not (finite and repeat and err <= ATTN_TOL[dtype] and m_ok and lse_ok
                and all(ok for _, ok in errs.values())):
            raise AssertionError("causal attention kernels disagree with their plain version: %s" % row)
        rows.append((case, row))
    return rows


def check_dropout_kernel(torch):
    """The dropout kernel against ``dropout_plain`` (the same Philox in
    torch's int64 ops, on the card): Out and Mask bit-equal, for every
    DROPOUT_SHAPES, type, rate and implementation, also on an unaligned
    view; the keep rate within 5 standard deviations of 1 - p.  At the
    unfused LM's dropout sites (DROPOUT_TIMED, p = LM_DROPOUT) the kernel,
    the plain version and ``torch.nn.functional.dropout`` (which draws
    other bits) are timed; the bound is its bytes (X read, Out and Mask
    written)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import dropout as kd

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    cases = [(shape, dt, p, impl) for shape in DROPOUT_SHAPES for dt in ("float32", "bfloat16")
             for p in DROPOUT_RATES for impl in ("downgrade_in_infer", "upscale_in_train")]
    for shape, dt, p, impl in cases:
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        up = impl == "upscale_in_train"
        seed = 1000 + len(rows)
        out, mask = kd.dropout_train(x, p, seed, up)
        ref_out, ref_mask = kd.dropout_plain(x, p, seed, up)
        # an unaligned view (one element in): the kernel's element-wise path
        flat = x.reshape(-1)[1:]
        u_out, u_mask = kd.dropout_train(flat, p, seed, up)
        u_ref = kd.dropout_plain(flat, p, seed, up)
        torch.cuda.synchronize()
        n = x.numel()
        kept = mask.double().mean().item()
        sigma = (p * (1 - p) / n) ** 0.5
        row = {"shape": list(shape), "dtype": dt, "p": p, "impl": impl,
               "out_bit_equal": bool(torch.equal(out, ref_out)),
               "mask_bit_equal": bool(torch.equal(mask, ref_mask)),
               "unaligned_bit_equal": bool(torch.equal(u_out, u_ref[0]) and torch.equal(u_mask, u_ref[1])),
               "keep_rate": kept, "keep_rate_sigmas": abs(kept - (1 - p)) / sigma}
        ok = (row["out_bit_equal"] and row["mask_bit_equal"] and row["unaligned_bit_equal"]
              and row["keep_rate_sigmas"] <= 5.0)
        log("[kernel] dropout", json.dumps(row))
        if not ok:
            raise AssertionError("dropout kernel disagrees with its plain version: %s" % row)
        rows.append(row)
    timed = []
    for shape, dt in DROPOUT_TIMED:
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        item = x.element_size()
        row = {"shape": list(shape), "dtype": dt, "p": LM_DROPOUT, "impl": "downgrade_in_infer",
               "ms": _time_ms(torch, lambda: kd.dropout_train(x, LM_DROPOUT, 7, False)),
               "plain_ms": _time_ms(torch, lambda: kd.dropout_plain(x, LM_DROPOUT, 7, False),
                                    samples=5, per_sample=2),
               "library_ms": _time_ms(torch, lambda: F.dropout(x, LM_DROPOUT, training=True)),
               "bound_ms": 3 * x.numel() * item / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
        log("[kernel] dropout timed", json.dumps(row))
        timed.append(row)
    return {"checks": rows, "timed": timed}


def lm_program(fluid, fused=True, dropout=0.0, amp=False, recipe=False, train=True):
    """(main, startup, loss, logits, params_grads, lr) of transformer_lm at
    the LM widths: fused attention (causal=) or the unfused build
    (_causal_bias), with ``dropout``; ``train`` adds Adam, or with
    ``recipe`` the Transformer recipe (noam_decay, Adam beta2 0.98 and
    epsilon 1e-9, GradientClipByGlobalNorm, L2Decay), under
    ``contrib.mixed_precision.decorate`` with ``amp``.  Without ``train``
    it is the logits-only inference build (labels=None, is_test)."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    s = LM["seq_len"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    pg, lr = None, None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src_ids", [s], dtype="int64")
        labels = fluid.layers.data("labels", [s, 1], dtype="int64") if train else None
        loss, logits = transformer.transformer_lm(ids, labels, dropout_rate=dropout,
                                                  is_test=not train, fused_attention=fused, **LM)
        if train:
            if recipe:
                lr = fluid.layers.noam_decay(*LM_NOAM)
                opt = fluid.optimizer.AdamOptimizer(
                    lr, regularization=fluid.regularizer.L2Decay(LM_L2), **LM_ADAM)
                fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(LM_CLIP_NORM))
            else:
                opt = fluid.optimizer.AdamOptimizer(1e-4)
            if amp:
                opt = mixed_precision.decorate(opt)
            try:
                _, pg = opt.minimize(loss)
            finally:
                fluid.clip.set_gradient_clip(None)
    return main, startup, loss, logits, pg, lr


def lm_feed(rng, rows):
    s, vocab = LM["seq_len"], LM["vocab_size"]
    ids = rng.randint(0, vocab, (rows, s + 1)).astype("int64")
    return {"src_ids": ids[:, :-1], "labels": ids[:, 1:, None]}  # next-token targets


def run_lm_serving(torch, workdir):
    """The fused LM (fp32, logits only) saved with save_inference_model,
    loaded by AnalysisPredictor and served by InferenceServer
    (max_batch_size 4) to LM_SERVE_BURSTS bursts of concurrent requests.
    Each answer finite, of shape [rows, S, V], within SERVE_TOL of the
    request alone and of the eager executor, one within CPU_REF_TOL of the
    CPU predictor; the causal forward kernel launched n_layer times a
    dispatch."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, serving
    from paddle_tpu_torch.kernels.fused_attention import KERNEL_NAME

    stats = {"allocated_before_bytes": _free_device_memory(torch)}
    kernels.reset_launch_counts()  # counts from here on belong to the LM serving path
    main, startup, _, logits, _, _ = lm_program(fluid, train=False)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    model_dir = os.path.join(workdir, "transformer_lm")
    fluid.io.save_inference_model(model_dir, ["src_ids"], [logits], exe, main_program=main,
                                  scope=scope)
    del scope
    pred = fluid.inference.create_paddle_predictor(fluid.inference.AnalysisConfig(model_dir))
    server = serving.InferenceServer(pred, max_batch_size=4, batch_timeout_ms=5.0)
    t0 = time.perf_counter()
    server.warmup()
    stats["warmup_s"] = time.perf_counter() - t0
    stats["cache_after_warmup"] = pred.jit_cache_stats()
    rng = np.random.RandomState(SEED + 20)
    feeds = [{"src_ids": lm_feed(rng, r)["src_ids"]} for r in LM_SERVE_ROWS]
    try:
        bursts = _serve_bursts(serving.Client(server), feeds, LM_SERVE_BURSTS)
    finally:
        server.stop(drain=True, timeout=60)
    counts = kernels.launch_counts()  # read right after the LM serving path
    m = server.metrics()
    stats["cache_after_traffic"] = pred.jit_cache_stats()
    dispatches = m["batches"] + m["warmup_runs"]
    launches = counts.get(KERNEL_NAME, 0)
    stats["bursts"] = _burst_stats(bursts, sum(LM_SERVE_ROWS))
    stats.update(dispatches=dispatches, batches=m["batches"], warmup_runs=m["warmup_runs"],
                 launches=launches, by_dtype=kernels.launch_counts_by_dtype().get(KERNEL_NAME))
    if launches != LM["n_layer"] * dispatches or launches == 0:
        raise AssertionError("%s launched %d times over %d dispatches (expected %d per dispatch)"
                             % (KERNEL_NAME, launches, dispatches, LM["n_layer"]))
    worst = 0.0
    for f, (out,) in [(f, a) for answers, _, _ in bursts for f, a in zip(feeds, answers)]:
        rows = f["src_ids"].shape[0]
        if out.shape != (rows, LM["seq_len"], LM["vocab_size"]) or not np.isfinite(out).all():
            raise AssertionError("bad served LM output: shape %s" % (out.shape,))
        alone, = pred.run(f)
        worst = max(worst, float(np.abs(out - alone).max()))
    stats["served_vs_alone_max_abs"] = worst
    eager_exe, eager_scope = fluid.Executor(), fluid.Scope()
    prog, _, fetch_vars = fluid.io.load_inference_model(model_dir, eager_exe, scope=eager_scope)
    worst_eager = 0.0
    for f in feeds[:4]:
        pred.run(f)
        replayed, = pred.run(f)
        eager, = eager_exe.run(prog, feed=f, fetch_list=fetch_vars, scope=eager_scope,
                               use_program_cache=False)
        worst_eager = max(worst_eager, float(np.abs(replayed - eager).max()))
    stats["captured_vs_eager_max_abs"] = worst_eager
    cpu_cfg = fluid.inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    ref, = fluid.inference.create_paddle_predictor(cpu_cfg).run(feeds[1])
    stats["card_vs_cpu_max_abs"] = float(np.abs(bursts[-1][0][1][0] - ref).max())
    stats["logit_max_abs"] = float(np.abs(ref).max())
    log("[lm-serve]", json.dumps(stats))
    if not (worst <= SERVE_TOL and worst_eager <= SERVE_TOL
            and stats["card_vs_cpu_max_abs"] <= CPU_REF_TOL):
        raise AssertionError("served LM answers disagree: %s" % stats)
    return stats


def _lm_steps(torch, exe, main, feed, fetch, scope, names, steps):
    """``steps`` runs of the cached executor: (fetches a step, seconds a
    step, kernel launches a step by kernel)."""
    from paddle_tpu_torch import kernels

    sync = torch.cuda.synchronize
    outs, times, deltas = [], [], []
    for _ in range(steps):
        before = kernels.launch_counts()
        sync()
        t = time.perf_counter()
        outs.append(exe.run(main, feed=feed, fetch_list=fetch, scope=scope))
        sync()
        times.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        deltas.append({k: after.get(k, 0) - before.get(k, 0) for k in names})
    return outs, times, deltas


def run_lm_train(torch, amp=False):
    """Fused LM training at LM_BATCH through the cached executor (Adam
    1e-4, fp32 or bf16 AMP): the entry's eager step, its captured step,
    LM_STEPS timed replays; each step launches 2 n_layer forward (the
    grad ops' recompute with statistics), n_layer dK/dV and n_layer dQ
    causal kernels in the step's type; step time, tokens/s, peak memory,
    the graph pool, one profiled replay (idle share, kernels by class) and
    one eager step's device time by op type."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import fused_attention as fa

    names = (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME)
    n_layer = LM["n_layer"]
    per_step = {fa.KERNEL_NAME: 2 * n_layer, fa.BWD_DKV_NAME: n_layer, fa.BWD_DQ_NAME: n_layer}
    kernel_dtype = "bfloat16" if amp else "float32"
    stats = {"amp": amp, "batch": LM_BATCH, "seq_len": LM["seq_len"],
             "allocated_before_bytes": _free_device_memory(torch)}
    main, startup, loss, _, pg, _ = lm_program(fluid, amp=amp)
    stats["ops"] = len(main.global_block().ops)
    stats["params"] = int(sum(np.prod(p.shape) for p, _ in pg))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = lm_feed(np.random.RandomState(SEED), LM_BATCH)
    kernels.reset_launch_counts()  # counts from here on belong to this training path
    outs, times, deltas = _lm_steps(torch, exe, main, feed, [loss], scope, names, 2 + LM_STEPS)
    counts = kernels.launch_counts()  # read right after the training path
    by_dtype = kernels.launch_counts_by_dtype()
    losses = [float(o[0]) for o in outs]
    step_s = statistics.median(times[2:])
    stats.update(launches={k: counts.get(k, 0) for k in names},
                 launches_by_dtype={k: by_dtype.get(k, {}) for k in names},
                 launches_per_step=deltas, losses=losses, step_s=times,
                 eager_first_step_ms=1e3 * times[0], capture_step_ms=1e3 * times[1],
                 step_ms_median=1e3 * step_s, tokens_per_s=LM_BATCH * LM["seq_len"] / step_s,
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 cache=exe.jit_cache_stats())
    prof = _profile_step(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss], scope=scope),
                         all_kernels=True)
    if prof is not None:
        prof["kernel_classes"] = _kernel_classes(prof, LM_KERNEL_CLASSES)
        del prof["all_kernels"]
    stats["profile"] = prof
    exe.close()

    def eager_step():
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope, use_program_cache=False)

    eager_step()
    bd = _op_breakdown(torch, eager_step)
    stats["eager_op_breakdown"] = {
        "device_ms_in_ops": bd["device_ms_in_ops"], "recompute_ms": bd["recompute_ms"],
        "by_type": {t: bd["by_type"][t] for t in list(bd["by_type"])[:12]}}
    log("[lm-train-amp]" if amp else "[lm-train]", json.dumps(stats))
    bad = [i for i, d in enumerate(deltas) if d != per_step]
    if bad or any(set(by_dtype.get(k, {})) != {kernel_dtype} for k in names):
        raise AssertionError("LM steps launched %s (by type %s), expected %s a step in %s"
                             % (deltas, by_dtype, per_step, kernel_dtype))
    if stats["cache"]["graphs"] != 1:
        raise AssertionError("the LM training step was not captured: %s" % stats["cache"])
    if not (np.isfinite(losses).all() and losses[-1] < losses[1]):
        raise AssertionError("LM losses not finite or not falling: %s" % losses)
    return stats


def check_lm_against_cpu(amp=False):
    """The fused LM's step at LM_CHECK_BATCH on the card (captured: its
    entry warmed on a scope of its own first) and on the CPU from the same
    state: the loss and the gradients of LM_CHECK_GRADS within TRAIN_TOL
    (AMP_TOL with ``amp``) relative to the CPU's largest magnitude, as
    the BERT phases hold them; in fp32 a second step's loss too."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    main, startup, loss, _, pg, _ = lm_program(fluid, amp=amp)
    grads = {p.name: g.name for p, g in pg}
    fetch = [loss.name] + [grads[n] for n in LM_CHECK_GRADS]
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    init = {n: to_numpy(v) for n, v in card_scope.vars.items()}
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    fluid.io.set_params_from_numpy(cpu_scope, init, "cpu")
    feed = lm_feed(np.random.RandomState(SEED + 2), LM_CHECK_BATCH)
    warm = fluid.Scope()
    _load_state(warm, card_scope.vars)
    card_exe.run(main, feed=feed, fetch_list=fetch, scope=warm)
    del warm
    card = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    loss_tol, grad_tol = AMP_TOL if amp else (TRAIN_TOL, TRAIN_TOL)
    stats = {"amp": amp, "batch": LM_CHECK_BATCH, "tol": [loss_tol, grad_tol],
             "loss": [float(card[0]), float(cpu[0])], "rel_err": {}}
    pairs = list(zip(["loss"] + LM_CHECK_GRADS, card, cpu))
    if not amp:
        card2 = card_exe.run(main, feed=feed, fetch_list=fetch[:1], scope=card_scope)
        cpu2 = cpu_exe.run(main, feed=feed, fetch_list=fetch[:1], scope=cpu_scope)
        pairs.append(("loss_step2", card2[0], cpu2[0]))
    ok = card_exe.jit_cache_stats()["graphs"] == 1
    for name, a, b in pairs:
        rel = _max_rel(a, b)
        stats["rel_err"][name] = rel
        ok = ok and bool(np.isfinite(a).all()) and rel <= (grad_tol if name in LM_CHECK_GRADS
                                                           else loss_tol)
    card_exe.close()
    log("[lm-check-amp]" if amp else "[lm-check]", json.dumps(stats))
    if not ok:
        raise AssertionError("card and CPU LM steps differ: %s" % stats)
    return stats


def run_lm_capture_check(torch):
    """The fused fp32 LM captured against eager from one state:
    LM_CAPTURE_STEPS steps each, the first loss bit for bit, the rest and
    the LM_CHECK_GRADS parameters within CAPTURE_TOL (the embedding's
    gradient adds with atomics)."""
    import paddle_tpu_torch as fluid

    _free_device_memory(torch)
    main, startup, loss, _, _, _ = lm_program(fluid)
    boot_exe, boot = fluid.Executor(), fluid.Scope()
    boot_exe.run(startup, scope=boot)
    init = _clone_state(boot)
    del boot
    feeds = [lm_feed(np.random.RandomState(SEED + 30 + i), LM_BATCH) for i in range(LM_CAPTURE_STEPS)]
    paths = {}
    for name, cached in (("eager", False), ("captured", True)):
        exe, scope = fluid.Executor(), fluid.Scope()
        if cached:
            warm = fluid.Scope()
            _load_state(warm, init)
            exe.run(main, feed=feeds[0], fetch_list=[loss], scope=warm)
            del warm
        _load_state(scope, init)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                                use_program_cache=cached)[0]) for f in feeds]
        paths[name] = (exe, losses, {n: scope.vars[n].cpu().numpy() for n in LM_CHECK_GRADS})
    (e_exe, e_loss, e_par), (c_exe, c_loss, c_par) = paths["eager"], paths["captured"]
    stats = {"losses": {"eager": e_loss, "captured": c_loss},
             "first_loss_bit_equal": e_loss[0] == c_loss[0],
             "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(c_loss, e_loss)),
             "param_rel_err": {n: _max_rel(c_par[n], e_par[n]) for n in LM_CHECK_GRADS},
             "cache": c_exe.jit_cache_stats()}
    e_exe.close()
    c_exe.close()
    log("[lm-capture-check]", json.dumps(stats))
    if not (stats["first_loss_bit_equal"] and stats["cache"]["graphs"] == 1
            and max([stats["loss_rel_err"]] + list(stats["param_rel_err"].values())) <= CAPTURE_TOL):
        raise AssertionError("captured and eager LM steps differ: %s" % stats)
    return stats


def run_lm_unfused(torch):
    """The unfused LM as the Transformer recipe trains it: dropout
    LM_DROPOUT, noam_decay, Adam (beta2 0.98, epsilon 1e-9),
    GradientClipByGlobalNorm and L2Decay, in bf16 AMP, at LM_BATCH for
    2 + LM_STEPS steps through the cached executor.  Held: the step is
    captured (one graph) and launches 8 n_layer dropout kernels (each
    grad op's recompute draws its forward's mask again) and no attention
    kernel; the learning rate equals noam's formula in float64 at every
    step; captured and eager steps from one state give the first loss bit
    for bit and the rest within CAPTURE_TOL; and at dropout 0 the unfused
    and fused builds agree on the first loss within AMP_TOL's loss limit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import dropout as kd
    from paddle_tpu_torch.kernels import fused_attention as fa

    names = (kd.KERNEL_NAME, fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME)
    per_step = {kd.KERNEL_NAME: 8 * LM["n_layer"], fa.KERNEL_NAME: 0, fa.BWD_DKV_NAME: 0,
                fa.BWD_DQ_NAME: 0}
    stats = {"batch": LM_BATCH, "dropout": LM_DROPOUT, "allocated_before_bytes": _free_device_memory(torch)}
    main, startup, loss, _, pg, lr = lm_program(fluid, fused=False, dropout=LM_DROPOUT, amp=True,
                                                recipe=True)
    ops = [op.type for op in main.global_block().ops]
    stats["op_types"] = {t: ops.count(t) for t in ("dropout", "dropout_grad", "softmax", "matmul",
                                                    "cast", "sqrt", "elementwise_max", "adam")}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = _clone_state(scope)
    feed = lm_feed(np.random.RandomState(SEED + 40), LM_BATCH)
    kernels.reset_launch_counts()  # counts from here on belong to the unfused LM path
    outs, times, deltas = _lm_steps(torch, exe, main, feed, [loss, lr], scope, names, 2 + LM_STEPS)
    counts = kernels.launch_counts()  # read right after the unfused LM path
    losses = [float(o[0]) for o in outs]
    lrs = [float(np.asarray(o[1]).reshape(())) for o in outs]
    d_model, warmup = LM_NOAM
    t = np.arange(1, len(lrs) + 1, dtype=np.float64)
    noam = d_model ** -0.5 * np.minimum(t ** -0.5, t * warmup ** -1.5)
    step_s = statistics.median(times[2:])
    stats.update(launches={k: counts.get(k, 0) for k in names},
                 launches_by_dtype=kernels.launch_counts_by_dtype().get(kd.KERNEL_NAME),
                 launches_per_step=deltas, losses=losses, lr=lrs,
                 lr_rel_err=float(np.max(np.abs(np.array(lrs) - noam) / noam)),
                 step_ms_median=1e3 * step_s, tokens_per_s=LM_BATCH * LM["seq_len"] / step_s,
                 eager_first_step_ms=1e3 * times[0], capture_step_ms=1e3 * times[1],
                 max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
                 cache=exe.jit_cache_stats())
    # a replay: the timed steps' own fetches, so the same entry
    prof = _profile_step(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss, lr], scope=scope),
                         all_kernels=True)
    if prof is not None:
        prof["kernel_classes"] = _kernel_classes(prof, LM_KERNEL_CLASSES)
        del prof["all_kernels"]
    stats["profile"] = prof

    # captured against eager from the initial state and one feed: on a
    # fresh scope the warmed entry's first step is a capture, then replays
    paths = {}
    for name, x in (("captured", exe), ("eager", fluid.Executor())):
        sc = fluid.Scope()
        _load_state(sc, init)
        paths[name] = [float(x.run(main, feed=feed, fetch_list=[loss], scope=sc,
                                   use_program_cache=name == "captured")[0])
                       for _ in range(LM_CAPTURE_STEPS)]
        if name == "captured":
            stats["cache_two_scopes"] = x.jit_cache_stats()  # a graph for each scope
        del sc
        x.close()
    stats["captured_vs_eager"] = {
        "losses": paths,
        "first_loss_bit_equal": paths["captured"][0] == paths["eager"][0],
        "loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(paths["captured"], paths["eager"]))}

    # dropout 0: the unfused and fused builds from one state
    first = {}
    for fused in (False, True):
        m, st, l, _, _, _ = lm_program(fluid, fused=fused, amp=True)
        x, sc = fluid.Executor(), fluid.Scope()
        x.run(st, scope=sc)
        if fused:
            _load_state(sc, {n: v for n, v in state0.items() if n in sc.vars})
        else:
            state0 = _clone_state(sc)
        first[fused] = float(x.run(m, feed=feed, fetch_list=[l], scope=sc, use_program_cache=False)[0])
        x.close()
    stats["p0_first_loss"] = {"unfused": first[False], "fused": first[True],
                              "rel_err": abs(first[False] - first[True]) / abs(first[True])}
    log("[lm-unfused]", json.dumps(stats))
    if not (all(d == per_step for d in deltas) and stats["cache"]["graphs"] == 1
            and stats["cache_two_scopes"]["graphs"] == 2
            and np.isfinite(losses).all() and stats["lr_rel_err"] <= NOAM_TOL
            and stats["captured_vs_eager"]["first_loss_bit_equal"]
            and stats["captured_vs_eager"]["loss_rel_err"] <= CAPTURE_TOL
            and stats["p0_first_loss"]["rel_err"] <= AMP_TOL[0]):
        raise AssertionError("the unfused dropout LM failed its checks: %s" % stats)
    return stats


# ---------------------------------------------------------------------------
# phases 19 to 21: the rest of the training surface
# ---------------------------------------------------------------------------
def _row_samples(batch):
    """A pretrain_feed batch as the sample tuples a reader yields, one a
    row: the row's ids, sentence ids and input mask, its TRAIN_MASKS
    masked positions ([TRAIN_MASKS, 1], already offset into the flattened
    batch) and labels, and its NSP label.  DataFeeder stacks them back
    into the batch, reshaping the positions and labels to [-1, 1]."""
    m = TRAIN_MASKS
    return [(batch["src_ids"][i], batch["sent_ids"][i], batch["input_mask"][i],
             batch["mask_pos"][i * m:(i + 1) * m], batch["mask_label"][i * m:(i + 1) * m],
             batch["nsp_label"][i]) for i in range(len(batch["src_ids"]))]


def _ema_reference(tracked):
    """The float64 EMA recurrence over the parameters fetched after each
    step, with the fp32 decay and 1 - decay the program holds (the scale
    ops' fp32 results), and the float64 product of the decays."""
    d = float(np.float32(EMA_DECAY))
    ema = {n: np.zeros_like(v) for n, v in tracked[0].items()}
    for snap in tracked:
        for n, v in snap.items():
            ema[n] = d * ema[n] + (1.0 - d) * v
    return ema, d ** len(tracked)


def _differing(torch, a, b, names):
    """The names whose tensors in scopes ``a`` and ``b`` differ in any bit."""
    return [n for n in names if not torch.equal(a.vars[n], b.vars[n])]


def _sub_step_ms(torch, fluid, main, scope, pick):
    """Device time of the ops of ``main`` that ``pick`` selects, captured
    as a program of their own (what they are inside the captured step):
    every var they read and no picked op writes first is state, copied
    from ``scope`` (gradients, which the step makes and drops, are random
    tensors of their shape); an eager warm-up, a capture, and the replay
    timed with _time_ms.  (The eager per-op breakdown of this step cannot
    give it: the host takes longer to issue the step's 16,000 kernels than
    the spin that keeps the card behind it lasts.)"""
    blk = main.global_block()
    ops = [op for op in blk.ops if pick(op)]
    sub = fluid.Program()
    sblk = sub.global_block()
    written, state = set(), set()
    for op in ops:
        state.update(n for n in op.input_arg_names if n not in written)
        written.update(op.output_arg_names)
    for n in sorted(state | written):
        v = blk.var(n)
        sblk.create_var(name=n, shape=v.shape, dtype=v.dtype,
                        persistable=n in state or v.persistable)
    for op in ops:
        sblk.append_op(op.type, inputs=dict(op.inputs), outputs=dict(op.outputs),
                       attrs=dict(op.attrs))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    tensors = {n: scope.vars[n].clone() if n in scope.vars else
               torch.randn(tuple(blk.var(n).shape), generator=gen, device="cuda") * 1e-3
               for n in sorted(state)}
    exe, warm, sc = fluid.Executor(), fluid.Scope(), fluid.Scope()
    for x in (warm, sc):
        x.bind_device(exe.device)
        x.vars.update({n: t.clone() for n, t in tensors.items()})
    del tensors
    exe.run(sub, scope=warm)  # eager warm-up
    del warm
    exe.run(sub, scope=sc)  # capture
    ms = _time_ms(torch, _the_graph(exe).replay, samples=11, per_sample=5)
    nbytes = sum(sc.vars[n].numel() * sc.vars[n].element_size() for n in state)
    out = {"ops": len(ops), "ms": ms, "state_bytes": int(nbytes),
           "graph_pool_bytes": exe.jit_cache_stats()["graph_pool_bytes"]}
    exe.close()
    return out


def run_lamb_reader(torch):
    """Phase 19: BERT-base pretraining with LAMB (bf16 AMP, an EMA of the
    weights) fed by PyReader's double buffer, LAMB_STEPS steps through
    the cached executor (eager, captured, replays), each on a batch of its
    own.  Sample tuples go through DataFeeder and are staged on the card
    on the reader's side stream.  The phase runs under
    ``torch.use_deterministic_algorithms``: the embedding's and the
    gather's backward then add in a fixed order (sorted, not atomic), so
    two runs of the same steps give the same bits.

    Checked: each step launches 24 forward, 12 dK/dV and 12 dQ attention
    kernels, in bf16; the losses are finite and equal, bit for bit, those
    of the same batches fed as numpy dicts to a second executor from the
    same state; under ``ema.apply()`` each of LAMB_CHECK equals the
    float64 EMA recurrence of its fetched values over the bias correction
    (EMA_TOL), the decay power its float64 product (DPOW_TOL), and a
    captured eval step (captured before apply, so its replays copy the
    averages into the tensors the scope held) runs there; after
    ``restore()`` every parameter is the trained one, and the next
    captured step's loss and every persistable equal the uninterrupted
    run's bit for bit; ``device_buffered(steps=CHUNK_STEPS)`` chunks into
    ``run(steps=CHUNK_STEPS, per_step_feed=True)`` (the chunk's eager run,
    then its capture) equal the single steps bit for bit.  Measured: step
    time, tokens/s, peak memory, the graph pool, the reader's stall
    counters, a profiled replay, and the device time of the lamb ops and
    of the EMA's ops captured apart (``_sub_step_ms``).  Returns the phase's
    stats and what phase 21 continues from."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, reader
    from paddle_tpu_torch.kernels import fused_attention as fa
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.monitor import registry as mon

    sync = torch.cuda.synchronize
    n_layer = BERT_BASE["n_layer"]
    names = (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME)
    per_step = {fa.KERNEL_NAME: 2 * n_layer, fa.BWD_DKV_NAME: n_layer, fa.BWD_DQ_NAME: n_layer}
    stats = {"batch": TRAIN_BATCH, "seq_len": BERT_BASE["seq_len"], "lr": LAMB_LR,
             "weight_decay": LAMB_WD, "ema_decay": EMA_DECAY, "reader_capacity": READER_CAPACITY,
             "allocated_before_bytes": _free_device_memory(torch)}
    t0 = time.perf_counter()
    main, startup, outs, params_grads, ema = pretrain_program(fluid, transformer, amp=True,
                                                              lamb=True)
    stats["build_s"] = time.perf_counter() - t0
    block = main.global_block()
    types = [op.type for op in block.ops]
    stats["op_types"] = {t: types.count(t) for t in ("lamb", "cast", "scale", "elementwise_mul")}
    params = [p.name for p, _ in params_grads]
    test_prog = main.clone(for_test=True)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = _clone_state(scope)
    persistables = sorted(init)
    rng = np.random.RandomState(SEED + 50)
    batches = [pretrain_feed(rng, TRAIN_BATCH) for _ in range(LAMB_STEPS + 1 + 2 * CHUNK_STEPS)]
    stats["real_tokens"] = [int(b["input_mask"].sum()) for b in batches[:LAMB_STEPS]]
    py_reader = fluid.PyReader(feed_list=[block.var(n) for n, _ in PRETRAIN_FEEDS],
                               capacity=READER_CAPACITY, use_double_buffer=True, iterable=True)
    py_reader.decorate_sample_list_generator(
        lambda: (_row_samples(b) for b in batches[:LAMB_STEPS]))
    counters = ("reader_consumer_stalls_total", "reader_consumer_stall_seconds_total",
                "reader_producer_stalls_total", "reader_producer_stall_seconds_total")
    c0 = {c: mon.REGISTRY.value(c) for c in counters}

    kernels.reset_launch_counts()  # counts from here on belong to the Lamb path
    losses, times, deltas, tracked = [], [], [], []
    feeds = py_reader()
    for _ in range(LAMB_STEPS):  # eager, captured, replays: each waits for its staged batch
        before = kernels.launch_counts()
        sync()
        t = time.perf_counter()
        feed = next(feeds)
        total, = exe.run(main, feed=feed, fetch_list=[outs[0]], scope=scope)
        sync()
        times.append(time.perf_counter() - t)
        after = kernels.launch_counts()
        deltas.append({k: after.get(k, 0) - before.get(k, 0) for k in names})
        losses.append(float(total))
        tracked.append({n: scope.vars[n].double().cpu().numpy() for n in LAMB_CHECK})
    counts = kernels.launch_counts()  # read right after the Lamb path
    by_dtype = kernels.launch_counts_by_dtype()
    feeds.close()
    staged_on = {n: str(t.device) for n, t in feed.items()}
    step_s = statistics.median(times[2:])
    stats.update(
        launches={k: counts.get(k, 0) for k in names},
        launches_by_dtype={k: by_dtype.get(k, {}) for k in names},
        launches_per_step=deltas, losses=losses, step_s=times, feeds_staged_on=staged_on,
        eager_first_step_ms=1e3 * times[0], capture_step_ms=1e3 * times[1],
        step_ms_median=1e3 * step_s, tokens_per_s=TRAIN_BATCH * BERT_BASE["seq_len"] / step_s,
        real_tokens_per_s=float(np.mean(stats["real_tokens"])) / step_s,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        cache=exe.jit_cache_stats(),
        reader_stalls={c: mon.REGISTRY.value(c) - c0[c] for c in counters})

    # the same batches as numpy dicts, to a second executor from the same state
    exe2, scope2 = fluid.Executor(), fluid.Scope()
    _load_state(scope2, init)
    dict_losses = [float(exe2.run(main, feed=b, fetch_list=[outs[0]], scope=scope2)[0])
                   for b in batches[:LAMB_STEPS]]
    stats["dict_fed_losses"] = dict_losses
    stats["state_differing_after_steps"] = _differing(torch, scope, scope2, persistables)

    # the EMA under apply(), with a captured eval step there, then restore()
    ref, dpow64 = _ema_reference(tracked)
    dpow = float(scope.vars[ema._dpow_var.name].reshape(()))
    for _ in range(2):  # the eval entry's eager run and its capture, over the trained weights
        exe.run(test_prog, feed=batches[0], fetch_list=[outs[0]], scope=scope)
    trained = {n: scope.vars[n].clone() for n in params}
    with fluid.scope_guard(scope):
        with ema.apply(exe):
            applied = {n: scope.vars[n].double().cpu().numpy() for n in LAMB_CHECK}
            evals = [float(exe.run(test_prog, feed=batches[0], fetch_list=[outs[0]])[0])
                     for _ in range(2)]  # replays: each copies the averages into its buffers
    restored_differing = [n for n in params if not torch.equal(scope.vars[n], trained[n])]
    del trained
    nxt = batches[LAMB_STEPS]
    after_restore = float(exe.run(main, feed=nxt, fetch_list=[outs[0]], scope=scope)[0])
    uninterrupted = float(exe2.run(main, feed=nxt, fetch_list=[outs[0]], scope=scope2)[0])
    stats["ema"] = {
        "dpow": dpow, "dpow_float64": dpow64, "dpow_rel_err": abs(dpow - dpow64) / dpow64,
        "rel_err": {n: _max_rel(applied[n], ref[n] / (1.0 - dpow)) for n in LAMB_CHECK},
        "eval_losses_under_apply": evals, "restored_params_differing": restored_differing,
        "loss_after_restore": after_restore, "loss_uninterrupted": uninterrupted,
        "state_differing_after_restore": _differing(torch, scope, scope2, persistables),
        "cache": exe.jit_cache_stats()}

    # device_buffered chunks into steps=CHUNK_STEPS runs against single steps
    rest = batches[LAMB_STEPS + 1:]
    singles = [float(exe2.run(main, feed=b, fetch_list=[outs[0]], scope=scope2)[0]) for b in rest]
    chunk_lasts = [float(exe.run(main, feed=c, fetch_list=[outs[0]], scope=scope,
                                 steps=CHUNK_STEPS, per_step_feed=True)[0])
                   for c in reader.device_buffered(rest, size=2, steps=CHUNK_STEPS)()]
    stats["chunks"] = {"singles": singles, "chunk_last_losses": chunk_lasts,
                       "state_differing": _differing(torch, scope, scope2, persistables),
                       "cache": exe.jit_cache_stats()}
    exe2.close()
    del exe2, scope2

    try:  # a replay of the Lamb step
        prof = _profile_step(torch, lambda: exe.run(main, feed=batches[0], fetch_list=[outs[0]],
                                                    scope=scope), all_kernels=True)
        if prof is not None:
            prof["kernel_classes"] = _kernel_classes(prof, LM_KERNEL_CLASSES)
            del prof["all_kernels"]
        stats["profile"] = prof
    except RuntimeError as e:  # the profiler's own failure: the numbers are then not measured
        stats["profile"] = "not measured (%s)" % e
    del init
    stats["optimizer_part"] = {
        part: _sub_step_ms(torch, fluid, main, scope, pick)
        for part, pick in (("lamb", lambda op: op.type == "lamb"),
                           ("ema", lambda op: op.attr("op_role") == "optimize"
                            and op.type != "lamb"))}
    log("[lamb-reader]", json.dumps(stats))
    ema_stats, chunk = stats["ema"], stats["chunks"]
    ok = (all(d == per_step for d in deltas)
          and all(set(by_dtype.get(k, {})) == {"bfloat16"} for k in names)
          and stats["cache"]["graphs"] == 1 and np.isfinite(losses).all()
          and set(staged_on.values()) == {"cuda:0"}
          and dict_losses == losses and not stats["state_differing_after_steps"]
          and ema_stats["dpow_rel_err"] <= DPOW_TOL
          and max(ema_stats["rel_err"].values()) <= EMA_TOL
          and np.isfinite(evals).all() and not restored_differing
          and after_restore == uninterrupted and not ema_stats["state_differing_after_restore"]
          and ema_stats["cache"]["graphs"] == 2
          and chunk_lasts == [singles[CHUNK_STEPS - 1], singles[2 * CHUNK_STEPS - 1]]
          and not chunk["state_differing"] and chunk["cache"]["graphs"] == 3
          and stats["optimizer_part"]["lamb"]["ops"] == len(params))
    if not ok:
        raise AssertionError("the Lamb reader phase failed its checks: %s" % stats)
    return stats, {"main": main, "test": test_prog, "outs": outs, "params": params,
                   "exe": exe, "scope": scope, "batch": batches[0],
                   "step_ms_median": stats["step_ms_median"]}


def _np_update(op_type, x, attrs):
    """One step of an update op in float64 numpy, the JAX package's
    formula (paddle_tpu/ops/optimizer_ops.py), over ``x`` (slot: float64
    array, or int64 for counters)."""
    p, g = x["Param"], x.get("Grad")
    lr = float(x["LearningRate"].reshape(())) if "LearningRate" in x else None
    a = attrs
    if op_type == "lars_momentum":
        pn, gn = np.sqrt(np.sum(p * p)), np.sqrt(np.sum(g * g))
        local = a["lars_coeff"] * pn / (gn + a["lars_weight_decay"] * pn) if pn > 0 and gn > 0 else 1.0
        v = a["mu"] * x["Velocity"] + lr * local * (g + a["lars_weight_decay"] * p)
        return {"ParamOut": p - v, "VelocityOut": v}
    if op_type in ("adagrad", "decayed_adagrad"):
        d = a.get("decay", None)
        m = x["Moment"] + g * g if d is None else d * x["Moment"] + (1 - d) * g * g
        return {"ParamOut": p - lr * g / (np.sqrt(m) + a["epsilon"]), "MomentOut": m}
    if op_type == "adamax":
        m = a["beta1"] * x["Moment"] + (1 - a["beta1"]) * g
        u = np.maximum(a["beta2"] * x["InfNorm"], np.abs(g))
        return {"ParamOut": p - lr / (1 - x["Beta1Pow"].reshape(())) * (m / (u + a["epsilon"])),
                "MomentOut": m, "InfNormOut": u}
    if op_type == "adadelta":
        rho, eps = a["rho"], a["epsilon"]
        asg = rho * x["AvgSquaredGrad"] + (1 - rho) * g * g
        upd = -np.sqrt((x["AvgSquaredUpdate"] + eps) / (asg + eps)) * g
        return {"ParamOut": p + upd, "AvgSquaredGradOut": asg,
                "AvgSquaredUpdateOut": rho * x["AvgSquaredUpdate"] + (1 - rho) * upd * upd}
    if op_type == "rmsprop":
        rho, eps = a["decay"], a["epsilon"]
        ms = rho * x["MeanSquare"] + (1 - rho) * g * g
        if a["centered"]:
            mg = rho * x["MeanGrad"] + (1 - rho) * g
            den = np.sqrt(ms - mg * mg + eps)
        else:
            mg, den = x["MeanGrad"], np.sqrt(ms + eps)
        mom = a["momentum"] * x["Moment"] + lr * g / den
        return {"ParamOut": p - mom, "MomentOut": mom, "MeanSquareOut": ms, "MeanGradOut": mg}
    if op_type == "ftrl":
        pw, sq = a["lr_power"], x["SquaredAccumulator"]
        nsq = sq + g * g
        lin = x["LinearAccumulator"] + g - (nsq ** -pw - sq ** -pw) / lr * p
        y = nsq ** -pw / lr + 2 * a["l2"]
        out = np.where(np.abs(lin) > a["l1"], (a["l1"] * np.sign(lin) - lin) / y, 0.0)
        return {"ParamOut": out, "SquaredAccumOut": nsq, "LinearAccumOut": lin}
    if op_type == "lamb":
        b1, b2 = a["beta1"], a["beta2"]
        m = b1 * x["Moment1"] + (1 - b1) * g
        v = b2 * x["Moment2"] + (1 - b2) * g * g
        r = (m / (1 - x["Beta1Pow"].reshape(()))) / (np.sqrt(v / (1 - x["Beta2Pow"].reshape(())))
                                                     + a["epsilon"]) + a["weight_decay"] * p
        pn, rn = np.sqrt(np.sum(p * p)), np.sqrt(np.sum(r * r))
        ratio = pn / rn if pn > 0 and rn > 0 else 1.0
        return {"ParamOut": p - lr * ratio * r, "Moment1Out": m, "Moment2Out": v,
                "Beta1PowOut": x["Beta1Pow"] * b1, "Beta2PowOut": x["Beta2Pow"] * b2}
    if op_type == "dgc_momentum":
        u = a["mu"] * x["U"] + g
        v = x["V"] + u
        if float(x["CurrentStep"].reshape(())) < a["rampup_begin_step"]:
            return {"ParamOut": p - lr * u, "UOut": u, "VOut": x["V"]}
        k = max(1, int(round(v.size * (1.0 - a["sparsity"]))))
        sel = np.zeros(v.size, bool)
        sel[np.argpartition(np.abs(v).ravel(), v.size - k)[v.size - k:]] = True
        sel = sel.reshape(v.shape)
        return {"ParamOut": p - lr * np.where(sel, v, 0.0), "UOut": np.where(sel, 0.0, u),
                "VOut": np.where(sel, 0.0, v)}
    if op_type == "average_accumulates":
        s1, s2, s3 = x["Sum1"] + p, x["Sum2"], x["Sum3"]
        acc, old = int(x["NumAccumulates"][0]) + 1, int(x["OldNumAccumulates"][0])
        upd = int(x["NumUpdates"][0]) + 1
        if upd % a["max_num_accumulates"] == 0:
            s1, s2 = np.zeros_like(s1), s2 + s1
        if acc >= a["min_average_window"] and acc >= min(a["max_average_window"],
                                                         upd * a["average_window"]):
            s1, s2, s3, old, acc = np.zeros_like(s1), np.zeros_like(s2), s1 + s2, acc, 0
        return {"Sum1Out": s1, "Sum2Out": s2, "Sum3Out": s3,
                "NumAccumulatesOut": np.array([acc]), "OldNumAccumulatesOut": np.array([old]),
                "NumUpdatesOut": np.array([upd])}
    raise KeyError(op_type)


_STATE_OUT = {"ParamOut": "Param", "VelocityOut": "Velocity", "MomentOut": "Moment",
              "InfNormOut": "InfNorm", "Moment1Out": "Moment1", "Moment2Out": "Moment2",
              "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow",
              "AvgSquaredGradOut": "AvgSquaredGrad", "AvgSquaredUpdateOut": "AvgSquaredUpdate",
              "MeanSquareOut": "MeanSquare", "MeanGradOut": "MeanGrad",
              "SquaredAccumOut": "SquaredAccumulator", "LinearAccumOut": "LinearAccumulator",
              "Sum1Out": "Sum1", "Sum2Out": "Sum2", "Sum3Out": "Sum3",
              "NumAccumulatesOut": "NumAccumulates", "OldNumAccumulatesOut": "OldNumAccumulates",
              "NumUpdatesOut": "NumUpdates", "UOut": "U", "VOut": "V"}


def _opt_cases(torch):
    """(name, op type, state inputs (CUDA tensors at OPT_SHAPE), attrs,
    captured runs checked); Param, Grad and LearningRate are added."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)

    def rnd(scale=1.0):
        return torch.randn(OPT_SHAPE, generator=gen, device="cuda") * scale

    def pos():
        return rnd().abs() + 0.1

    def one(v, dtype=torch.float32):
        return torch.tensor([v], dtype=dtype, device="cuda")

    zeros = lambda: torch.zeros(OPT_SHAPE, device="cuda")  # noqa: E731
    cases = [
        ("lars_momentum", "lars_momentum", lambda: {"Velocity": rnd()},
         {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}, 1),
        ("adagrad", "adagrad", lambda: {"Moment": pos()}, {"epsilon": 1e-6}, 1),
        ("decayed_adagrad", "decayed_adagrad", lambda: {"Moment": pos()},
         {"decay": 0.95, "epsilon": 1e-6}, 1),
        ("adamax", "adamax", lambda: {"Moment": rnd(), "InfNorm": pos(), "Beta1Pow": one(0.81)},
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, 1),
        ("adadelta", "adadelta", lambda: {"AvgSquaredGrad": pos(), "AvgSquaredUpdate": pos()},
         {"rho": 0.95, "epsilon": 1e-6}, 1),
        ("ftrl", "ftrl", lambda: {"SquaredAccumulator": zeros(), "LinearAccumulator": zeros()},
         {"l1": 0.01, "l2": 0.01, "lr_power": -0.5}, 1),
        ("lamb", "lamb", lambda: {"Moment1": rnd(0.1), "Moment2": pos() * 0.1,
                                  "Beta1Pow": one(0.9), "Beta2Pow": one(0.999)},
         {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "weight_decay": 0.01}, 1),
        ("dgc_before_rampup", "dgc_momentum",
         lambda: {"U": rnd(0.5), "V": rnd(0.25), "CurrentStep": one(1.0)},
         {"mu": 0.9, "sparsity": 0.999, "rampup_begin_step": 2.0}, 1),
        ("dgc_after_rampup", "dgc_momentum",
         lambda: {"U": rnd(0.5), "V": rnd(0.25), "CurrentStep": one(5.0)},
         {"mu": 0.9, "sparsity": 0.999, "rampup_begin_step": 2.0}, 1),
        # max_num_accumulates 2, windows of 2 to 3: spills at updates 2
        # and 4, restarts at updates 2 and 4 (4 captured runs)
        ("average_accumulates", "average_accumulates",
         lambda: {"Sum1": zeros(), "Sum2": zeros(), "Sum3": zeros(),
                  "NumAccumulates": one(0, torch.int64), "OldNumAccumulates": one(0, torch.int64),
                  "NumUpdates": one(0, torch.int64)},
         {"average_window": 0.5, "max_num_accumulates": 2, "min_average_window": 2,
          "max_average_window": 3}, 4),
    ]
    for centered in (False, True):
        cases.insert(5, ("rmsprop_centered" if centered else "rmsprop", "rmsprop",
                         lambda: (lambda mg: {"Moment": rnd(), "MeanSquare": pos() + mg * mg,
                                              "MeanGrad": mg})(rnd(0.1)),
                         {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.9, "centered": centered}, 1))
    return cases


def _the_graph(exe):
    """The one CUDA graph an executor holds."""
    graphs = [g for e in exe._cache.values() for g in e.graphs.values()]
    if len(graphs) != 1:
        raise AssertionError("expected one captured graph, found %d" % len(graphs))
    return graphs[0].graph


def _check_update(out, ref, before, slot, keep=None):
    """An output against its float64 reference (over the elements
    ``keep`` marks, if given): a parameter in units of its largest move
    (ftrl's parameter is not a move: in its own magnitude), anything else
    relative to its largest magnitude."""
    out = out.reshape(ref.shape)
    if ref.dtype.kind == "i":
        return 0.0 if np.array_equal(out, ref) else float("inf")
    p0 = before["Param"]
    if keep is not None:
        out, ref, p0 = out[keep], ref[keep], p0[keep]
    if slot == "ParamOut" and "SquaredAccumulator" not in before:
        unit = float(np.abs(ref - p0).max())
        return float(np.abs(out - ref).max()) / max(unit, 1e-30)
    return _max_rel(out, ref)


def _dgc_band(before, attrs):
    """DGC's selection boundary: elements whose float64 |v| lies within
    fp32 rounding (1e-6 relative) of the k-th largest may be picked or not
    on either side."""
    v = (before["V"] + attrs["mu"] * before["U"] + before["Grad"]).ravel()
    k = max(1, int(round(v.size * (1.0 - attrs["sparsity"]))))
    t = np.partition(np.abs(v), v.size - k)[v.size - k]
    return (np.abs(np.abs(v) - t) <= 1e-6 * t).reshape(before["V"].shape)


def run_update_ops(torch):
    """Phase 20a: each update op the slice adds, alone in a program at
    OPT_SHAPE (the word embedding's [30522, 768]) in fp32, its state
    persistable: an eager warm-up on a scope of its own, then captured
    runs on the state (average_accumulates four, across spills and window
    restarts) each held to a float64 numpy step over the same inputs
    (OPT_TOL; DGC's top-k picks the same elements outside its rounding
    band), and the graph's replay timed against its bytes bound (each
    input read and each output written once)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.scope import to_numpy

    _free_device_memory(torch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    rows = {}
    for name, op_type, make_state, attrs, runs in _opt_cases(torch):
        state = dict(make_state(), Param=torch.randn(OPT_SHAPE, generator=gen, device="cuda"))
        if op_type != "adadelta" and op_type != "average_accumulates":
            state["LearningRate"] = torch.tensor([0.05], device="cuda")
        grad = (torch.randn(OPT_SHAPE, generator=gen, device="cuda")
                if op_type != "average_accumulates" else None)
        ins = dict(state, **({"Grad": grad} if grad is not None else {}))
        meta = {s: [torch.empty(t.shape, dtype=t.dtype, device="meta")] for s, t in ins.items()}
        outs = tuple(registry.get_kernel(op_type)(meta, dict(attrs), torch.device("meta")))
        main = fluid.Program()
        blk = main.global_block()
        for slot, t in ins.items():
            blk.create_var(name=slot.lower(), shape=tuple(t.shape), dtype=str(t.dtype).split(".")[-1],
                           persistable=slot != "Grad")
        out_vars = [_STATE_OUT[o].lower() for o in outs]
        blk.append_op(op_type, inputs={s: [s.lower()] for s in ins},
                      outputs={o: [v] for o, v in zip(outs, out_vars)}, attrs=dict(attrs))
        feed = {"grad": grad} if grad is not None else {}
        exe, scope, warm = fluid.Executor(), fluid.Scope(), fluid.Scope()
        for sc in (scope, warm):
            sc.bind_device(exe.device)
            sc.vars.update({s.lower(): t.clone() for s, t in state.items()})
        exe.run(main, feed=feed, fetch_list=out_vars, scope=warm)  # eager warm-up
        del warm
        errs, ref_state = [], {s: to_numpy(t).astype(np.float64 if t.is_floating_point() else np.int64)
                               for s, t in ins.items()}
        for _ in range(runs):
            got = exe.run(main, feed=feed, fetch_list=out_vars, scope=scope)
            ref = _np_update(op_type, ref_state, attrs)
            band = _dgc_band(ref_state, attrs) if name == "dgc_after_rampup" else None
            err = {}
            for slot, g in zip(outs, got):  # outside DGC's boundary band the picks agree
                err[slot] = _check_update(g, ref[slot], ref_state, slot,
                                          None if band is None else ~band)
            errs.append(err)
            ref_state.update({_STATE_OUT[s]: ref[s] for s in outs})
        graph = _the_graph(exe)
        ms = _time_ms(torch, graph.replay, samples=11, per_sample=OPT_TIMED_REPLAYS)
        nbytes = (sum(t.numel() * t.element_size() for t in ins.values())
                  + sum(state[_STATE_OUT[o]].numel() * state[_STATE_OUT[o]].element_size()
                        for o in outs))
        rows[name] = {"op": op_type, "shape": list(OPT_SHAPE), "runs": runs, "errors": errs,
                      "band_elements": int(band.sum()) if band is not None else None,
                      "ms": ms, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
                      "graphs": exe.jit_cache_stats()["graphs"]}
        exe.close()
        del exe, scope, state, ins, ref_state
        _free_device_memory(torch)
    log("[update-ops]", json.dumps(rows))
    bad = {n: r for n, r in rows.items()
           if r["graphs"] != 1 or any(
               e > (OPT_PARAM_TOL if slot == "ParamOut" else OPT_TOL)
               for err in r["errors"] for slot, e in err.items())}
    if bad:
        raise AssertionError("update ops off their float64 steps: %s" % bad)
    return rows


def _lenet_program(fluid, make_opt, avg=False):
    from paddle_tpu_torch import models

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [1, 28, 28])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, _, _ = models.lenet5(img, lbl)
        make_opt(fluid.optimizer).minimize(loss)
        average = fluid.optimizer.ModelAverage(0.15) if avg else None
    return main, startup, loss, average


def run_lenet_optimizers(torch):
    """Phase 20b: each optimizer class trains LeNet-5 (batch LENET_BATCH,
    one batch) for OPT_LENET_STEPS captured steps after its eager one; the
    loss stays finite and falls.  Then ModelAverage on top of Momentum, as
    phase 19 holds the EMA (with cuDNN and torch held to deterministic
    algorithms, so two runs of the same steps give the same bits): under
    ``apply()`` every parameter equals the float64 mean of its fetched
    values (the window never restarts in these steps), a captured eval
    step runs there (captured before apply), and after ``restore()`` the
    next captured step's loss and every persistable equal a run that never
    applied, bit for bit."""
    import paddle_tpu_torch as fluid

    _free_device_memory(torch)
    rng = np.random.RandomState(SEED)
    feed = {"img": rng.uniform(0, 1, (LENET_BATCH, 1, 28, 28)).astype(np.float32),
            "lbl": rng.randint(0, 10, (LENET_BATCH, 1)).astype(np.int64)}
    stats = {"batch": LENET_BATCH, "losses": {}}
    for name, make in OPT_LENET.items():
        main, startup, loss, _ = _lenet_program(fluid, make)
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
                  for _ in range(1 + OPT_LENET_STEPS)]
        stats["losses"][name] = losses
        stats.setdefault("graphs", {})[name] = exe.jit_cache_stats()["graphs"]
        exe.close()

    main, startup, loss, avg = _lenet_program(fluid, lambda O: O.MomentumOptimizer(LENET_LR, 0.9),
                                              avg=True)
    test = main.clone(for_test=True)
    params = [p.name for p in main.all_parameters()]
    with _deterministic(torch):
        runs = {}
        for applied in (True, False):
            exe, scope = fluid.Executor(), fluid.Scope()
            exe.run(startup, scope=scope)
            losses, snaps = [], []
            for _ in range(1 + OPT_LENET_STEPS):
                losses.append(float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0]))
                snaps.append({n: scope.vars[n].double().cpu().numpy() for n in params})
            row = {"losses": losses}
            if applied:
                for _ in range(2):  # the eval entry's eager run and its capture
                    exe.run(test, feed=feed, fetch_list=[loss], scope=scope)
                trained = {n: scope.vars[n].clone() for n in params}
                with fluid.scope_guard(scope):
                    with avg.apply(exe):
                        row["avg_rel_err"] = max(
                            _max_rel(scope.vars[n].double().cpu().numpy(),
                                     np.mean([s[n] for s in snaps], axis=0)) for n in params)
                        row["evals"] = [float(exe.run(test, feed=feed, fetch_list=[loss])[0])
                                        for _ in range(2)]
                row["restored_differing"] = [n for n in params
                                             if not torch.equal(scope.vars[n], trained[n])]
            row["next_loss"] = float(exe.run(main, feed=feed, fetch_list=[loss], scope=scope)[0])
            row["graphs"] = exe.jit_cache_stats()["graphs"]
            runs[applied] = (row, exe, scope)
        stats["model_average"] = runs[True][0]
        stats["model_average"]["uninterrupted"] = runs[False][0]
        stats["model_average"]["state_differing"] = _differing(
            torch, runs[True][2], runs[False][2], sorted(runs[False][2].vars))
        for _, exe, _ in runs.values():
            exe.close()
    log("[lenet-optimizers]", json.dumps(stats))
    ma = stats["model_average"]
    ok = (all(np.isfinite(l).all() and l[-1] < l[0] for l in stats["losses"].values())
          and set(stats["graphs"].values()) == {1}
          and ma["avg_rel_err"] <= EMA_TOL and np.isfinite(ma["evals"]).all()
          and not ma["restored_differing"] and ma["next_loss"] == ma["uninterrupted"]["next_loss"]
          and ma["losses"] == ma["uninterrupted"]["losses"] and not ma["state_differing"]
          and ma["graphs"] == 2)
    if not ok:
        raise AssertionError("the optimizers' LeNet runs failed their checks: %s" % stats)
    return stats


def run_export_gradients_nan(torch, ctx, workdir):
    """Phase 21, on phase 19's trained state (still under deterministic
    algorithms): ``io.save_program`` of the Lamb program, the directory
    loaded by ``load_inference_model`` into a fresh scope on a fresh
    executor, whose next step (eager, the entry's first run) gives the
    loss of the uninterrupted run's next step (a replay) and the same
    persistables, bit for bit; ``gradients(total, [bert_word_emb])`` of an
    fp32 BERT-base program equals the word embedding's gradient from
    ``append_backward`` bit for bit; and FLAGS_check_nan_inf: with the
    flag on a clean replay passes and a replay whose ``input_mask`` holds
    an inf raises naming the vars.  Replays are timed in turns, fed numpy
    dicts, fed the reader's staged batches, and fed dicts with the flag
    on (the check's cost)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import reader
    from paddle_tpu_torch.models import transformer

    main, outs, exe, scope, batch = ctx["main"], ctx["outs"], ctx["exe"], ctx["scope"], ctx["batch"]
    sync = torch.cuda.synchronize
    stats = {}
    d = os.path.join(workdir, "lamb_train_program")
    t0 = time.perf_counter()
    fluid.io.save_program(d, [n for n, _ in PRETRAIN_FEEDS], [outs[0]], exe, main, scope=scope)
    stats["save_s"] = time.perf_counter() - t0
    exe_f, scope_f = fluid.Executor(), fluid.Scope()
    t0 = time.perf_counter()
    prog, feed_names, fetch_vars = fluid.io.load_inference_model(d, exe_f, scope=scope_f)
    stats["load_s"] = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    loaded = float(exe_f.run(prog, feed=batch, fetch_list=fetch_vars, scope=scope_f)[0])
    cont = float(exe.run(main, feed=batch, fetch_list=[outs[0]], scope=scope)[0])
    stats["export"] = {"loss_loaded": loaded, "loss_uninterrupted": cont,
                       "feed_names": feed_names, "vars": len(scope_f.vars),
                       "state_differing": _differing(torch, scope_f, scope, sorted(scope.vars))}
    exe_f.close()
    del exe_f, scope_f

    # gradients() against append_backward, fp32, from the trained parameters
    grads = {}
    for how in ("gradients", "append_backward"):
        g_main, g_startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(g_main, g_startup), fluid.unique_name.guard():
            s = BERT_BASE["seq_len"]
            ins = [fluid.layers.data(n, [1 if n in ("mask_pos", "mask_label", "nsp_label") else s],
                                     dtype=dt) for n, dt in PRETRAIN_FEEDS]
            total = transformer.bert_pretrain(*ins, dropout_rate=0.0, fused_attention=True,
                                              **BERT_BASE)[0]
            word_emb = g_main.global_block().var("bert_word_emb")
            if how == "gradients":
                g_var, = fluid.gradients(total, [word_emb])
            else:
                g_var = dict((p.name, g) for p, g in fluid.append_backward(total))["bert_word_emb"]
        g_scope = fluid.Scope()
        g_scope.bind_device(exe.device)
        g_scope.vars.update({n: scope.vars[n] for n in ctx["params"]})
        grads[how] = fluid.Executor().run(g_main, feed=batch, fetch_list=[g_var], scope=g_scope,
                                          use_program_cache=False)[0]
        del g_scope
    stats["gradients"] = {"grad_name": g_var.name, "bit_equal": bool(np.array_equal(*grads.values())),
                          "max_abs_diff": float(np.abs(grads["gradients"] - grads["append_backward"]).max()),
                          "finite": bool(np.isfinite(grads["gradients"]).all())}
    del grads

    # FLAGS_check_nan_inf on the captured Lamb step
    bad = dict(batch, input_mask=batch["input_mask"].copy())
    bad["input_mask"][0, 3] = np.inf
    times = {"dict": [], "reader": [], "dict_flag_on": []}
    try:
        for _ in range(3):  # in turns: numpy dicts, the reader's staged batches, the flag on
            for mode in times:
                fluid.set_flags({"FLAGS_check_nan_inf": mode == "dict_flag_on"})
                feeds = (reader.device_buffered([batch] * 3, size=2)() if mode == "reader"
                         else iter([batch] * 3))
                for _ in range(3):
                    sync()
                    t = time.perf_counter()
                    exe.run(main, feed=next(feeds), fetch_list=[outs[0]], scope=scope)
                    sync()
                    times[mode].append(time.perf_counter() - t)
                if mode == "reader":
                    feeds.close()
        fluid.set_flags({"FLAGS_check_nan_inf": True})
        try:
            exe.run(main, feed=bad, fetch_list=[outs[0]], scope=scope)
            raised = None
        except RuntimeError as e:
            raised = str(e)
    finally:
        fluid.set_flags({"FLAGS_check_nan_inf": False})
    stats["nan_inf"] = {
        "raised": raised is not None and "nan/inf detected" in raised,
        "names_in_message": raised.count("'") // 2 if raised else 0,
        "message_head": (raised or "")[:300],
        "step_ms": {m: [1e3 * t for t in ts] for m, ts in times.items()},
        "median_ms": {m: 1e3 * statistics.median(ts) for m, ts in times.items()},
        "phase19_step_ms_median": ctx["step_ms_median"],
        "cache": exe.jit_cache_stats()}
    log("[export-gradients-nan]", json.dumps(stats))
    n = stats["nan_inf"]
    ok = (stats["export"]["loss_loaded"] == stats["export"]["loss_uninterrupted"]
          and not stats["export"]["state_differing"]
          and stats["gradients"]["bit_equal"] and stats["gradients"]["finite"]
          and n["raised"] and outs[0].name in raised
          and n["median_ms"]["dict"] < n["median_ms"]["dict_flag_on"])
    if not ok:
        raise AssertionError("the export, gradients or nan/inf checks failed: %s" % stats)
    return stats


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
    causal_checks = check_causal_kernels(torch)
    dropout_checks = check_dropout_kernel(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stats = run_slice(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    train = run_train(torch)
    check_train_against_cpu()
    run_capture_check(torch)
    train_amp = run_train(torch, amp=True)
    check_train_against_cpu(amp=True)
    resnet_amp = run_resnet_train(torch, amp=True)
    check_resnet_against_cpu(amp=True)
    resnet = run_resnet_train(torch, amp=False)
    check_resnet_against_cpu(amp=False)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run_resnet_capture_check(torch, workdir)
        run_resnet_serving(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run_lenet(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        lm_serve = run_lm_serving(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    lm_train = run_lm_train(torch)
    check_lm_against_cpu()
    run_lm_capture_check(torch)
    lm_train_amp = run_lm_train(torch, amp=True)
    check_lm_against_cpu(amp=True)
    lm_unfused = run_lm_unfused(torch)
    with _deterministic(torch):  # phase 21 continues from phase 19's state
        lamb, ctx = run_lamb_reader(torch)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            run_export_gradients_nan(torch, ctx, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        ctx["exe"].close()
        del ctx
    check_train_against_cpu(amp=True, lamb=True)
    run_update_ops(torch)
    run_lenet_optimizers(torch)
    # the ResNet path runs no TPU kernel: its launches of the attention kernels
    resnet_launches = {"resnet50_amp": resnet_amp["launches"], "resnet50": resnet["launches"]}
    # the LM paths: fused serving and training run the causal kernels; the
    # unfused one runs the dropout kernel and no attention kernel
    lm_launches = {"lm_train": lm_train["launches"], "lm_train_amp": lm_train_amp["launches"],
                   "lm_unfused": lm_unfused["launches"]}
    # BERT-base with Lamb through the reader (phase 19): the three attention kernels
    lamb_launches = {"lamb_reader": lamb["launches"]}
    lm_rows = {(c[0], c[4]): row for c, row in causal_checks}

    def row_of(rows, case):  # the timed row of a case
        return dict(next(row for c, row in rows if c == case and not row["all_pad_row"]))

    main_row, train_row = row_of(checks, MAIN_CASE), row_of(checks, TRAIN_CASE)
    bwd_row, bwd_amp_row = row_of(bwd_checks, TRAIN_CASE), row_of(bwd_checks, AMP_CASE)
    fwd_launches = {"serve": stats["launches"], "train": train["launches"][fa.KERNEL_NAME],
                    "train_amp": train_amp["launches"][fa.KERNEL_NAME]}
    fwd_launches.update({p: c.get(fa.KERNEL_NAME, 0) for p, c in resnet_launches.items()})
    fwd_launches["lm_serve"] = lm_serve["launches"]
    fwd_launches.update({p: c.get(fa.KERNEL_NAME, 0) for p, c in lm_launches.items()})
    fwd_launches.update({p: c.get(fa.KERNEL_NAME, 0) for p, c in lamb_launches.items()})
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
        "amp_shape": row_of(checks, AMP_CASE),
        "lm_causal": {
            "train_fp32": {k: lm_rows[(64, "float32")][k] for k in ("ms", "ms_with_stats", "plain_ms",
                           "library_ms", "bound_ms", "bound_ms_with_stats", "bound_by", "max_abs_err")},
            "train_bf16": {k: lm_rows[(64, "bfloat16")][k] for k in ("ms", "ms_with_stats", "plain_ms",
                           "library_ms", "bound_ms", "bound_ms_with_stats", "bound_by", "max_abs_err")},
            "serve_fp32": {k: lm_rows[(4, "float32")][k] for k in ("ms", "plain_ms", "library_ms",
                                                                   "bound_ms", "max_abs_err")},
            "serve_bf16": {k: lm_rows[(4, "bfloat16")][k] for k in ("ms", "plain_ms", "library_ms",
                                                                    "bound_ms", "max_abs_err")}},
        "cases": [row for _, row in checks] + [row for _, row in causal_checks],
    }]
    for name, key, line, fn, errs in (
            (fa.BWD_DKV_NAME, "dkv", 1121, "_flash_attention_bwd_dkv", ("dk", "dv")),
            (fa.BWD_DQ_NAME, "dq", 1456, "_flash_attention_bwd_dq", ("dq",))):
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "paddle_tpu_torch/csrc/fused_attention_bwd.cu",
            "replaces": replaced % (line, fn),
            "launches": (train["launches"][name] + train_amp["launches"][name]
                         + sum(c.get(name, 0) for c in lm_launches.values())
                         + sum(c.get(name, 0) for c in lamb_launches.values())),
            "launches_by_path": dict({"train": train["launches"][name],
                                      "train_amp": train_amp["launches"][name]},
                                     **{p: c.get(name, 0) for p, c in resnet_launches.items()},
                                     **{p: c.get(name, 0) for p, c in lm_launches.items()},
                                     **{p: c.get(name, 0) for p, c in lamb_launches.items()}),
            "max_abs_err": max(bwd_row["max_abs_err"][e] for e in errs),
            "ms": bwd_row[key + "_ms"],
            # one plain backward and one SDPA backward compute dQ, dK and dV together
            "plain_ms": bwd_row["plain_ms"],
            "bound_ms": bwd_row[key + "_bound_ms"],
            "bound_by": bwd_row[key + "_bound_by"],
            "library_ms": bwd_row["library_ms"],
            "shape": bwd_row["shape"],
            "dtype": bwd_row["dtype"],
            "amp_shape": bwd_amp_row,
            "lm_causal": {dt: {"ms": lm_rows[(64, dt)][key + "_ms"],
                               "bound_ms": lm_rows[(64, dt)][key + "_bound_ms"],
                               "plain_ms": lm_rows[(64, dt)]["bwd_plain_ms"],
                               "library_ms": lm_rows[(64, dt)]["bwd_library_ms"],
                               "max_abs_err": max(lm_rows[(64, dt)]["bwd_max_abs_err"][e] for e in errs)}
                          for dt in ("float32", "bfloat16")},
            "cases": [row for _, row in bwd_checks],
        })
    main_drop = dropout_checks["timed"][0]  # the unfused AMP LM's FFN dropout
    entries.append({
        "name": "dropout",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/dropout.cu",
        "replaces": "paddle_tpu/ops/nn_ops.py:322 (dropout; XLA-fused on the TPU, no pallas_call)",
        "launches": sum(c.get("dropout", 0) for c in lm_launches.values()),
        "launches_by_path": {p: c.get("dropout", 0) for p, c in lm_launches.items()},
        "max_abs_err": 0.0 if all(r["out_bit_equal"] and r["mask_bit_equal"]
                                  for r in dropout_checks["checks"]) else None,
        "ms": main_drop["ms"],
        "plain_ms": main_drop["plain_ms"],
        "bound_ms": main_drop["bound_ms"],
        "bound_by": main_drop["bound_by"],
        "library_ms": main_drop["library_ms"],
        "shape": main_drop["shape"],
        "dtype": main_drop["dtype"],
        "timed": dropout_checks["timed"],
        "cases": dropout_checks["checks"],
    })
    log("[done] %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": entries}))
    print(info["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
