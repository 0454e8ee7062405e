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
   bit for bit, at the LM's FFN and attention-weight shapes, VGG-16's two
   dropout inputs and an odd size, fp32 and bf16, p 0.1 and 0.5, both
   implementations, also on an unaligned view; the keep rate within 5
   standard deviations; timed at the unfused LM's three dropout sites and
   VGG-16's two against its bytes bound.
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

22. DeepFM CTR with its tables in HBM (bench_deepfm.py's widths: 1M
   features, 39 fields, embedding 16, deep (400, 400, 400), batch 4096,
   Adam 1e-3), trained as a Fluid CTR user trains it: 16 batches written
   as two MultiSlot files from the seed, loaded into an
   ``InMemoryDataset``, ``global_shuffle(seed=0)``, then
   ``Executor.train_from_dataset(thread=2)`` (batches staged on the card).
   Under deterministic algorithms the 16 losses are bit-equal to a hand
   loop of ``Executor.run`` over the same batches, and the last loss and
   every persistable to ``run(steps=16, per_step_feed=True)``
   (bench_deepfm.py's regime).  Measured: the median step after the
   capture, examples/s, a profiled replay (idle share), peak memory, the
   graph pool, an eager step's device time by op type, and the streaming
   ``metrics.Auc`` of the epoch's probabilities.  Then one step's Adam
   update of ``deepfm_fm_emb`` against float64 numpy, and two steps at
   batch 64 against the CPU.
23. DeepFM with its tables on two in-process parameter servers
   (``bind_distributed_tables``): sync, from zero tables with SGD on both
   sides, 4 steps at batch 4096 against the HBM run within rtol 2e-4,
   with the host seconds of each step's pull, device step and push, the
   unique-id count and bucket; then async under a ``DownpourSGD``
   trainer through ``train_from_dataset(thread=2)`` and the overlapped
   prefetch, 4 steps over one batch: the ids reach the host expansion as
   host arrays (the prefetch stages the other feeds on the card), the
   loss falls, and after ``flush()`` the
   servers hold every queued push (their rows equal a float64 replay of
   the pushes), with the pull seconds the overlap hid.
24. GeoSGD (``sync_every=2``) on a small fc program: the pulled
   parameters land on ``cuda:0`` and the next captured step reads them
   (its loss bit-equal to an eager step from the same state);
   ``DownpourSGD`` on a program without distributed tables raises.

25. Transformer NMT trained at bench_nmt.py's widths and feed (vocab
   32,000, d_model 512, 6+6 layers, 8 heads, d_inner 2048, batch 128,
   src/tgt 64, source lengths uniform in [32, 64] through ``src_mask``,
   bf16 AMP, Adam 1e-4): eager, captured and 5 replayed steps; the
   median replay, real tokens/s as bench_nmt.py counts them and padded
   tokens/s, peak memory, the graph pool, a profiled replay and an eager
   step's device time by op type; under deterministic algorithms 3
   captured steps bit for bit against 3 eager ones; then one step at
   batch 4 against the CPU in fp32 (1e-3) and in AMP (the AMP limits).
26. Decoding: greedy and beam (beam 4, max_len 64) over 8 sources with
   phase 25's weights, full prefix through ``make_program_logits_fn``;
   each source's tokens on the card against the CPU's up to the first
   step where the CPU's margin for that source is below 1e-3; a profiled
   greedy decode; the cached decode at ``transformer_lm``'s defaults
   against its full-prefix decode (teacher-forced logits within 1e-4); ms
   per generated token.
27. The Fluid book's RNN translation models at Fluid 1.5's book widths
   (dict 30,000, word 16, hidden 32, beam 2, max length 8, batch 64):
   the dynamic_lstm encoder with a DynamicRNN decoder (Adam) and the
   bi-LSTM encoder-decoder (Adagrad), each captured and bit for bit
   against eager; the ``While(max_trip_count=8)`` beam decode captured
   with the CPU's SentenceIds; the unbounded ``While`` decode on the
   interpreter (no graph) with the same SentenceIds.
   Phases 25 to 27 launch none of the four hand kernels (checked).

28. VGG-16 (the JAX package's models/vgg.py) at ImageNet widths: 224x224
   NCHW, 1000 classes, batch 64, bf16 AMP, ``MomentumOptimizer(0.01,
   0.9)``, both dropouts, fed by ``layers.create_py_reader_by_data``
   (an iterable PyReader staging each batch on the card, double buffer)
   from seeded synthetic images: eager, captured and 5 replayed steps;
   the median replay, images/s, peak memory, the graph pool, a profiled
   replay (idle share, kernels by class) and the dropout kernel's
   launches (4 a step: two layers, each again in its vjp's recompute).
   Then 3 captured steps at batch 16 bit for bit against 3 eager ones
   under deterministic algorithms; one step at 64x64, batch 16, no
   dropout, against the CPU in fp32 (the loss and the last fc's gradient
   within 1e-3, all gradients within 2x the CPU's own distance under a
   1e-6 nudge of the images) and in AMP (the loss within 5e-3, every
   gradient measure within 1.25x that nudge's); and the ``is_test``
   build exported with the trained weights and served in fp32 through
   ``AnalysisPredictor`` and ``InferenceServer`` to concurrent requests,
   each answer within 1e-4 of the eager executor.  The dropout kernel is
   also held bit for bit against its plain version at VGG-16's two
   dropout inputs ([64, 512, 7, 7] and [64, 4096], bf16, p 0.5) and
   timed there (phase 14's checks).
29. The core layers' op types (the math, tensor and plain nn ops) at
   model widths (BERT-base activations, its vocabulary table, NMT's
   logits, ResNet-50's stage-1 activation, DeepFM's [4096, 39], and
   bench_ops.py's shapes where it has the op), each alone through
   ``Executor.run`` on cuda:0: captured replays bit for bit against
   eager under deterministic algorithms, forward and vjp against the CPU,
   the median replay's device time beside its bytes bound; the host-read
   (py_func, load, linspace) and random (sampling_id,
   uniform_random_batch_size_like) types stay on the interpreter, held
   against the CPU or by their distribution.  Phases 28 and 29 launch no
   attention kernel (checked); phase 28 launches the dropout kernel.

30. The Fluid 1.5 book's sentiment model (chapter 06, ``convolution_net``,
   the program tests/book/test_understand_sentiment.py builds) at the
   book's widths: a 5,147-word dictionary (synthetic), embedding 128, two
   ``nets.sequence_conv_pool`` windows (3 and 4 words, 512 filters, tanh,
   sqrt pooling), fc to 2 classes with softmax, ``Adagrad(0.002)``, batch
   128 of reviews of 32 to 256 tokens padded to 256 and fed with
   ``words_seq_len``, in fp32: startup on the card, eager, captured and 5
   replayed steps; the median replay, reviews/s, peak memory, the graph
   pool and a profiled replay's kernels by class.  Under deterministic
   algorithms 3 captured steps bit for bit against 3 eager ones; 2 steps at
   batch 4 against the CPU (losses, gradients and parameters within 1e-3);
   the ``is_test`` build exported with the trained weights and served
   through ``AnalysisPredictor`` and ``InferenceServer`` to concurrent
   requests of 1 to 8 reviews of mixed lengths, each answer within 1e-4 of
   the request alone and of the eager executor, within 1e-3 of the CPU
   predictor.
31. Each op type of the sequence, RNN-unit and sampled-loss part at a
   model width (phase 29's method): nce (each sampler) and hsigmoid over
   BERT's [30522, 768] table with 4,096 rows, cos_sim at [4096, 768],
   sequence_conv, row_conv (20 steps of lookahead), sequence_reshape,
   sequence_scatter and chunk_eval at phase 30's [128, 256, ...],
   lstm_unit and gru_unit at batch 128, hidden 512, im2sequence on [32,
   64, 48, 48] with a 3x3 kernel, warpctc on logits [32, 64, 96] with
   labels up to 24: captured with no eager op, bit for bit against eager,
   forward and vjp against the CPU, the replay's device time beside its
   bytes bound.  nce's draw on the card: the same labels give the same
   negatives (the CPU's too), and a chi-square test of 1M draws against
   each sampler's distribution gives p > 1e-3.  Phases 30 and 31 launch
   none of the four hand kernels (checked).

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
FP32_PEAK = 67e12  # H100 SXM fp32 outside the tensor cores (TF32 off), NVIDIA's data sheet
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
# attention weights, VGG-16's two dropout inputs at batch 64, and an odd
# size), both types, both rates
DROPOUT_SHAPES = [(64, 256, 2048), (64, 8, 256, 256), (64, 512, 7, 7), (64, 4096), (7, 1001)]
DROPOUT_RATES = [0.1, 0.5]
# timed at the unfused AMP LM's three dropout sites (p = LM_DROPOUT) and
# VGG-16's two (bf16 under AMP, p = 0.5): (shape, dtype, p)
DROPOUT_TIMED = [((64, 256, 2048), "bfloat16", LM_DROPOUT), ((64, 8, 256, 256), "float32", LM_DROPOUT),
                 ((64, 256, 512), "bfloat16", LM_DROPOUT), ((64, 512, 7, 7), "bfloat16", 0.5),
                 ((64, 4096), "bfloat16", 0.5)]
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
# DeepFM CTR at bench_deepfm.py's widths (its :19-26): 1,000,000 features,
# 39 fields, embedding 16, deep tower (400, 400, 400), batch 4096,
# AdamOptimizer(1e-3); 16 batches of MultiSlot text in two files
DEEPFM = dict(num_features=1_000_000, num_fields=39, embed_dim=16, deep_layers=(400, 400, 400))
DEEPFM_BATCH = 4096
DEEPFM_BATCHES = 16
DEEPFM_FILES = 2
DEEPFM_CHECK_BATCH = 64  # the card-vs-CPU DeepFM steps
DEEPFM_CPU_TOL = 1e-3    # their loss and the fm table's gradient, relative (fp32 sums)
# the parameter-server runs: sync against HBM from zero tables with SGD on
# both sides (tests/test_distributed.py:285's parity), async under a
# DownpourSGD trainer; PS_STEPS steps each
PS_STEPS = 4
PS_LR = 0.5
PS_SYNC_RTOL = 2e-4      # the JAX package's PS-against-dense tolerance
# the servers' rows after the async epoch against a float64 replay of its
# pushes, relative to the largest row value (float32 sums of a few pushes)
PS_REPLAY_TOL = 1e-5
GEO_SYNC_EVERY = 2
CARD = "cuda:0"  # the device of the DeepFM phases' scopes
# Transformer NMT at bench_nmt.py's widths (its :29-52; BASELINE config 4):
# vocab 32,000, d_model 512, 6+6 layers, 8 heads, d_inner 2048, batch 128,
# src/tgt 64, source lengths uniform in [32, 64] carried by src_mask, bf16
# AMP, AdamOptimizer(1e-4)
NMT = dict(src_vocab=32000, tgt_vocab=32000, d_model=512, n_layer=6, n_head=8, d_inner=2048,
           src_len=64, tgt_len=64)
NMT_BATCH = 128          # 8,192 source and 8,192 target tokens a step
NMT_LR = 1e-4
NMT_STEPS = 5            # timed (replayed) steps, after the eager and the captured step
NMT_CAPTURE_STEPS = 3
NMT_CHECK_BATCH = 4      # the card-vs-CPU NMT steps
NMT_CHECK_GRADS = ["nmt_tgt_word_emb", "nmt_dec_0_cross_q_w", "nmt_head_w"]
# decoding (phase 26): greedy and beam over DECODE_SOURCES sources of
# phase 25's feed, max_len = tgt_len; card tokens equal the CPU's up to the
# first step where the CPU's top-2 (beam: top K + 1) margin is below
# DECODE_TIE_MARGIN; the cached LM step's teacher-forced logits within
# DECODE_LOGIT_TOL of the full program's, relative to max(1, max |logit|)
DECODE_SOURCES = 8
DECODE_BEAM = 4
DECODE_TIE_MARGIN = 1e-3
DECODE_LOGIT_TOL = 1e-4
DECODE_LM_LEN = 64
BOS, EOS = 1, 2
# the Fluid book's RNN translation models at upstream Fluid 1.5's book
# config (dict 30,000, word 16, hidden 32, beam 2, max length 8), batch 64,
# sentences of up to 16 words
BOOK = dict(dict=30000, word=16, hidden=32, beam=2, max_len=8, batch=64, src_len=16, trg_len=16,
            lr=1e-3)
BOOK_STEPS = 5           # each training path: eager (or warm-up), captured, 3 replays
# classes of the kernels of a DeepFM step, matched in order on the name
DEEPFM_KERNEL_CLASSES = [
    ("gemm", ("gemm", "xmma", "cutlass", "sm90_", "sm80_", "nvjet")),
    ("embedding lookup and gradient (gather, index_add, sort)",
     ("gather", "index", "scatter", "sort", "radix", "cub::")),
    ("copies and fills", ("memcpy", "memset", "copy", "fill")),
    ("reductions", ("reduce",)),
    ("elementwise (Adam, activations)", ("elementwise",)),
]


# VGG-16 (phase 28): the JAX package's models/vgg.py, config D of Simonyan &
# Zisserman 2014 with batch norm (Paddle's float16 benchmark model), at
# ImageNet widths: 224x224x3 NCHW, 1000 classes, batch 64, bf16 AMP under
# MomentumOptimizer(0.01, 0.9), both dropout(0.5) layers on
VGG_HW, VGG_CLASSES = 224, 1000
VGG_BATCH = 64
VGG_LR, VGG_MU = 0.01, 0.9
VGG_STEPS = 5            # timed (replayed) steps, after the eager and the captured step
VGG_READER_CAPACITY = 4
VGG16_FWD_FLOPS_PER_IMG = 30.94e9  # 13 convs and 3 fcs at 224x224; a training step is 3x
VGG_CAPTURE_BATCH = 16   # captured against eager, bit for bit
VGG_CHECK_HW, VGG_CHECK_BATCH = 64, 16  # the card-vs-CPU step (no dropout)
VGG_CHECK_GRADS = ["conv2d_0.w_0", "conv2d_12.w_0", "fc_0.w_0", "fc_1.w_0", "fc_2.w_0"]
VGG_YARDSTICK = 2.0      # fp32: all gradients within 2x the CPU's own distance under a 1e-6 nudge
VGG_AMP_YARDSTICK = 1.25  # AMP: every gradient measure within 1.25x its nudge distance
VGG_SERVE_ROWS = [1, 3, 8, 2, 5]
VGG_SERVE_REL_TOL = 1e-3  # served against eager, relative to the smallest top probability
# phase 29's shapes: bench_ops.py's HOT_OPS (reduce_mean; transpose_attn),
# BERT-base's activations and vocabulary, NMT's logits [tokens, vocab],
# ResNet-50's stage-1 activation (conv2d_s2's input), bench_ops.py's top_k
# input, DeepFM's [batch, fields], a BERT FFN weight, and
# bilinear_tensor_product's [rows, size]
CORE_SHAPES = {"hot": (128, 128, 768), "attn": (128, 128, 12, 64), "bert": (32, 128, 768),
               "vocab": (30522, 768), "indices": 4096, "logits": (8192, 32000),
               "resnet": (64, 64, 56, 56), "wide": (256, 30522), "ctr": (4096, 39),
               "spectral": (3072, 768), "btp": (4096, 16)}

# phase 30: the Fluid 1.5 book's chapter 06 sentiment model (convolution_net)
# at the book's widths: imdb's word_dict() of 5,147 words (a synthetic table
# here), embedding 128, hid_dim 512 filters over windows of 3 and 4 words
# (tanh, sqrt pooling), 2 classes, Adagrad(0.002), batch 128; reviews of 32
# to 256 tokens padded to 256, fed with their lengths (words_seq_len)
SENT = dict(dict_size=5147, emb=128, hid=512, classes=2, max_len=256, min_len=32)
SENT_BATCH = 128
SENT_LR = 0.002
SENT_STEPS = 5           # timed (replayed) steps, after the eager and the captured step
SENT_CAPTURE_STEPS = 3
SENT_CHECK_BATCH = 4     # the card-vs-CPU steps
SENT_CHECK_STEPS = 2
SENT_SERVE_ROWS = [1, 3, 8, 2, 5, 4, 7, 6]
# phase 31: each op type A1b's second part adds, at a model width: BERT-base's
# vocabulary table [30522, 768] under 4,096 rows (nce, hsigmoid, cos_sim),
# phase 30's [128, 256, 128] (sequence_conv, row_conv with 20 steps of
# lookahead, sequence_reshape, sequence_scatter into its 5,147 words,
# chunk_eval over 29 IOB types), batch 128 at hidden 512 (lstm_unit,
# gru_unit), a ResNet-style [32, 64, 48, 48] (im2sequence, 3x3), and CTC
# logits [32, 64, 96] (95 classes and a blank) with labels up to 24
SEQ_UNIT = dict(rows=4096, vocab=30522, width=768, neg=10, seq=(128, 256, 128), filters=512,
                lookahead=20, unit=(128, 512), img=(32, 64, 48, 48), ctc=(32, 64, 96),
                ctc_label=24, chunk_types=29)
NCE_CHI2_DRAWS = 100_000  # label sums drawn for each sampler's chi-square test (10 ids each)


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
    unfused LM's and VGG-16's dropout sites (DROPOUT_TIMED, each at its
    rate) the kernel, the plain version and
    ``torch.nn.functional.dropout`` (which draws other bits) are timed;
    the bound is its bytes (X read, Out and Mask written)."""
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
    for shape, dt, p in DROPOUT_TIMED:
        x = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dt))
        item = x.element_size()
        row = {"shape": list(shape), "dtype": dt, "p": p, "impl": "downgrade_in_infer",
               "ms": _time_ms(torch, lambda: kd.dropout_train(x, p, 7, False)),
               "plain_ms": _time_ms(torch, lambda: kd.dropout_plain(x, p, 7, False),
                                    samples=5, per_sample=2),
               "library_ms": _time_ms(torch, lambda: F.dropout(x, p, training=True)),
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


# ---------------------------------------------------------------------------
# phases 22 to 24: DeepFM from a MultiSlot dataset, on HBM and on the PS
# ---------------------------------------------------------------------------
def deepfm_program(fluid, distributed=False, opt="adam", lr=1e-3):
    """bench_deepfm.py's DeepFM (or its parameter-server build):
    (main, startup, loss, prob, [ids, vals, label])."""
    from paddle_tpu_torch import models

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 42
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("ids", [DEEPFM["num_fields"], 1], dtype="int64")
        vals = fluid.layers.data("vals", [DEEPFM["num_fields"]])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, prob = models.deepfm_ctr(ids, vals, lbl, distributed_emb=distributed, **DEEPFM)
        make = fluid.optimizer.AdamOptimizer if opt == "adam" else fluid.optimizer.SGDOptimizer
        make(lr).minimize(loss)
    return main, startup, loss, prob, [ids, vals, lbl]


def write_multislot(workdir):
    """DEEPFM_BATCHES batches of DEEPFM_BATCH lines, split over DEEPFM_FILES
    MultiSlot files, from SEED: per line 39 ids, 39 values in [0, 1) and a
    label.  The label is learnable: 1 where a hidden first-order score of
    the line's features is above its median."""
    f, n = DEEPFM["num_fields"], DEEPFM_BATCH * DEEPFM_BATCHES
    rng = np.random.RandomState(SEED)
    ids = rng.randint(0, DEEPFM["num_features"], (n, f))
    vals = rng.uniform(0, 1, (n, f)).round(4)
    score = (rng.randn(DEEPFM["num_features"])[ids] * vals).sum(1)
    label = (score > np.median(score)).astype(np.int64)
    paths, per = [], n // DEEPFM_FILES
    # count, ids; count, values; count 1 (a literal), label
    fmt = " ".join(["%d"] * (f + 2) + ["%.4f"] * f + ["1", "%d"])
    for k in range(DEEPFM_FILES):
        part = slice(k * per, (k + 1) * per)
        rows = np.concatenate([np.full((per, 1), f), ids[part], np.full((per, 1), f),
                               vals[part], label[part, None]], axis=1)
        path = os.path.join(workdir, "part-%05d" % k)
        np.savetxt(path, rows, fmt=fmt)
        paths.append(path)
    return paths


def _deepfm_dataset(fluid, use_vars, paths):
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_use_var(use_vars)
    ds.set_batch_size(DEEPFM_BATCH)
    ds.set_filelist(paths)
    ds.load_into_memory()
    ds.global_shuffle(seed=0)
    return ds


def _timed_runs(torch, exe):
    """Wrap ``exe.run`` so each call is timed to its end on the card
    (``train_from_dataset`` calls it per step); returns the list of
    (seconds, feed devices)."""
    record, run = [], exe.run

    def timed(program=None, feed=None, **kw):
        t = time.perf_counter()
        out = run(program, feed=feed, **kw)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t, sorted({str(v.device) for v in feed.values()
                                                        if isinstance(v, torch.Tensor)})))
        return out

    exe.run = timed
    return record


def run_deepfm_hbm(torch, workdir):
    """Phase 22 (see the module docstring)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels, native

    stats = {"widths": DEEPFM, "batch": DEEPFM_BATCH, "batches": DEEPFM_BATCHES,
             "native_available": native.native_available(),
             "allocated_before_bytes": _free_device_memory(torch)}
    t = time.perf_counter()
    paths = write_multislot(workdir)
    stats["write_files_s"] = time.perf_counter() - t
    stats["file_bytes"] = sum(os.path.getsize(p) for p in paths)
    main, startup, loss, prob, use_vars = deepfm_program(fluid)
    t = time.perf_counter()
    ds = _deepfm_dataset(fluid, use_vars, paths)
    stats["load_and_shuffle_s"] = time.perf_counter() - t
    batches = list(ds)
    stats["examples"] = ds.get_memory_data_size()
    boot = fluid.Scope()
    fluid.Executor().run(startup, scope=boot)
    init = _clone_state(boot)
    del boot

    def scope_from_init():
        sc = fluid.Scope(device=CARD)
        _load_state(sc, init)
        return sc

    with _deterministic(torch):
        exe, scope = fluid.Executor(), scope_from_init()
        record = _timed_runs(torch, exe)
        _free_device_memory(torch)
        kernels.reset_launch_counts()
        t = time.perf_counter()
        out = exe.train_from_dataset(main, ds, scope=scope, thread=2, fetch_list=[loss, prob])
        stats["epoch_s"] = time.perf_counter() - t
        stats["launches"] = kernels.launch_counts()
        stats["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        stats["cache"] = exe.jit_cache_stats()
        del exe.run  # the class's run again
        losses = [float(o[0]) for o in out]
        step_s = [r[0] for r in record]
        stats["feed_devices"] = sorted({d for r in record for d in r[1]})
        stats["losses"] = losses
        stats["step_s"] = step_s
        stats["eager_first_step_ms"], stats["capture_step_ms"] = 1e3 * step_s[0], 1e3 * step_s[1]
        med = statistics.median(step_s[2:])
        stats["step_ms_median"] = 1e3 * med
        stats["examples_per_s"] = DEEPFM_BATCH / med
        auc = fluid.metrics.Auc("auc")
        for o, b in zip(out, batches):
            auc.update(np.concatenate([1 - o[1], o[1]], axis=1), b["lbl"])
        stats["auc"] = float(auc.eval())
        # a hand loop over the same batches, and bench_deepfm.py's regime
        hand_exe, hand_scope = fluid.Executor(), scope_from_init()
        hand = [float(hand_exe.run(main, feed=b, fetch_list=[loss], scope=hand_scope)[0])
                for b in batches]
        stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
        chunk_exe, chunk_scope = fluid.Executor(), scope_from_init()
        chunk_last = float(chunk_exe.run(main, feed=stacked, fetch_list=[loss], scope=chunk_scope,
                                         steps=DEEPFM_BATCHES, per_step_feed=True)[0])
        stats["hand_loop_bit_equal"] = [np.float32(a).tobytes() == np.float32(b).tobytes()
                                        for a, b in zip(losses, hand)]
        stats["steps16_last_loss"] = chunk_last
        stats["steps16_bit_equal"] = np.float32(chunk_last).tobytes() == np.float32(
            losses[-1]).tobytes()
        stats["steps16_state_differs"] = _differing(torch, scope, chunk_scope, sorted(scope.vars))
        stats["hand_state_differs"] = _differing(torch, scope, hand_scope, sorted(scope.vars))
        hand_exe.close()
        chunk_exe.close()
        del hand_scope, chunk_scope, stacked

    def step():
        return exe.run(main, feed=batches[0], fetch_list=[loss], scope=scope)

    prof = _profile_step(torch, step, all_kernels=True)
    if prof is not None:
        prof["kernel_classes"] = _kernel_classes(prof, DEEPFM_KERNEL_CLASSES)
        del prof["all_kernels"]
        # the profiler's own host cost stretches the profiled step: the
        # idle share against the unprofiled median step
        stats["device_idle_share"] = 1 - prof["device_ms"] / stats["step_ms_median"]
    stats["profile"] = prof
    stats["graph_pool_bytes"] = exe.jit_cache_stats()["graph_pool_bytes"]
    exe.close()

    def eager_step():
        return exe.run(main, feed=batches[1], fetch_list=[loss], scope=scope,
                       use_program_cache=False)

    torch.cuda.synchronize()
    t = time.perf_counter()
    eager_step()
    torch.cuda.synchronize()
    stats["eager_step_ms"] = 1e3 * (time.perf_counter() - t)
    stats["eager_op_breakdown"] = _op_breakdown(torch, eager_step)
    # one step's Adam update of the FM table against float64 numpy
    ops = _update_ops(main, ["deepfm_fm_emb"])
    grad = "deepfm_fm_emb@GRAD"
    before = _adam_state(scope, ops)
    _, g = exe.run(main, feed=batches[2], fetch_list=[loss, grad], scope=scope,
                   use_program_cache=False)
    stats["adam_err"] = _adam_errors(ops, before, _adam_state(scope, ops), {"deepfm_fm_emb": g})
    del before, g
    stats["cpu_check"] = _deepfm_against_cpu(torch, fluid, main, scope, batches[3], loss, grad)
    log("[deepfm-hbm]", json.dumps(stats))
    ok = (all(np.isfinite(losses)) and len(losses) == DEEPFM_BATCHES
          and stats["cache"]["graphs"] == 1 and stats["feed_devices"] == [CARD]
          and all(stats["hand_loop_bit_equal"]) and stats["steps16_bit_equal"]
          and not stats["steps16_state_differs"] and not stats["hand_state_differs"]
          and all(e["param_in_lr"] <= ADAM_TOL and e["moment1"] <= ADAM_TOL
                  and e["moment2"] <= ADAM_TOL for e in stats["adam_err"].values())
          and stats["cpu_check"]["ok"] and not stats["launches"])
    if not ok:
        raise AssertionError("DeepFM HBM phase failed: %s" % {
            k: stats[k] for k in ("losses", "cache", "feed_devices", "hand_loop_bit_equal",
                                  "steps16_bit_equal", "steps16_state_differs",
                                  "hand_state_differs", "adam_err", "cpu_check", "launches")})
    return stats, batches


def _deepfm_against_cpu(torch, fluid, main, scope, batch, loss, grad):
    """Two steps at DEEPFM_CHECK_BATCH rows from the card's state, on the
    card (eager) and on the CPU: losses and the FM table's first gradient
    within DEEPFM_CPU_TOL relative."""
    from paddle_tpu_torch.scope import to_numpy

    feed = {k: v[:DEEPFM_CHECK_BATCH] for k, v in batch.items()}
    init = {n: to_numpy(v) for n, v in scope.vars.items()}
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    fluid.io.set_params_from_numpy(card_scope, init, CARD)
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    fluid.io.set_params_from_numpy(cpu_scope, init, "cpu")
    del init
    card, cpu = [], []
    for _ in range(2):
        card.append(card_exe.run(main, feed=feed, fetch_list=[loss, grad], scope=card_scope))
        cpu.append(cpu_exe.run(main, feed=feed, fetch_list=[loss, grad], scope=cpu_scope))
    out = {"batch": DEEPFM_CHECK_BATCH, "tol": DEEPFM_CPU_TOL,
           "loss_card": [float(c[0]) for c in card], "loss_cpu": [float(c[0]) for c in cpu],
           "loss_rel": [_max_rel(a[0], b[0]) for a, b in zip(card, cpu)],
           "fm_grad_rel": _max_rel(card[0][1], cpu[0][1])}
    out["ok"] = max(out["loss_rel"] + [out["fm_grad_rel"]]) <= DEEPFM_CPU_TOL
    card_exe.close()
    return out


def _ps_pair():
    from paddle_tpu_torch.distributed import ParameterServer

    return [ParameterServer().start(), ParameterServer().start()]


def _phase_timers(exe):
    """Wrap the executor's prefetch and push: host seconds per call."""
    rec = {"pull_s": [], "push_s": [], "uniq": []}
    pull, push = exe._prefetch_distributed_tables, exe._push_sparse

    def timed_pull(program, feed):
        t = time.perf_counter()
        out = pull(program, feed)
        rec["pull_s"].append(time.perf_counter() - t)
        return out

    def timed_push(program, ps_push, grads):
        t = time.perf_counter()
        push(program, ps_push, grads)
        rec["push_s"].append(time.perf_counter() - t)
        rec.setdefault("pushes", []).extend(
            (table, uniq, g.copy()) for (table, uniq, _), g in zip(ps_push, grads))

    exe._prefetch_distributed_tables, exe._push_sparse = timed_pull, timed_push
    return rec


def run_deepfm_ps(torch, batches):
    """Phase 23 (see the module docstring)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    stats = {"steps": PS_STEPS, "lr": PS_LR, "allocated_before_bytes": _free_device_memory(torch)}
    feeds = batches[:PS_STEPS]
    # HBM, SGD, zero tables
    main, startup, loss, _, _ = deepfm_program(fluid, opt="sgd", lr=PS_LR)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    for n in ("deepfm_w1_emb", "deepfm_fm_emb"):
        scope.vars[n].zero_()
    dense_init = {n: to_numpy(v) for n, v in scope.vars.items() if not n.endswith("_emb")}
    hbm = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]) for f in feeds]
    exe.close()
    del scope
    # the same on two servers, sync
    servers = _ps_pair()
    try:
        pmain, _, ploss, _, _ = deepfm_program(fluid, distributed=True, opt="sgd", lr=PS_LR)
        client = fluid.distributed.bind_distributed_tables(
            pmain, [s.endpoint for s in servers], optimizer="sgd", lr=PS_LR, initializer="zeros")
        pexe, pscope = fluid.Executor(), fluid.Scope()
        fluid.io.set_params_from_numpy(pscope, dense_init, CARD)
        rec = _phase_timers(pexe)
        sync, run_s = [], []
        for f in feeds:
            torch.cuda.synchronize()
            t = time.perf_counter()
            sync.append(float(pexe.run(pmain, feed=dict(f), fetch_list=[ploss], scope=pscope)[0]))
            run_s.append(time.perf_counter() - t)
        stats["sync"] = {
            "losses": sync, "hbm_losses": hbm,
            "max_rel": max(abs(a - b) / abs(b) for a, b in zip(sync, hbm)),
            "run_s": run_s, "pull_s": rec["pull_s"], "push_s": rec["push_s"],
            "device_and_host_step_s": [r - a - b for r, a, b in zip(run_s, rec["pull_s"],
                                                                   rec["push_s"])],
            "uniq_hist": dict(pmain._uniq_id_hist),
            "buckets": sorted({fluid.executor.pow2_id_bucket(n) for n in pmain._uniq_id_hist}),
            "server_rows": [s._dispatch({"op": "stats"}) for s in servers],
            "cache": pexe.jit_cache_stats()}
        pexe.close()
        client.close()
    finally:
        for s in servers:
            s.stop()
    # async: a DownpourSGD trainer, the overlapped prefetch, one batch PS_STEPS times
    servers = _ps_pair()
    try:
        amain, astartup, aloss, _, _ = deepfm_program(fluid, distributed=True, opt="sgd",
                                                      lr=PS_LR)
        fluid.distributed.bind_distributed_tables(
            amain, [s.endpoint for s in servers], optimizer="sgd", lr=PS_LR, seed=SEED)
        trainer = fluid.TrainerFactory().create_trainer(
            {"trainer": "DistMultiTrainer", "device_worker": "DownpourSGD"})
        trainer.set_fetch_var_and_info([aloss], ["loss"], 1)
        aexe, ascope = fluid.Executor(), fluid.Scope()
        aexe.run(astartup, scope=ascope)
        rec = _phase_timers(aexe)
        expand, ids_kinds = aexe._sparse_expand_ids, set()

        def spied_expand(meta, ids_val, ladder=None):  # where each batch's ids lie
            ids_kinds.add(type(ids_val).__name__)
            return expand(meta, ids_val, ladder)

        aexe._sparse_expand_ids = spied_expand
        initial = {}  # every table row the epoch pulls, before any push
        for meta in amain._distributed_tables.values():
            uniq = np.unique(feeds[0]["ids"])
            initial[meta["table"]] = (uniq, amain._ps_client.pull_sparse(meta["table"], uniq))
        t = time.perf_counter()
        out = aexe.train_from_dataset(amain, [dict(feeds[0]) for _ in range(PS_STEPS)],
                                      scope=ascope, thread=2, trainer_desc=trainer)
        epoch_s = time.perf_counter() - t
        comm = amain._ps_communicator
        t = time.perf_counter()
        comm.flush()
        flush_s = time.perf_counter() - t
        # every push of the epoch, replayed in float64 on the rows first pulled
        errs = {}
        for table, (uniq, rows0) in initial.items():
            want = rows0.astype(np.float64)
            for tname, ids, g in rec["pushes"]:
                if tname == table:
                    np.subtract.at(want, np.searchsorted(uniq, ids), PS_LR * g.astype(np.float64))
            errs[table] = _max_rel(amain._ps_client.pull_sparse(table, uniq), want)
        losses = [float(o[0]) for o in out]
        stats["async"] = {
            "losses": losses, "epoch_s": epoch_s, "flush_s": flush_s,
            "pending_after_flush": comm.pending(), "dropped": comm.dropped,
            "server_vs_float64_replay": errs, "thread": 2, "ids_kinds": sorted(ids_kinds),
            "pull_s": rec["pull_s"], "push_enqueue_s": rec["push_s"],
            "cache": aexe.jit_cache_stats()}
        comm.stop()
        aexe.close()
    finally:
        for s in servers:
            s.stop()
    log("[deepfm-ps]", json.dumps(stats))
    a = stats["async"]
    ok = (stats["sync"]["max_rel"] <= PS_SYNC_RTOL and all(np.isfinite(stats["sync"]["losses"]))
          and a["losses"][-1] < a["losses"][0] and a["pending_after_flush"] == 0
          and a["dropped"] == 0 and max(a["server_vs_float64_replay"].values()) <= PS_REPLAY_TOL
          and a["ids_kinds"] == ["ndarray"]
          and a["cache"]["ps_pull_overlap_s"] + a["cache"]["ps_pull_wait_s"] > 0)
    if not ok:
        raise AssertionError("DeepFM PS phase failed: %s" % stats)
    return stats


def run_geo_and_descriptors(torch):
    """Phase 24 (see the module docstring)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import GeoSGD, ParameterServer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [64])
        y = fluid.layers.data("y", [1])
        loss = fluid.layers.mean(fluid.layers.square_error_cost(
            fluid.layers.fc(fluid.layers.fc(x, 256, act="relu"), 1), y))
        fluid.optimizer.SGDOptimizer(0.05).minimize(loss)
    server = ParameterServer().start()
    stats = {"sync_every": GEO_SYNC_EVERY}
    try:
        exe, scope = fluid.Executor(), fluid.Scope()
        exe.run(startup, scope=scope)
        geo = GeoSGD(main, scope, [server.endpoint], sync_every=GEO_SYNC_EVERY).init_worker()
        rng = np.random.RandomState(SEED)
        feeds = [{"x": rng.randn(128, 64).astype("float32"),
                  "y": rng.randn(128, 1).astype("float32")} for _ in range(5)]
        synced = []
        for f in feeds[:4]:  # eager, captured, replays; syncs after steps 2 and 4
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            synced.append(geo.step())
        params = [p.name for p in main.all_parameters()]
        stats["synced"] = synced
        stats["param_devices"] = sorted({str(scope.vars[n].device) for n in params})
        with _deterministic(torch):
            ref_scope = fluid.Scope(device=CARD)
            _load_state(ref_scope, scope.vars)
            got = exe.run(main, feed=feeds[4], fetch_list=[loss], scope=scope)[0]
            ref = fluid.Executor().run(main, feed=feeds[4], fetch_list=[loss], scope=ref_scope,
                                       use_program_cache=False)[0]
        stats["loss"] = float(got)
        stats["bit_equal_to_eager"] = got.tobytes() == ref.tobytes()
        stats["cache"] = exe.jit_cache_stats()
        exe.close()
    finally:
        server.stop()
    trainer = fluid.TrainerFactory().create_trainer(
        {"trainer": "DistMultiTrainer", "device_worker": "DownpourSGD"})
    try:
        fluid.Executor().train_from_dataset(main, [], trainer_desc=trainer)
        stats["downpour_refused"] = None
    except ValueError as e:
        stats["downpour_refused"] = str(e)
    log("[geo-descriptors]", json.dumps(stats))
    if not (stats["synced"] == [False, True, False, True] and stats["param_devices"] == [CARD]
            and stats["bit_equal_to_eager"] and stats["cache"]["graphs"] == 1
            and stats["downpour_refused"]):
        raise AssertionError("GeoSGD / trainer descriptor phase failed: %s" % stats)
    return stats


# ---------------------------------------------------------------------------
# phases 25 to 27: Transformer NMT, decoding, the book's RNN translation models
# ---------------------------------------------------------------------------
def _hand_kernel_launches():
    """The launch count of each of the four hand kernels since the last reset."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import fused_attention as fa

    counts = kernels.launch_counts()
    return {k: counts.get(k, 0) for k in (fa.KERNEL_NAME, fa.BWD_DKV_NAME, fa.BWD_DQ_NAME,
                                          "dropout")}


def _no_hand_kernel(what, launches):
    if any(launches.values()):
        raise AssertionError("%s launched a hand kernel: %s" % (what, launches))


def nmt_program(fluid, amp=True, train=True, rows_cut=None):
    """transformer_nmt as bench_nmt.py builds it (NMT's widths, dropout 0):
    with ``train`` the loss under ``AdamOptimizer(1e-4)`` (decorated for
    bf16 AMP with ``amp``), else the logits-only inference build.
    (main, startup, loss, logits, params_grads)."""
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import seq2seq

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    pg = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [NMT["src_len"]], dtype="int64")
        tgt = fluid.layers.data("tgt", [NMT["tgt_len"]], dtype="int64")
        lbl = fluid.layers.data("lbl", [NMT["tgt_len"], 1], dtype="int64") if train else None
        smask = fluid.layers.data("smask", [NMT["src_len"]])
        loss, logits = seq2seq.transformer_nmt(src, tgt, lbl, src_mask=smask, dropout_rate=0.0,
                                               is_test=not train, **NMT)
        if train:
            opt = fluid.optimizer.AdamOptimizer(NMT_LR)
            if amp:
                opt = mixed_precision.decorate(opt)
            _, pg = opt.minimize(loss)
    return main, startup, loss, logits, pg


def nmt_feed(rng, rows):
    """bench_nmt.py's feed: random ids, source lengths uniform in
    [src_len / 2, src_len] carried by ``smask``; (feed, real tokens)."""
    S, T, V = NMT["src_len"], NMT["tgt_len"], NMT["tgt_vocab"]
    lens = rng.randint(S // 2, S + 1, rows)
    feed = {"src": rng.randint(0, V, (rows, S)).astype("int64"),
            "tgt": rng.randint(0, V, (rows, T)).astype("int64"),
            "lbl": rng.randint(0, V, (rows, T, 1)).astype("int64"),
            "smask": (np.arange(S)[None, :] < lens[:, None]).astype("float32")}
    return feed, int(lens.sum()) + rows * T  # bench_nmt.py:115's count


def run_nmt_train(torch):
    """Phase 25: Transformer NMT trained at bench_nmt.py's widths and feed
    (batch 128, src/tgt 64, bf16 AMP, Adam 1e-4): eager, captured and
    NMT_STEPS replayed steps; step time, real and padded tokens/s, peak
    memory, graph pool, a profiled replay, an eager step's device time by
    op type; then, under deterministic algorithms, 3 captured steps bit
    for bit against 3 eager ones from one state.  No hand kernel runs.
    Returns (stats, the trained scope's tensors)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    stats = {"batch": NMT_BATCH, "allocated_before_bytes": _free_device_memory(torch)}
    main, startup, loss, _, pg = nmt_program(fluid)
    stats["ops"] = len(main.global_block().ops)
    stats["params"] = int(sum(np.prod(p.shape) for p, _ in pg))
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    init = _clone_state(scope)
    feed, real_tokens = nmt_feed(np.random.RandomState(SEED), NMT_BATCH)
    kernels.reset_launch_counts()  # counts from here on belong to the NMT training path
    outs, times, _ = _lm_steps(torch, exe, main, feed, [loss], scope, (), 2 + NMT_STEPS)
    launches = _hand_kernel_launches()  # read right after the training path
    losses = [float(o[0]) for o in outs]
    step_s = statistics.median(times[2:])
    padded = NMT_BATCH * (NMT["src_len"] + NMT["tgt_len"])
    stats.update(hand_kernel_launches=launches, losses=losses, step_s=times,
                 eager_first_step_ms=1e3 * times[0], capture_step_ms=1e3 * times[1],
                 step_ms_median=1e3 * step_s, real_tokens_per_step=real_tokens,
                 real_tokens_per_s=real_tokens / step_s, padded_tokens_per_s=padded / step_s,
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
    state = dict(scope.vars)  # the trained weights, for phase 26
    del scope
    stats["capture_check"] = _nmt_capture_check(torch, main, loss, init)
    del init
    log("[nmt-train]", json.dumps(stats))
    _no_hand_kernel("the NMT training path", launches)
    if stats["cache"]["graphs"] != 1:
        raise AssertionError("the NMT training step was not captured: %s" % stats["cache"])
    if not (np.isfinite(losses).all() and losses[-1] < losses[1]):
        raise AssertionError("NMT losses not finite or not falling: %s" % losses)
    if not stats["capture_check"]["bit_equal"]:
        raise AssertionError("captured and eager NMT steps differ: %s" % stats["capture_check"])
    return stats, state


def _nmt_capture_check(torch, main, loss, init):
    """NMT_CAPTURE_STEPS steps through the cached executor (warmed on a
    scope of its own, so captured, then replayed) against as many eager
    ones from the same state, each on a batch of its own, under
    deterministic algorithms: losses and every persistable bit-equal."""
    import paddle_tpu_torch as fluid

    feeds = [nmt_feed(np.random.RandomState(SEED + 40 + i), NMT_BATCH)[0]
             for i in range(NMT_CAPTURE_STEPS)]
    out = {}
    with _deterministic(torch):
        for name, cached in (("eager", False), ("captured", True)):
            exe, scope = fluid.Executor(), fluid.Scope()
            if cached:
                warm = fluid.Scope()
                _load_state(warm, init)
                exe.run(main, feed=feeds[0], fetch_list=[loss], scope=warm)
                del warm
            _load_state(scope, init)
            losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              use_program_cache=cached)[0] for f in feeds]
            out[name] = (losses, {n: v.clone() for n, v in scope.vars.items()},
                         exe.jit_cache_stats()["graphs"])
            exe.close()
            del scope
    (e_loss, e_state, _), (c_loss, c_state, graphs) = out["eager"], out["captured"]
    # a one-element state var may be [1] in one scope and [] in the other
    # (startup declares the beta pows [1], the update op writes []): compare values
    differing = [n for n in e_state
                 if not torch.equal(e_state[n].reshape(-1), c_state[n].reshape(-1))]
    return {"losses": {"eager": [float(v) for v in e_loss], "captured": [float(v) for v in c_loss]},
            "graphs": graphs, "differing_persistables": differing[:8],
            "bit_equal": (graphs == 1 and not differing
                          and all(a.tobytes() == b.tobytes() for a, b in zip(e_loss, c_loss)))}


def check_nmt_against_cpu(amp):
    """Phase 25's step at NMT_CHECK_BATCH (captured: its entry warmed on a
    scope of its own first) and on the CPU from the same state: the loss
    and the gradients of NMT_CHECK_GRADS within TRAIN_TOL in fp32, within
    AMP_TOL in bf16 AMP, relative to the CPU's largest magnitude."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    main, startup, loss, _, pg = nmt_program(fluid, amp=amp)
    grads = {p.name: g.name for p, g in pg}
    fetch = [loss.name] + [grads[n] for n in NMT_CHECK_GRADS]
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    fluid.io.set_params_from_numpy(cpu_scope, {n: to_numpy(v) for n, v in card_scope.vars.items()},
                                   "cpu")
    feed, _ = nmt_feed(np.random.RandomState(SEED + 2), NMT_CHECK_BATCH)
    warm = fluid.Scope()
    _load_state(warm, card_scope.vars)
    card_exe.run(main, feed=feed, fetch_list=fetch, scope=warm)
    del warm
    card = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    cpu = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    loss_tol, grad_tol = AMP_TOL if amp else (TRAIN_TOL, TRAIN_TOL)
    stats = {"amp": amp, "batch": NMT_CHECK_BATCH, "tol": [loss_tol, grad_tol],
             "loss": [float(card[0]), float(cpu[0])], "rel_err": {},
             "graphs": card_exe.jit_cache_stats()["graphs"]}
    ok = stats["graphs"] == 1
    for name, a, b in zip(["loss"] + NMT_CHECK_GRADS, card, cpu):
        rel = _max_rel(a, b)
        stats["rel_err"][name] = rel
        ok = ok and bool(np.isfinite(a).all()) and rel <= (loss_tol if name == "loss" else grad_tol)
    card_exe.close()
    log("[nmt-check-amp]" if amp else "[nmt-check]", json.dumps(stats))
    if not ok:
        raise AssertionError("card and CPU NMT steps differ: %s" % stats)
    return stats


class _record_top_k:
    """Record, at each step of a decode on the CPU, each source's smallest
    gap between adjacent scores among its K + 1 best candidates: where it
    is below the card/CPU difference, the two may pick differently.  For
    greedy search that is the top-2 log-prob margin."""

    def __init__(self):
        self.margins = []  # a [sources] array a step

    def __enter__(self):
        from paddle_tpu_torch import decoding

        self.common = decoding.common
        self.orig = self.common.top_k

        def top_k(x, k):
            vals = x.sort(dim=-1, descending=True).values[..., : k + 1]
            self.margins.append((vals[..., :-1] - vals[..., 1:]).amin(-1).numpy())
            return self.orig(x, k)

        self.common.top_k = top_k
        return self

    def __exit__(self, *exc):
        self.common.top_k = self.orig


def _same_until_tie(card, cpu, margins, tol=DECODE_TIE_MARGIN):
    """Each source's tokens on the card against the CPU's, position by
    position, up to the first step whose CPU margin for that source is
    below ``tol`` (the token of step i sits at position i + 1)."""
    m = np.stack(margins)  # [steps, sources]
    T = card.shape[-1]
    first = [next((i + 1 for i in range(m.shape[0]) if m[i, b] < tol), T)
             for b in range(m.shape[1])]
    return {"first_tie_position_by_source": first,
            "sources_without_tie": sum(f == T for f in first),
            "equal_before_tie": all(bool((card[b, ..., :f] == cpu[b, ..., :f]).all())
                                    for b, f in enumerate(first)),
            "equal_throughout": bool((card == cpu).all()),
            "smallest_margin": float(m.min())}


def run_nmt_decode(torch, state):
    """Phase 26: greedy and beam search (beam DECODE_BEAM, max_len 64) of
    phase 25's trained NMT (its fp32 master weights) over DECODE_SOURCES
    sources, full prefix through ``make_program_logits_fn``; each source's
    tokens against the CPU's, equal up to the first step where the CPU's
    margin for that source is below DECODE_TIE_MARGIN; a profiled greedy
    decode (the card's idle share);
    then the cached LM decode at transformer_lm's defaults against its
    full-prefix decode on the same weights (teacher-forced logits within
    DECODE_LOGIT_TOL), and ms per generated token of each."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import decoding

    _free_device_memory(torch)
    main, _, _, logits, _ = nmt_program(fluid, train=False)
    names = [v.name for v in main.list_vars() if v.persistable]
    weights = {n: state[n] for n in names}
    fn = decoding.make_program_logits_fn(main, weights, ["src", "tgt", "smask"], logits.name)
    feed, _ = nmt_feed(np.random.RandomState(SEED + 60), DECODE_SOURCES)
    src, smask = feed["src"], feed["smask"]
    stats = {"sources": DECODE_SOURCES, "beam": DECODE_BEAM, "max_len": NMT["tgt_len"],
             "logits_fn_device": str(fn.device)}
    from paddle_tpu_torch import kernels

    kernels.reset_launch_counts()  # counts from here on belong to the decode paths
    out = {}
    for name, beam in (("greedy", 1), ("beam", DECODE_BEAM)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if beam == 1:
            toks, scores = decoding.greedy_search(fn, src, BOS, EOS, max_len=NMT["tgt_len"],
                                                  extra_feeds={"smask": smask})
        else:
            toks, scores = decoding.beam_search(fn, src, BOS, EOS, beam_size=beam,
                                                max_len=NMT["tgt_len"],
                                                extra_feeds={"smask": smask})
        toks, scores = toks.cpu().numpy(), scores.cpu().numpy()  # the one read of the loop
        dt = time.perf_counter() - t
        steps = NMT["tgt_len"] - 1
        out[name] = (toks, scores)
        stats[name] = {"s": dt, "ms_per_step": 1e3 * dt / steps,
                       "ms_per_generated_token": 1e3 * dt / (steps * DECODE_SOURCES * beam),
                       "finite": bool(np.isfinite(scores).all()),
                       "shape": list(toks.shape)}
    cpu_fn = decoding.make_program_logits_fn(main, {n: v.cpu() for n, v in weights.items()},
                                             ["src", "tgt", "smask"], logits.name,
                                             place=fluid.CPUPlace())
    for name, beam in (("greedy", 1), ("beam", DECODE_BEAM)):
        t = time.perf_counter()
        with _record_top_k() as rec:
            toks, _ = decoding.beam_search(cpu_fn, torch.from_numpy(src), BOS, EOS,
                                           beam_size=beam, max_len=NMT["tgt_len"],
                                           extra_feeds={"smask": smask})
        if beam == 1:
            toks = toks[:, 0]
        stats[name]["against_cpu"] = dict(_same_until_tie(out[name][0], toks.numpy(), rec.margins),
                                          cpu_s=time.perf_counter() - t)
    prof = _profile_step(torch, lambda: decoding.greedy_search(
        fn, src, BOS, EOS, max_len=NMT["tgt_len"], extra_feeds={"smask": smask})[0].cpu())
    stats["greedy"]["profile"] = prof and {k: prof[k] for k in (
        "step_ms", "device_ms", "device_idle_share", "launches")}
    stats["lm_cached"] = _lm_cached_decode(torch)
    stats["hand_kernel_launches"] = _hand_kernel_launches()
    log("[nmt-decode]", json.dumps(stats))
    _no_hand_kernel("the decode paths", stats["hand_kernel_launches"])
    g, b = out["greedy"], out["beam"]
    if not (stats["greedy"]["finite"] and stats["beam"]["finite"]
            and g[0].shape == (DECODE_SOURCES, NMT["tgt_len"])
            and b[0].shape == (DECODE_SOURCES, DECODE_BEAM, NMT["tgt_len"])
            and (g[0][:, 0] == BOS).all() and (np.diff(b[1], axis=1) <= 1e-6).all()):
        raise AssertionError("bad NMT decode: %s" % stats)
    if not all(stats[n]["against_cpu"]["equal_before_tie"] for n in ("greedy", "beam")):
        raise AssertionError("card and CPU decodes differ before a tie: %s" % stats)
    lm = stats["lm_cached"]
    if not lm["teacher_forced_rel_err"] <= DECODE_LOGIT_TOL:
        raise AssertionError("cached and full-prefix LM logits differ: %s" % lm)
    return stats


def _lm_cached_decode(torch):
    """transformer_lm at its defaults (unfused, inference) with
    random_transformer_lm_state's weights: the cached step's logits at each
    of DECODE_LM_LEN positions of a fixed sequence against the full
    program's (teacher forcing); greedy and beam decodes both ways (whether
    their tokens are equal is printed: random weights leave near ties), and
    ms per generated token of each."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import decoding
    from paddle_tpu_torch.models import transformer

    dims = dict(vocab=LM["vocab_size"], d_model=LM["d_model"], n_layer=LM["n_layer"],
                n_head=LM["n_head"], d_inner=LM["d_inner"])
    state = decoding.random_transformer_lm_state(np.random.RandomState(SEED + 61),
                                                 max_pos=LM["max_pos"], **dims)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data("src", [DECODE_LM_LEN], dtype="int64")
        _, logits = transformer.transformer_lm(ids, None, dropout_rate=0.0, is_test=True,
                                               fused_attention=False,
                                               **dict(LM, seq_len=DECODE_LM_LEN))
    pfn = decoding.make_program_logits_fn(main, state, ["src"], logits.name)
    step_fn, make_cache = decoding.make_transformer_lm_step_fn(state, *dims.values(),
                                                               DECODE_LM_LEN)
    rows = DECODE_SOURCES
    toks = torch.from_numpy(np.random.RandomState(SEED + 62).randint(
        0, LM["vocab_size"], (rows, DECODE_LM_LEN))).to(pfn.device)
    full = pfn({"src": toks})
    cache, worst = make_cache(rows), 0.0
    for t in range(DECODE_LM_LEN):
        step_logits, cache = step_fn(cache, toks[:, t], t)
        worst = max(worst, float((step_logits - full[:, t]).abs().max()))
    scale = max(float(full.abs().max()), 1.0)
    out = {"rows": rows, "len": DECODE_LM_LEN, "teacher_forced_max_abs": worst,
           "teacher_forced_rel_err": worst / scale, "logit_max_abs": scale}

    def full_fn(feeds):
        return pfn({"src": feeds["tgt"]})

    src = torch.zeros((rows, 1), dtype=torch.int64, device=pfn.device)
    res = {}
    for name, beam in (("greedy", 1), ("beam", DECODE_BEAM)):
        for path in ("full_prefix", "cached"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if path == "full_prefix":
                tk, _ = decoding.beam_search(full_fn, src, BOS, EOS, beam_size=beam,
                                             max_len=DECODE_LM_LEN)
            else:
                tk, _ = decoding.beam_search_cached(step_fn, make_cache(rows * beam), rows, BOS,
                                                    EOS, beam_size=beam, max_len=DECODE_LM_LEN)
            tk = tk.cpu().numpy()
            dt = time.perf_counter() - t
            res[(name, path)] = tk
            out["%s_%s_ms_per_generated_token" % (name, path)] = \
                1e3 * dt / ((DECODE_LM_LEN - 1) * rows * beam)
            out["%s_%s_ms_per_step" % (name, path)] = 1e3 * dt / (DECODE_LM_LEN - 1)
    out["tokens_equal"] = all((res[(n, "full_prefix")] == res[(n, "cached")]).all()
                              for n in ("greedy", "beam"))
    return out


def _book_mt_encoder(fluid, src, src_len):
    emb = fluid.layers.embedding(src, size=[BOOK["dict"], BOOK["word"]],
                                 param_attr=fluid.ParamAttr(name="mt_vemb"))
    fc1 = fluid.layers.fc(emb, BOOK["hidden"] * 4, num_flatten_dims=2, act="tanh",
                          param_attr=fluid.ParamAttr(name="mt_enc_fc"))
    hidden, _ = fluid.layers.dynamic_lstm(fc1, size=BOOK["hidden"] * 4, seq_len=src_len,
                                          param_attr=fluid.ParamAttr(name="mt_enc_lstm"))
    return fluid.layers.sequence_last_step(hidden, seq_len=src_len)


def _book_mt_step(fluid, word_emb, state):
    cur = fluid.layers.fc([word_emb, state], BOOK["hidden"], act="tanh",
                          param_attr=[fluid.ParamAttr(name="mt_dec_word_fc"),
                                      fluid.ParamAttr(name="mt_dec_state_fc")])
    logits = fluid.layers.fc(cur, BOOK["dict"], param_attr=fluid.ParamAttr(name="mt_dec_score_fc"))
    return cur, logits


def book_mt_train(fluid):
    """tests/book/test_machine_translation.py's training program at the
    book's widths: a dynamic_lstm encoder and a DynamicRNN decoder, Adam."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [BOOK["src_len"]], dtype="int64", lod_level=1)
        src_len = main.global_block().var("src_seq_len")
        trg = fluid.layers.data("trg", [BOOK["trg_len"]], dtype="int64")
        nxt = fluid.layers.data("nxt", [BOOK["trg_len"], 1], dtype="int64")
        context = _book_mt_encoder(fluid, src, src_len)
        trg_emb = fluid.layers.embedding(trg, size=[BOOK["dict"], BOOK["word"]],
                                         param_attr=fluid.ParamAttr(name="mt_vemb_t"))
        trg_len = fluid.layers.fill_constant_batch_size_like(context, shape=[-1], dtype="int32",
                                                             value=BOOK["trg_len"])
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(trg_emb, seq_len=trg_len)
            pre_state = rnn.memory(init=context)
            cur_state, logits = _book_mt_step(fluid, word, pre_state)
            rnn.update_memory(pre_state, cur_state)
            rnn.output(logits)
        loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(rnn(), nxt))
        fluid.optimizer.AdamOptimizer(BOOK["lr"]).minimize(loss)
    return main, startup, loss


def book_red_train(fluid):
    """tests/book/test_rnn_encoder_decoder.py's program at the book's
    widths: a bi-LSTM encoder, a DynamicRNN decoder over a hand-written
    LSTM step with a static context, Adagrad."""
    H, dec = BOOK["hidden"], BOOK["hidden"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [BOOK["src_len"]], dtype="int64", lod_level=1)
        src_len = main.global_block().var("src_seq_len")
        trg = fluid.layers.data("trg", [BOOK["trg_len"]], dtype="int64")
        nxt = fluid.layers.data("nxt", [BOOK["trg_len"], 1], dtype="int64")
        emb = fluid.layers.embedding(src, size=[BOOK["dict"], BOOK["word"]])
        fwd, _ = fluid.layers.dynamic_lstm(fluid.layers.fc(emb, H * 4, num_flatten_dims=2),
                                           size=H * 4, seq_len=src_len)
        bwd, _ = fluid.layers.dynamic_lstm(fluid.layers.fc(emb, H * 4, num_flatten_dims=2),
                                           size=H * 4, is_reverse=True, seq_len=src_len)
        encoded = fluid.layers.concat([fluid.layers.sequence_last_step(fwd, seq_len=src_len),
                                       fluid.layers.sequence_first_step(bwd, seq_len=src_len)],
                                      axis=1)
        boot = fluid.layers.fc(encoded, dec, act="tanh", bias_attr=False)
        context = fluid.layers.fc(encoded, dec, bias_attr=False)
        trg_emb = fluid.layers.embedding(trg, size=[BOOK["dict"], BOOK["word"]])
        cell_init = fluid.layers.fill_constant_batch_size_like(boot, shape=[-1, dec],
                                                               dtype="float32", value=0.0)
        cell_init.stop_gradient = False
        trg_len = fluid.layers.fill_constant_batch_size_like(boot, shape=[-1], dtype="int32",
                                                             value=BOOK["trg_len"])
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            word = rnn.step_input(trg_emb, seq_len=trg_len)
            ctx = rnn.static_input(context)
            h_mem = rnn.memory(init=boot, need_reorder=True)
            c_mem = rnn.memory(init=cell_init)
            x_t = fluid.layers.concat([ctx, word], axis=1)
            gates = [fluid.layers.fc([h_mem, x_t], dec) for _ in range(4)]
            f, i, o = (fluid.layers.sigmoid(g) for g in gates[:3])
            c = fluid.layers.sums([fluid.layers.elementwise_mul(f, c_mem),
                                   fluid.layers.elementwise_mul(i, fluid.layers.tanh(gates[3]))])
            h = fluid.layers.elementwise_mul(o, fluid.layers.tanh(c))
            rnn.update_memory(h_mem, h)
            rnn.update_memory(c_mem, c)
            rnn.output(fluid.layers.fc(h, BOOK["dict"], act="softmax"))
        loss = fluid.layers.mean(fluid.layers.cross_entropy(
            fluid.layers.reshape(rnn(), shape=[-1, BOOK["dict"]]),
            fluid.layers.reshape(nxt, shape=[-1, 1])))
        fluid.optimizer.AdagradOptimizer(BOOK["lr"]).minimize(loss)
    return main, startup, loss


def book_train_feed(rng):
    B, S, T, V = BOOK["batch"], BOOK["src_len"], BOOK["trg_len"], BOOK["dict"]
    trg = rng.randint(3, V, (B, T)).astype("int64")
    trg[:, 0] = BOS
    return {"src": rng.randint(3, V, (B, S)).astype("int64"),
            "src_seq_len": rng.randint(S // 4, S + 1, (B,)).astype("int32"),
            "trg": trg, "nxt": ((trg * 7 + 3) % V)[:, :, None].astype("int64")}


def book_mt_decode(fluid, bounded=True):
    """The book's beam decode (tests/book/test_machine_translation.py) at
    the book's widths: tensor arrays, per-step ``beam_search`` and the
    parent gather inside ``While(max_trip_count=...)`` (or an unbounded
    ``While`` with ``bounded=False``), ``beam_search_decode`` after it."""
    B, K, H, L = BOOK["batch"], BOOK["beam"], BOOK["hidden"], BOOK["max_len"]
    BK = B * K
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        src = fluid.layers.data("src", [BOOK["src_len"]], dtype="int64", lod_level=1)
        src_len = main.global_block().var("src_seq_len")
        init_ids = fluid.layers.data("init_ids", [1], dtype="int64")
        init_scores = fluid.layers.data("init_scores", [1])
        context = _book_mt_encoder(fluid, src, src_len)
        state0 = fluid.layers.reshape(fluid.layers.expand(
            fluid.layers.reshape(context, shape=[-1, 1, H]), [1, K, 1]), shape=[BK, H])
        counter = fluid.layers.zeros(shape=[1], dtype="int64")
        array_len = fluid.layers.fill_constant([1], "int64", L)
        state_arr = fluid.layers.create_array(L + 1, [BK, H])
        ids_arr = fluid.layers.create_array(L + 1, [BK, 1], "int64")
        score_arr = fluid.layers.create_array(L + 1, [BK, 1])
        parent_arr = fluid.layers.create_array(L + 1, [BK], "int32")
        state_arr = fluid.layers.array_write(state0, counter, state_arr)
        ids_arr = fluid.layers.array_write(fluid.layers.reshape(init_ids, shape=[BK, 1]), counter,
                                           ids_arr)
        score_arr = fluid.layers.array_write(fluid.layers.reshape(init_scores, shape=[BK, 1]),
                                             counter, score_arr)
        cond = fluid.layers.less_than(counter, array_len)
        loop = fluid.layers.While(cond, max_trip_count=L if bounded else None)
        with loop.block():
            pre_ids = fluid.layers.reshape(fluid.layers.array_read(ids_arr, counter),
                                           shape=[BK, 1])
            pre_state = fluid.layers.reshape(fluid.layers.array_read(state_arr, counter),
                                             shape=[BK, H])
            pre_score = fluid.layers.reshape(fluid.layers.array_read(score_arr, counter),
                                             shape=[BK, 1])
            emb = fluid.layers.reshape(fluid.layers.embedding(
                pre_ids, size=[BOOK["dict"], BOOK["word"]],
                param_attr=fluid.ParamAttr(name="mt_vemb_t")), shape=[BK, BOOK["word"]])
            cur_state, logits = _book_mt_step(fluid, emb, pre_state)
            top_sc, top_ix = fluid.layers.topk(fluid.layers.softmax(logits), k=K)
            accu = fluid.layers.elementwise_add(fluid.layers.log(top_sc), pre_score)
            sel_ids, sel_sc, parent = fluid.layers.beam_search(pre_ids, pre_score, top_ix, accu, K,
                                                               EOS, return_parent_idx=True)
            fluid.layers.increment(counter, value=1, in_place=True)
            fluid.layers.array_write(fluid.layers.gather(cur_state, parent), counter, state_arr)
            fluid.layers.array_write(sel_ids, counter, ids_arr)
            fluid.layers.array_write(sel_sc, counter, score_arr)
            fluid.layers.array_write(parent, counter, parent_arr)
            fluid.layers.less_than(counter, array_len, cond=cond)
        ids, scores = fluid.layers.beam_search_decode(ids_arr, score_arr, beam_size=K, end_id=EOS,
                                                      parents=parent_arr)
    return main, startup, ids, scores


def book_decode_feed(rng):
    B, K, S = BOOK["batch"], BOOK["beam"], BOOK["src_len"]
    return {"src": rng.randint(3, BOOK["dict"], (B, S)).astype("int64"),
            "src_seq_len": rng.randint(S // 4, S + 1, (B,)).astype("int32"),
            "init_ids": np.full((B * K, 1), BOS, "int64"),
            "init_scores": np.where(np.arange(B * K) % K == 0, 0.0, -1e9).astype(
                "float32").reshape(B * K, 1)}


def _timed(torch, fn, n):
    out, times = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out.append(fn())
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return out, times


def run_book_rnn(torch):
    """Phase 27: the Fluid book's two RNN translation models at the
    book's widths (BOOK), trained through the cached executor (captured)
    and held bit for bit, under deterministic algorithms, to eager steps
    from the same state; the ``While(max_trip_count=...)`` beam decode
    captured, its SentenceIds equal to the CPU's; the same decode with an
    unbounded ``While`` on the interpreter (no graph) giving the same
    SentenceIds.  Launch-bound widths: the times are printed, not judged."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    _free_device_memory(torch)
    kernels.reset_launch_counts()  # counts from here on belong to the book models
    stats = {"widths": BOOK}
    rng = np.random.RandomState(SEED + 70)
    feeds = [book_train_feed(rng) for _ in range(BOOK_STEPS)]
    for name, build in (("machine_translation", book_mt_train),
                        ("rnn_encoder_decoder", book_red_train)):
        main, startup, loss = build(fluid)
        boot_exe, boot = fluid.Executor(), fluid.Scope()
        boot_exe.run(startup, scope=boot)
        init = _clone_state(boot)
        del boot
        res = {}
        with _deterministic(torch):
            for path, cached in (("eager", False), ("captured", True)):
                exe, scope = fluid.Executor(), fluid.Scope()
                _load_state(scope, init)
                losses, times = [], []
                for f in feeds:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    losses.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                                          use_program_cache=cached)[0])
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t))
                res[path] = (losses, times, {n: v.clone() for n, v in scope.vars.items()},
                             exe.jit_cache_stats()["graphs"], None)
                if cached:  # one more replay under the profiler: idle share, kernel count
                    prof = _profile_step(torch, lambda: exe.run(main, feed=feeds[-1],
                                                                fetch_list=[loss], scope=scope))
                    res[path] = res[path][:4] + (prof,)
                exe.close()
        (e_l, e_t, e_s, _, _), (c_l, c_t, c_s, graphs, prof) = res["eager"], res["captured"]
        differing = [n for n in e_s if not torch.equal(e_s[n].reshape(-1), c_s[n].reshape(-1))]
        stats[name] = {"ops": len(main.global_block().ops), "graphs": graphs,
                       "losses": [float(v) for v in c_l],
                       "eager_step_ms": e_t, "captured_step_ms": c_t,
                       "replay_ms_median": statistics.median(c_t[2:]),
                       "eager_ms_median": statistics.median(e_t[1:]),
                       "bit_equal": not differing and all(
                           a.tobytes() == b.tobytes() for a, b in zip(e_l, c_l)),
                       "differing_persistables": differing[:8],
                       "profiled_replay": prof and {k: prof[k] for k in (
                           "step_ms", "device_ms", "device_idle_share", "launches",
                           "top_kernels")}}
    stats["decode"] = _book_decode(torch)
    stats["hand_kernel_launches"] = _hand_kernel_launches()
    log("[book-rnn]", json.dumps(stats))
    _no_hand_kernel("the book RNN models", stats["hand_kernel_launches"])
    for name in ("machine_translation", "rnn_encoder_decoder"):
        s = stats[name]
        if not (s["graphs"] == 1 and s["bit_equal"] and np.isfinite(s["losses"]).all()):
            raise AssertionError("%s: captured steps differ from eager or were not captured: %s"
                                 % (name, s))
    d = stats["decode"]
    if not (d["bounded"]["graphs"] == 1 and d["bounded"]["ids_equal_cpu"]
            and d["unbounded"]["graphs"] == 0 and d["unbounded"]["ids_equal_bounded"]):
        raise AssertionError("book beam decode: %s" % d)
    return stats


def _book_decode(torch):
    """The bounded decode through the cached executor (eager, captured, 3
    replays) against the CPU's, and the unbounded one on the interpreter."""
    import paddle_tpu_torch as fluid

    feed = book_decode_feed(np.random.RandomState(SEED + 71))
    out = {}
    init = None
    for name, bounded in (("bounded", True), ("unbounded", False)):
        main, startup, ids, scores = book_mt_decode(fluid, bounded)
        if init is None:
            boot_exe, boot = fluid.Executor(), fluid.Scope()
            boot_exe.run(startup, scope=boot)
            init = _clone_state(boot)
            del boot
        exe, scope = fluid.Executor(), fluid.Scope()
        _load_state(scope, init)
        res, times = _timed(torch, lambda: exe.run(main, feed=feed, fetch_list=[ids, scores],
                                                   scope=scope), 5)
        got = res[-1]
        row = {"graphs": exe.jit_cache_stats()["graphs"], "run_ms": times,
               "ops": [op.type for op in main.global_block().ops].count(
                   "bounded_while" if bounded else "while"),
               "all_runs_equal": all((r[0] == got[0]).all() for r in res),
               "shape": list(got[0].shape), "finite": bool(np.isfinite(got[1]).all())}
        if bounded:
            cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
            fluid.io.set_params_from_numpy(cpu_scope, {n: v.cpu().numpy() for n, v in init.items()},
                                           "cpu")
            cpu = cpu_exe.run(main, feed=feed, fetch_list=[ids, scores], scope=cpu_scope)
            row["ids_equal_cpu"] = bool((got[0] == cpu[0]).all())
            row["scores_max_abs_vs_cpu"] = float(np.abs(got[1] - cpu[1]).max())
            out["_ids"] = got[0]
        else:
            row["ids_equal_bounded"] = bool((got[0] == out["_ids"]).all())
        exe.close()
        out[name] = row
    del out["_ids"]
    return out


# ---------------------------------------------------------------------------
# phases 28 and 29: VGG-16 at ImageNet widths, and the core layers' op types
# ---------------------------------------------------------------------------
def vgg_program(fluid, hw, amp=True, is_test=False, dropout=True, lr=VGG_LR):
    """(main, startup, avg_loss, prediction, params_grads, reader) of
    VGG-16 (the JAX package's ``models/vgg.py``) at hw x hw, 1000 classes;
    in training under ``MomentumOptimizer(lr, 0.9)`` (``decorate``d for
    bf16 AMP with ``amp``), with an iterable ``PyReader`` over the image
    and label vars (``layers.create_py_reader_by_data``, double buffer)."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.contrib import mixed_precision

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    reader = params_grads = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data("img", [3, hw, hw])
        lbl = fluid.layers.data("lbl", [1], dtype="int64")
        loss, _, pred = models.vgg16(img, lbl, class_num=VGG_CLASSES, is_test=is_test,
                                     dropout=dropout)
        if not is_test:
            reader = fluid.layers.create_py_reader_by_data(
                capacity=VGG_READER_CAPACITY, feed_list=[img, lbl], use_double_buffer=True)
            opt = fluid.optimizer.MomentumOptimizer(learning_rate=lr, momentum=VGG_MU)
            if amp:
                opt = mixed_precision.decorate(opt)
            _, params_grads = opt.minimize(loss)
    return main, startup, loss, pred, params_grads, reader


def vgg_batches(rng, rows, n, hw):
    """``n`` batches of images uniform in [-1, 1) and labels, as numpy."""
    return [(rng.uniform(-1, 1, (rows, 3, hw, hw)).astype(np.float32),
             rng.randint(0, VGG_CLASSES, (rows, 1)).astype(np.int64)) for _ in range(n)]


def run_vgg_train(torch):
    """VGG-16 trained at ImageNet widths (224x224, 1000 classes, batch
    VGG_BATCH, bf16 AMP, Momentum 0.9 at VGG_LR, both dropouts), fed by the
    reader layer's iterable PyReader, which stages each batch on the card
    ahead of its step: the entry's eager step, its captured step and
    VGG_STEPS replays, each on a batch of its own; then one profiled
    replay.  Every loss finite, the step captured, the dropout kernel
    launched 4 times a step (two layers, each again in its vjp's
    recompute) and no attention kernel.  Returns the stats and the trained
    scope (the served model's weights)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    sync = torch.cuda.synchronize
    stats = {"batch": VGG_BATCH, "image": VGG_HW, "classes": VGG_CLASSES, "amp": True,
             "lr": VGG_LR, "allocated_before_bytes": _free_device_memory(torch)}
    main, startup, loss, _, _, reader = vgg_program(fluid, VGG_HW)
    ops = [op.type for op in main.global_block().ops]
    stats["ops"] = len(ops)
    stats["op_types"] = {t: ops.count(t) for t in sorted(set(ops))}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    n = 2 + VGG_STEPS
    batches = vgg_batches(np.random.RandomState(SEED + 28), VGG_BATCH, n + 1, VGG_HW)
    reader.decorate_batch_generator(lambda: iter(batches))  # staged on cuda:0
    feeds = reader()
    kernels.reset_launch_counts()  # counts from here on belong to the VGG-16 path
    losses, times = [], []
    try:
        for _ in range(n):
            feed = next(feeds)
            sync()
            t = time.perf_counter()
            l, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            sync()
            times.append(time.perf_counter() - t)
            losses.append(float(l))
        stats["launches"] = _hand_kernel_launches()  # read right after the VGG-16 path
        feed = next(feeds)
        prof = _profile_step(torch, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                                    scope=scope), all_kernels=True)
    finally:
        feeds.close()
    if prof is not None:
        prof["kernel_classes"] = _kernel_classes(prof)
        del prof["all_kernels"]
    stats["profile"] = prof
    stats["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    stats["cache"] = exe.jit_cache_stats()
    stats["losses"] = losses
    stats["step_s"] = times
    stats["eager_first_step_ms"], stats["capture_step_ms"] = 1e3 * times[0], 1e3 * times[1]
    step_s = statistics.median(times[2:])
    stats["step_ms_median"] = 1e3 * step_s
    stats["images_per_s"] = VGG_BATCH / step_s
    flops = 3 * VGG16_FWD_FLOPS_PER_IMG * VGG_BATCH  # a training step: forward and 2x backward
    stats["tflop_per_s"] = flops / step_s / 1e12
    stats["share_of_bf16_dense_peak"] = flops / step_s / BF16_DENSE_PEAK
    exe.close()
    log("[vgg16]", json.dumps(stats))
    want = {"dropout": 4 * n}
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite VGG-16 loss: %s" % losses)
    if stats["cache"]["graphs"] != 1:
        raise AssertionError("the VGG-16 step was not captured: %s" % stats["cache"])
    if {k: v for k, v in stats["launches"].items() if v} != want:
        raise AssertionError("VGG-16 launched %s; want %s" % (stats["launches"], want))
    return stats, scope


def run_vgg_capture_check(torch):
    """VGG-16 (224x224, batch VGG_CAPTURE_BATCH, bf16 AMP, both dropouts)
    captured against eager from one state, under deterministic algorithms
    and cuDNN's deterministic ones: three steps each (the cached
    executor's capture and replays, its entry warmed on a scope of its
    own, against ``use_program_cache=False``), every loss and every
    persistable (parameters, velocities, batch_norm running statistics)
    bit for bit; the dropout kernel 4 times a step on both paths."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.scope import to_numpy

    _free_device_memory(torch)
    main, startup, loss, _, _, _ = vgg_program(fluid, VGG_HW)
    boot_exe, boot = fluid.Executor(), fluid.Scope()
    boot_exe.run(startup, scope=boot)
    init = _clone_state(boot)
    del boot
    feeds = [{"img": torch.from_numpy(i).to(CARD), "lbl": torch.from_numpy(l).to(CARD)}
             for i, l in vgg_batches(np.random.RandomState(SEED + 29), VGG_CAPTURE_BATCH, 3,
                                     VGG_HW)]
    paths = {}
    with _deterministic(torch):
        for name, cached in (("eager", False), ("captured", True)):
            exe, scope = fluid.Executor(), fluid.Scope()
            if cached:  # the entry's eager warm-up, on a scope of its own
                warm = fluid.Scope()
                _load_state(warm, init)
                exe.run(main, feed=feeds[0], fetch_list=[loss], scope=warm)
                del warm
            _load_state(scope, init)
            kernels.reset_launch_counts()
            losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                                    use_program_cache=cached)[0]) for f in feeds]
            paths[name] = {"losses": losses, "launches": _hand_kernel_launches(),
                           "state": {n: to_numpy(v) for n, v in scope.vars.items()},
                           "cache": exe.jit_cache_stats()}
            exe.close()
    eager, cap = paths["eager"], paths["captured"]
    differing = sorted(n for n in eager["state"]
                       if not np.array_equal(eager["state"][n], cap["state"][n]))
    stats = {"batch": VGG_CAPTURE_BATCH, "losses": {n: p["losses"] for n, p in paths.items()},
             "losses_bit_equal": eager["losses"] == cap["losses"],
             "persistables": len(eager["state"]), "differing": differing[:10],
             "launches": {n: p["launches"] for n, p in paths.items()},
             "cache": {n: p["cache"] for n, p in paths.items()}}
    log("[vgg16-capture-check]", json.dumps(stats))
    if not (stats["losses_bit_equal"] and not differing and all(np.isfinite(cap["losses"]))
            and cap["cache"]["graphs"] == 1 and eager["cache"]["entries"] == 0
            and all(p["launches"]["dropout"] == 12 for p in paths.values())):
        raise AssertionError("captured and eager VGG-16 steps differ: %s" % stats)
    return stats


def vgg_card_and_cpu(torch, batch, amp):
    """One VGG-16 step at VGG_CHECK_HW x VGG_CHECK_HW, batch ``batch``, no
    dropout, in bf16 AMP or fp32, from the same state on the card (a
    captured entry, warmed on a scope of its own) and on the CPU, and
    again on the CPU with the images moved by 1e-6 relative
    (``check_resnet_against_cpu``'s yardstick): the losses, the relative
    L2 distance of all the gradients as one vector, the five parameters
    that carry most of it, and each of VGG_CHECK_GRADS' relative L2
    distance and largest difference over the CPU's largest magnitude."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    _free_device_memory(torch)
    main, startup, loss, _, pg, _ = vgg_program(fluid, VGG_CHECK_HW, amp=amp, dropout=False)
    grads = [g.name for _, g in pg]
    names = [p.name for p, _ in pg]
    fetch = [loss.name] + grads
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    state = {n: to_numpy(v) for n, v in card_scope.vars.items()}
    (img, lbl), = vgg_batches(np.random.RandomState(SEED + 30), batch, 1, VGG_CHECK_HW)
    feed = {"img": img, "lbl": lbl}
    warm = fluid.Scope()
    _load_state(warm, card_scope.vars)
    card_exe.run(main, feed=feed, fetch_list=fetch, scope=warm)
    del warm
    card = card_exe.run(main, feed=feed, fetch_list=fetch, scope=card_scope)
    cpu_exe = fluid.Executor(fluid.CPUPlace())

    def cpu_step(f):
        scope = fluid.Scope()
        fluid.io.set_params_from_numpy(scope, state, "cpu")
        return cpu_exe.run(main, feed=f, fetch_list=fetch, scope=scope)

    def measures(a, b):
        out = {"all_rel_l2": _global_rel(a[1:], b[1:])}
        for n in VGG_CHECK_GRADS:
            k = 1 + names.index(n)
            out[n] = {"rel_l2": _global_rel([a[k]], [b[k]]), "max_rel": _max_rel(a[k], b[k])}
        sq = [float(np.sum((np.asarray(x, np.float64) - y) ** 2)) for x, y in zip(a[1:], b[1:])]
        out["largest_parts"] = {names[k]: sq[k] / max(sum(sq), 1e-300)  # shares of the distance
                                for k in sorted(range(len(sq)), key=sq.__getitem__)[-5:]}
        return out

    t0 = time.perf_counter()
    cpu = cpu_step(feed)
    rng = np.random.RandomState(SEED + 31)
    yard = cpu_step(dict(feed, img=(img * (1 + 1e-6 * rng.standard_normal(img.shape))).astype(
        np.float32)))
    stats = {"hw": VGG_CHECK_HW, "batch": batch, "amp": amp,
             "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
             "loss_rel_err": _max_rel(card[0], cpu[0]),
             "grads": measures(card, cpu), "yardstick_nudged_cpu": measures(yard, cpu),
             "finite": all(bool(np.isfinite(a).all()) for a in card),
             "cpu_s": time.perf_counter() - t0, "card_cache": card_exe.jit_cache_stats()}
    card_exe.close()
    return stats


def check_vgg_against_cpu(torch):
    """``vgg_card_and_cpu`` at VGG_CHECK_BATCH, in fp32 and in bf16 AMP.

    fp32: the loss within TRAIN_TOL of the CPU's, the last fc's weight
    gradient (above the conv blocks) within TRAIN_TOL by relative L2, and
    all the gradients within VGG_YARDSTICK times the CPU's own distance
    under the 1e-6 nudge.  Below the fcs the gradient is chaotic: the
    nudge, or the card's other rounding, flips some max-pool and relu
    choices, and the distance spreads over the conv layers, most of it in
    conv2d_1 to conv2d_5.  On an H100 80GB HBM3 at 700 W over four
    weight seeds the card read 0.28x to 1.37x of the nudge (4e-3 to 9.5e-3)
    for all the gradients, and 2.0e-5 to 2.1e-5 for the last fc.

    AMP: the loss within AMP_TOL[0]; all the gradients, and each of
    VGG_CHECK_GRADS, within VGG_AMP_YARDSTICK times their nudge distance.
    The bf16 roundings that flip under the nudge move all the gradients
    by 0.41 to 0.47 (the last fc's by 0.05 to 0.06) at batch 16, 32 and
    64 alike, so AMP_TOL[1] is out of any implementation's reach; the
    card read 0.85x to 0.96x of the nudge for all of them over four
    weight seeds (the last fc 0.75x to 0.92x).  A gradient half zero or
    half sign-flipped reads about 0.7 or 1.4, outside either limit."""
    fp32 = vgg_card_and_cpu(torch, VGG_CHECK_BATCH, amp=False)
    log("[vgg16-check]", json.dumps(fp32))
    amp = vgg_card_and_cpu(torch, VGG_CHECK_BATCH, amp=True)
    log("[vgg16-check-amp]", json.dumps(amp))
    ok = (all(st["finite"] and st["card_cache"]["graphs"] == 1 for st in (fp32, amp))
          and fp32["loss_rel_err"] <= TRAIN_TOL
          and fp32["grads"]["fc_2.w_0"]["rel_l2"] <= TRAIN_TOL
          and fp32["grads"]["all_rel_l2"]
          <= VGG_YARDSTICK * fp32["yardstick_nudged_cpu"]["all_rel_l2"]
          and amp["loss_rel_err"] <= AMP_TOL[0]
          and amp["grads"]["all_rel_l2"]
          <= VGG_AMP_YARDSTICK * amp["yardstick_nudged_cpu"]["all_rel_l2"]
          and all(amp["grads"][n]["rel_l2"]
                  <= VGG_AMP_YARDSTICK * amp["yardstick_nudged_cpu"][n]["rel_l2"]
                  for n in VGG_CHECK_GRADS))
    if not ok:
        raise AssertionError("card and CPU VGG-16 steps differ: %s" % [fp32, amp])
    return fp32, amp


def run_vgg_serving(torch, workdir, scope):
    """VGG-16 served: ``vgg16(..., is_test=True)`` in fp32 with phase 28's
    trained weights and running statistics, through
    ``save_inference_model``, ``AnalysisPredictor`` and ``InferenceServer``
    (max_batch_size 16) to VGG_SERVE_ROWS concurrent requests, twice.
    Every answer finite, of shape [rows, 1000], and within SERVE_TOL of the
    eager executor (``use_program_cache=False``) on the saved model."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    _free_device_memory(torch)
    test_main, _, _, pred, _, _ = vgg_program(fluid, VGG_HW, amp=False, is_test=True)
    model_dir = os.path.join(workdir, "vgg16")
    fluid.io.save_inference_model(model_dir, ["img"], [pred], fluid.Executor(),
                                  main_program=test_main, scope=scope)
    predictor = fluid.inference.create_paddle_predictor(fluid.inference.AnalysisConfig(model_dir))
    server = serving.InferenceServer(predictor, max_batch_size=16, batch_timeout_ms=5.0)
    stats = {"rows": VGG_SERVE_ROWS}
    t0 = time.perf_counter()
    server.warmup()
    stats["warmup_s"] = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 32)
    feeds = [{"img": vgg_batches(rng, r, 1, VGG_HW)[0][0]} for r in VGG_SERVE_ROWS]
    try:
        bursts = _serve_bursts(serving.Client(server), feeds, 2)
    finally:
        server.stop(drain=True, timeout=60)
    m = server.metrics()
    stats["bursts"] = _burst_stats(bursts, sum(VGG_SERVE_ROWS))
    stats.update(batches=m["batches"], warmup_runs=m["warmup_runs"])
    eager_exe, eager_scope = fluid.Executor(), fluid.Scope()
    prog, _, fetch_vars = fluid.io.load_inference_model(model_dir, eager_exe, scope=eager_scope)
    eager = [eager_exe.run(prog, feed=f, fetch_list=fetch_vars, scope=eager_scope,
                           use_program_cache=False)[0] for f in feeds]
    worst = 0.0
    for answers, _, _ in bursts:
        for f, (out,), ref in zip(feeds, answers, eager):
            if out.shape != (f["img"].shape[0], VGG_CLASSES) or not np.isfinite(out).all():
                raise AssertionError("bad served VGG-16 output: shape %s" % (out.shape,))
            worst = max(worst, float(np.abs(out - ref).max()))
    stats["served_vs_eager_max_abs"] = worst
    # random weights leave the probabilities near 1 / 1000: each row is
    # also held relative to its largest probability
    top = float(min(e.max() for e in eager))
    stats["served_vs_eager_rel_to_top"] = worst / top
    stats["mean_top_probability"] = float(np.mean(np.concatenate([e.max(1) for e in eager])))
    stats["cache"] = predictor.jit_cache_stats()
    log("[vgg16-serve]", json.dumps(stats))
    if not (worst <= SERVE_TOL and stats["served_vs_eager_rel_to_top"] <= VGG_SERVE_REL_TOL
            and stats["cache"]["graphs"] >= 1):
        raise AssertionError("served VGG-16 answers differ from eager: %s" % stats)
    return stats


def _append_op(op_type, ins, outs, attrs=None):
    """append_op where no layer builds the op: ``ins`` slot -> vars,
    ``outs`` slot -> count; the outputs' vars in slot order."""
    from paddle_tpu_torch import framework

    block = framework.default_main_program().current_block()
    out_vars = {s: [block.create_var(name="%s_%s_%d" % (op_type, s.lower(), i))
                    for i in range(k)] for s, k in outs.items()}
    block.append_op(op_type, inputs=ins, outputs=out_vars, attrs=attrs or {})
    return [v for vs in out_vars.values() for v in vs]


def _core_op_cases(rng):
    """Phase 29's cases: (name, op type, shape label, feeds, build, grad
    inputs, tolerance).  ``build(L, v)`` appends the op to the current
    program over the data vars ``v`` (one per feed, its exact shape) and
    returns its outputs; ``grad`` names the feeds the vjp is checked into.
    Shapes are the model widths the op serves at (bench_ops.py's HOT_OPS
    where it has the op)."""
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    sh = CORE_SHAPES
    bert, hot = sh["bert"], sh["hot"]
    act = f32(*bert)
    near1 = rng.uniform(0.995, 1.005, bert).astype(np.float32)  # a product of 768 stays finite
    pos = np.abs(f32(*bert)) + 0.5
    res = f32(*sh["resnet"])  # ResNet-50 stage 1, bench_ops.py's conv2d_s2 input
    c_res = sh["resnet"][1]
    vocab, d = sh["vocab"]
    table = f32(vocab, d)
    logits = f32(*sh["logits"])
    n_tok, n_cls = sh["logits"]
    ctr = f32(*sh["ctr"])
    probs = 1.0 / (1.0 + np.exp(-ctr))
    wide = f32(*sh["wide"])
    ids4k = rng.integers(0, vocab, sh["indices"])
    spec = sh["spectral"]
    btp_rows, btp_size = sh["btp"]
    B, R, V, N, C = ("bert %s" % list(bert), "resnet %s" % list(sh["resnet"]),
                     "vocab %s" % [vocab, d], "nmt logits %s" % list(sh["logits"]),
                     "deepfm %s" % list(sh["ctr"]))

    ap = _append_op

    cases = [
        ("reduce_mean", "reduce_mean", "hot %s" % list(hot), {"x": f32(*hot)},
         lambda L, v: L.reduce_mean(v["x"], dim=[-1]), ("x",), 1e-5),
        ("transpose", "transpose", "hot %s" % list(sh["attn"]), {"x": f32(*sh["attn"])},
         lambda L, v: ap("transpose", {"X": [v["x"]]}, {"Out": 1}, {"axis": [0, 2, 1, 3]}),
         ("x",), 0.0),
        ("reduce_max", "reduce_max", B, {"x": act}, lambda L, v: L.reduce_max(v["x"], dim=[1]),
         ("x",), 0.0),
        ("reduce_min", "reduce_min", B, {"x": act}, lambda L, v: L.reduce_min(v["x"], dim=[-1]),
         ("x",), 0.0),
        ("reduce_prod", "reduce_prod", B, {"x": near1},
         lambda L, v: L.reduce_prod(v["x"], dim=[2]), ("x",), 1e-4),
        ("reduce_all", "reduce_all", B, {"x": act > -3},
         lambda L, v: ap("reduce_all", {"X": [v["x"]]}, {"Out": 1}, {"dim": [2]}), (), 0.0),
        ("reduce_any", "reduce_any", B, {"x": act > 3},
         lambda L, v: ap("reduce_any", {"X": [v["x"]]}, {"Out": 1}, {"dim": [2]}), (), 0.0),
        ("elementwise_mod", "elementwise_mod", B, {"x": act * 5, "y": pos},
         lambda L, v: ap("elementwise_mod", {"X": [v["x"]], "Y": [v["y"]]}, {"Out": 1}),
         ("x", "y"), 1e-5),
        ("elementwise_floordiv", "elementwise_floordiv", B, {"x": act * 5, "y": pos},
         lambda L, v: ap("elementwise_floordiv", {"X": [v["x"]], "Y": [v["y"]]}, {"Out": 1}),
         (), 1e-5),
        ("pow", "pow", B, {"x": pos}, lambda L, v: L.pow(v["x"], 1.5), ("x",), 1e-5),
        ("isfinite", "isfinite", B, {"x": act}, lambda L, v: L.isfinite(v["x"]), (), 0.0),
        ("split", "split", B, {"x": act}, lambda L, v: L.split(v["x"], 3, dim=2), ("x",), 0.0),
        ("stack", "stack", B, {"x": act, "y": near1},
         lambda L, v: L.stack([v["x"], v["y"]], axis=1), ("x", "y"), 0.0),
        ("unstack", "unstack", "bert [%d,4,%d]" % (bert[0], bert[2]), {"x": act[:, :4]},
         lambda L, v: L.unstack(v["x"], axis=1), ("x",), 0.0),
        ("squeeze2", "squeeze2", B, {"x": act[:, :1]}, lambda L, v: L.squeeze(v["x"], [1]),
         ("x",), 0.0),
        ("unsqueeze2", "unsqueeze2", B, {"x": act}, lambda L, v: L.unsqueeze(v["x"], [1]),
         ("x",), 0.0),
        ("flatten2", "flatten2", B, {"x": act}, lambda L, v: L.flatten(v["x"], axis=2),
         ("x",), 0.0),
        ("squeeze", "squeeze", B, {"x": act[:, :1]},
         lambda L, v: ap("squeeze", {"X": [v["x"]]}, {"Out": 1, "XShape": 1}, {"axes": [1]})[:1],
         ("x",), 0.0),
        ("unsqueeze", "unsqueeze", B, {"x": act},
         lambda L, v: ap("unsqueeze", {"X": [v["x"]]}, {"Out": 1, "XShape": 1},
                         {"axes": [0]})[:1], ("x",), 0.0),
        ("flatten", "flatten", B, {"x": act},
         lambda L, v: ap("flatten", {"X": [v["x"]]}, {"Out": 1, "XShape": 1},
                         {"axis": 1})[:1], ("x",), 0.0),
        ("strided_slice", "strided_slice", B, {"x": act},
         lambda L, v: ap("strided_slice", {"Input": [v["x"]]}, {"Out": 1},
                         {"axes": [1, 2], "starts": [0, d - 1], "ends": [bert[1], -d - 1],
                          "strides": [2, -3]}), ("x",), 0.0),
        ("shape", "shape", B, {"x": act}, lambda L, v: L.shape(v["x"]), (), 0.0),
        ("pad", "pad", B, {"x": act}, lambda L, v: L.pad(v["x"], [0, 0, 0, 8, 4, 4], 0.5),
         ("x",), 0.0),
        ("crop", "crop", B, {"x": act},
         lambda L, v: L.crop(v["x"], shape=[bert[0], bert[1] // 2, d // 2],
                             offsets=[0, bert[1] // 4, d // 6]), ("x",), 0.0),
        ("crop_tensor", "crop_tensor", B, {"x": act},
         lambda L, v: ap("crop_tensor", {"X": [v["x"]]}, {"Out": 1},
                         {"offsets": [0, 0, d // 3], "shape": [bert[0], bert[1], d // 2]}),
         ("x",), 0.0),
        ("pad_constant_like", "pad_constant_like", B,
         {"x": act, "y": act[:, :bert[1] * 15 // 16, :d * 7 // 8]},
         lambda L, v: L.pad_constant_like(v["x"], v["y"], 1.0), ("y",), 0.0),
        ("cumsum", "cumsum", B, {"x": act},
         lambda L, v: L.cumsum(v["x"], axis=2, exclusive=True, reverse=True), ("x",), 1e-4),
        ("l2_normalize", "l2_normalize", B, {"x": act},
         lambda L, v: L.l2_normalize(v["x"], axis=2), ("x",), 1e-5),
        ("norm", "norm", B, {"x": act},
         lambda L, v: ap("norm", {"X": [v["x"]]}, {"Out": 1, "Norm": 1}, {"axis": -1})[:1],
         ("x",), 1e-5),
        ("roll", "roll", B, {"x": act},
         lambda L, v: ap("roll", {"X": [v["x"]]}, {"Out": 1}, {"shifts": [3], "axis": [1]}),
         ("x",), 0.0),
        ("fill_zeros_like2", "fill_zeros_like2", B, {"x": act},
         lambda L, v: ap("fill_zeros_like2", {"X": [v["x"]]}, {"Out": 1}), (), 0.0),
        ("fill", "fill", B, {},
         lambda L, v: ap("fill", {}, {"Out": 1}, {"shape": list(bert), "dtype": "float32",
                                                  "value": 0.5}), (), 0.0),
        ("meshgrid", "meshgrid", "[%d] x [%d]" % (sh["ctr"][0], d),
         {"x": f32(sh["ctr"][0]), "y": f32(d)},
         lambda L, v: ap("meshgrid", {"X": [v["x"], v["y"]]}, {"Out": 2}), ("x", "y"), 1e-5),
        ("lookup_table_v2", "lookup_table_v2", V + ", ids %s" % list(bert[:2]),
         {"w": table, "ids": rng.integers(0, vocab, bert[:2])},
         lambda L, v: ap("lookup_table_v2", {"W": [v["w"]], "Ids": [v["ids"]]}, {"Out": 1}),
         ("w",), 0.0),
        ("gather_nd", "gather_nd", V + ", %d indices" % ids4k.size,
         {"x": table, "idx": ids4k.reshape(-1, 1)},
         lambda L, v: ap("gather_nd", {"X": [v["x"]], "Index": [v["idx"]]}, {"Out": 1}),
         ("x",), 0.0),
        ("scatter", "scatter", V + ", %d indices" % ids4k.size,
         {"x": table, "ids": ids4k, "upd": f32(ids4k.size, d)},
         lambda L, v: L.scatter(v["x"], v["ids"], v["upd"], overwrite=False), ("x", "upd"),
         1e-5),
        ("arg_min", "arg_min", "top_k %s" % list(wide.shape), {"x": wide},
         lambda L, v: L.argmin(v["x"], axis=1), (), 0.0),
        ("argsort", "argsort", "top_k %s" % list(wide.shape), {"x": wide},
         lambda L, v: list(L.argsort(v["x"], axis=-1, descending=True)), (), 0.0),
        ("one_hot", "one_hot", N, {"lbl": rng.integers(0, n_cls, (n_tok, 1))},
         lambda L, v: L.one_hot(v["lbl"], n_cls), (), 0.0),
        ("label_smoothed_xent", "softmax_with_cross_entropy", N,
         {"logits": logits, "lbl": rng.integers(0, n_cls, (n_tok, 1))},
         lambda L, v: L.softmax_with_cross_entropy(
             v["logits"], L.label_smooth(L.one_hot(v["lbl"], n_cls), epsilon=0.1),
             soft_label=True), ("logits",), 1e-5),
        ("log_softmax", "log_softmax", N, {"x": logits}, lambda L, v: L.log_softmax(v["x"]),
         ("x",), 1e-5),
        ("conv2d_transpose", "conv2d_transpose", R, {"x": res, "w": f32(c_res, c_res, 3, 3) * 0.05},
         lambda L, v: ap("conv2d_transpose", {"Input": [v["x"]], "Filter": [v["w"]]},
                         {"Output": 1}, {"strides": [2, 2], "paddings": [1, 1],
                                         "dilations": [1, 1]}), ("x", "w"), 1e-4),
        ("depthwise_conv2d", "depthwise_conv2d", R, {"x": res, "w": f32(c_res, 1, 3, 3) * 0.3},
         lambda L, v: ap("depthwise_conv2d", {"Input": [v["x"]], "Filter": [v["w"]]},
                         {"Output": 1}, {"strides": [1, 1], "paddings": [1, 1],
                                         "dilations": [1, 1]}), ("x", "w"), 1e-4),
        ("depthwise_conv2d_transpose", "depthwise_conv2d_transpose", R,
         {"x": res, "w": f32(c_res, 1, 2, 2) * 0.3},
         lambda L, v: ap("depthwise_conv2d_transpose", {"Input": [v["x"]], "Filter": [v["w"]]},
                         {"Output": 1}, {"strides": [2, 2], "paddings": [0, 0],
                                         "dilations": [1, 1], "groups": c_res}), ("x",), 1e-4),
        ("group_norm", "group_norm", R, {"x": res, "s": f32(c_res), "b": f32(c_res)},
         lambda L, v: ap("group_norm", {"X": [v["x"]], "Scale": [v["s"]], "Bias": [v["b"]]},
                         {"Y": 1, "Mean": 1, "Variance": 1}, {"groups": 32})[:1],
         ("x", "s", "b"), 1e-4),
        ("prelu", "prelu", R, {"x": res, "a": np.abs(f32(c_res)) * 0.25},
         lambda L, v: ap("prelu", {"X": [v["x"]], "Alpha": [v["a"]]}, {"Out": 1},
                         {"mode": "channel"}), ("x", "a"), 1e-5),
        ("prelu_channel", "prelu_channel", R, {"x": res},
         lambda L, v: ap("prelu_channel", {"X": [v["x"]]}, {"Out": 1}), ("x",), 0.0),
        ("bilinear_interp", "bilinear_interp", R, {"x": res},
         lambda L, v: L.resize_bilinear(v["x"], scale=2.0), ("x",), 1e-5),
        ("nearest_interp", "nearest_interp", R, {"x": res},
         lambda L, v: L.resize_nearest(v["x"], scale=2.0), ("x",), 0.0),
        ("pixel_shuffle", "pixel_shuffle", R, {"x": res},
         lambda L, v: L.pixel_shuffle(v["x"], 2), ("x",), 0.0),
        ("shuffle_channel", "shuffle_channel", R, {"x": res},
         lambda L, v: L.shuffle_channel(v["x"], 4), ("x",), 0.0),
        ("pad2d", "pad2d", R, {"x": res}, lambda L, v: L.pad2d(v["x"], [1, 1, 2, 2],
                                                             mode="reflect"), ("x",), 0.0),
        ("maxout", "maxout", R, {"x": res}, lambda L, v: L.maxout(v["x"], 2), ("x",), 0.0),
        ("spectral_norm", "spectral_norm", "weight %s" % list(spec),
         {"w": f32(*spec), "u": f32(spec[0]), "vv": f32(spec[1])},
         lambda L, v: ap("spectral_norm", {"Weight": [v["w"]], "U": [v["u"]], "V": [v["vv"]]},
                         {"Out": 1}, {"dim": 0, "power_iters": 1, "eps": 1e-12}), ("w",), 1e-4),
        ("data_norm", "data_norm", C,
         {"x": ctr, "bsz": np.full(ctr.shape[1], 1e4, np.float32), "bsum": f32(ctr.shape[1]),
          "bsq": np.full(ctr.shape[1], 1e4, np.float32)},
         lambda L, v: ap("data_norm", {"X": [v["x"]], "BatchSize": [v["bsz"]],
                                       "BatchSum": [v["bsum"]], "BatchSquareSum": [v["bsq"]]},
                         {"Y": 1, "Means": 1, "Scales": 1}, {"epsilon": 1e-4})[:1],
         ("x", "bsz", "bsum", "bsq"), 1e-5),
        ("huber_loss", "huber_loss", C, {"x": ctr, "y": f32(*ctr.shape)},
         lambda L, v: L.huber_loss(v["x"], v["y"], 1.0), ("x",), 1e-5),
        ("smooth_l1_loss", "smooth_l1_loss", C, {"x": ctr, "y": f32(*ctr.shape)},
         lambda L, v: L.smooth_l1(v["x"], v["y"], sigma=1.0), ("x",), 1e-5),
        ("log_loss", "log_loss", C, {"p": probs, "y": (ctr > 0).astype(np.float32)},
         lambda L, v: L.log_loss(v["p"], v["y"]), ("p",), 1e-5),
        ("bilinear_tensor_product", "bilinear_tensor_product",
         "[%d,%d] x2, size %d" % (btp_rows, d, btp_size),
         {"x": f32(btp_rows, d), "y": f32(btp_rows, d), "w": f32(btp_size, d, d) * 0.03},
         lambda L, v: ap("bilinear_tensor_product", {"X": [v["x"]], "Y": [v["y"]],
                                                     "Weight": [v["w"]]}, {"Out": 1}),
         ("x", "y", "w"), 1e-4),
    ]
    return cases


def _host_op_cases(rng, workdir):
    """The op types a capture cannot hold (host reads and generators): each
    at a model width, its plan checked to stay on the interpreter."""
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    sh = CORE_SHAPES
    saved = os.path.join(workdir, "loaded_w.npy")
    np.save(saved, f32(*sh["spectral"]))
    n_tok, rows = sh["logits"][0], sh["ctr"][0]
    probs = np.tile(np.arange(1, 17, dtype=np.float32) / 136.0, (n_tok, 1))
    return saved, [
        ("py_func", "deepfm %s" % list(sh["ctr"]), {"x": f32(*sh["ctr"])}),
        ("load", "%s" % list(sh["spectral"]), {}),
        ("linspace", "[%d]" % rows, {}),
        ("sampling_id", "[%d,16]" % n_tok, {"p": probs}),
        ("uniform_random_batch_size_like", "[%d,%d]" % (rows, sh["vocab"][1]),
         {"x": f32(rows, sh["vocab"][1])}),
    ]


def _build_host_op(fluid, op_type, feeds, saved, arr_shape):
    L = fluid.layers
    main = fluid.Program()
    block = main.global_block()
    with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
        v = {n: L.data(n, list(a.shape), dtype=str(a.dtype), append_batch_size=False)
             for n, a in feeds.items()}
        out = block.create_var(name="out", dtype="float32",
                               shape=list(feeds["x"].shape) if op_type == "py_func" else None)
        if op_type == "py_func":
            L.py_func(lambda a: np.tanh(a) * 2.0, v["x"], out)
        elif op_type == "load":
            out.shape = tuple(arr_shape)
            L.load(out, saved)
        elif op_type == "linspace":
            for n, dt, val in (("start", "float32", -1.0), ("stop", "float32", 3.0),
                               ("num", "int32", CORE_SHAPES["ctr"][0])):
                L.assign(np.array([val], dt), block.create_var(name=n, dtype=dt))
            block.append_op("linspace", inputs={"Start": ["start"], "Stop": ["stop"],
                                                "Num": ["num"]},
                            outputs={"Out": [out]}, attrs={"dtype": "float32"})
        elif op_type == "sampling_id":
            block.append_op("sampling_id", inputs={"X": [v["p"]]}, outputs={"Out": [out]},
                            attrs={"seed": 29})
        else:
            block.append_op(op_type, inputs={"Input": [v["x"]]}, outputs={"Out": [out]},
                            attrs={"shape": [-1, feeds["x"].shape[1]], "min": -2.0, "max": 3.0,
                                   "seed": 29,
                                   "dtype": "float32"})
    return main


def _chi2_ok(counts, p):
    from scipy import stats as sstats

    return float(sstats.chisquare(counts, counts.sum() * p).pvalue)


def _scaled_err(ref, got):
    """max |got - ref| over max(1, max |ref|); 0 for empty arrays, and the
    arrays' shapes must agree."""
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    if ref.shape != got.shape:
        return float("inf")
    if not ref.size:
        return 0.0
    return float(np.abs(got - ref).max()) / max(1.0, float(np.abs(ref).max()))


def _measure_op_case(torch, fluid, cpu_exe, rng, case):
    """One op case of phases 29 and 31 (``_core_op_cases``' tuple) alone in
    a program through ``Executor.run`` on cuda:0: an eager run
    (``use_program_cache=False``), then the cached executor's warm-up,
    capture and two replays, each bit for bit against the eager run under
    deterministic algorithms, its plan free of eager ops; the card's
    outputs against the CPU's within the case's tolerance relative to
    max(1, max |CPU|); for a differentiable op, its vjp (``gradients``
    with a seeded cotangent) on the card against the CPU's at the same
    tolerance (at least 1e-5); and the replay's device time (CUDA events
    around the graph's replays, ``_time_ms``) beside its bytes bound
    (inputs read and outputs written once, at HBM_BYTES_PER_S).  Returns
    (row, ok)."""
    name, op_type, label, feeds, build, grad, tol = case
    t0 = time.perf_counter()
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
        v = {n: fluid.layers.data(n, list(a.shape), dtype=str(a.dtype),
                                  append_batch_size=False, stop_gradient=False)
             for n, a in feeds.items()}
        outs = build(fluid.layers, v)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    fetch = [o.name for o in outs]
    ref_exe, exe, scope = fluid.Executor(), fluid.Executor(), fluid.Scope()
    eager_ops = list(exe._analyze(main, tuple(sorted(feeds)), tuple(fetch)).eager_ops)
    with _deterministic(torch):
        eager = ref_exe.run(main, feed=feeds, fetch_list=fetch, scope=fluid.Scope(),
                            use_program_cache=False)
        bit_equal = True
        for _ in range(4):  # warm-up, capture, two replays
            got = exe.run(main, feed=feeds, fetch_list=fetch, scope=scope)
            bit_equal = bit_equal and all(np.array_equal(g, e) for g, e in zip(got, eager))
    graphs = exe.jit_cache_stats()["graphs"]
    ms = _time_ms(torch, _the_graph(exe).replay) if graphs == 1 else None
    exe.close()
    ref_exe.close()
    cpu = cpu_exe.run(main, feed=feeds, fetch_list=fetch, scope=fluid.Scope())
    fwd_err = max(_scaled_err(c, e) for c, e in zip(cpu, eager))
    nbytes = sum(a.nbytes for a in feeds.values()) + sum(np.asarray(e).nbytes for e in eager)
    row = {"name": name, "op": op_type, "shape": label,
           "dtype": str(next(iter(feeds.values())).dtype) if feeds else "float32",
           "replay_ms": ms, "bytes_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
           "bytes": nbytes, "captured_bit_equal": bit_equal, "graphs": graphs,
           "eager_ops": eager_ops, "fwd_rel_err": fwd_err, "tol": tol}
    gnames = []
    if grad:
        gmain = fluid.Program()
        with fluid.program_guard(gmain, fluid.Program()), fluid.unique_name.guard():
            gv = {n: fluid.layers.data(n, list(a.shape), dtype=str(a.dtype),
                                       append_batch_size=False, stop_gradient=False)
                  for n, a in feeds.items()}
            gouts = build(fluid.layers, gv)
            gouts = [o for o in (gouts if isinstance(gouts, (list, tuple)) else [gouts])
                     if o.dtype == "float32"]
            cots = [fluid.layers.data("cot_%d" % i, list(o.shape), append_batch_size=False)
                    for i, o in enumerate(gouts)]
            gvars = fluid.gradients(gouts, [gv[n] for n in grad], target_gradients=cots)
        gfeed = dict(feeds, **{c.name: rng.standard_normal(tuple(c.shape), dtype=np.float32)
                               for c in cots})
        gnames = [g.name for g in gvars if g is not None]
        card_g = fluid.Executor().run(gmain, feed=gfeed, fetch_list=gnames, scope=fluid.Scope(),
                                      use_program_cache=False)
        cpu_g = cpu_exe.run(gmain, feed=gfeed, fetch_list=gnames, scope=fluid.Scope())
        row["vjp_inputs"] = len(gnames)
        row["vjp_rel_err"] = max(_scaled_err(c, g) for c, g in zip(cpu_g, card_g))
        row["vjp_shapes"] = [list(np.shape(g)) for g in card_g]
        del card_g, cpu_g, gfeed
    row["s"] = time.perf_counter() - t0
    ok = (bit_equal and graphs == 1 and not eager_ops and fwd_err <= tol
          and row.get("vjp_rel_err", 0.0) <= max(tol, 1e-5) and (not grad or gnames))
    return row, ok


def run_core_ops(torch, workdir):
    """Phase 29: every op type of the core layers' first part at the model
    width it serves at, each alone in a program through ``Executor.run``
    on cuda:0 (built by its layer, or by ``append_op`` where none builds
    it).  For each: an eager run (``use_program_cache=False``), then the
    cached executor's warm-up, capture and two replays, each bit for bit
    against the eager run under deterministic algorithms; the card's
    outputs against the CPU's within the case's tolerance relative to
    max(1, max |CPU|); for a differentiable op, its vjp (``gradients``
    with a seeded cotangent) on the card against the CPU's at the same
    tolerance; and the replay's device time (CUDA events around the
    graph's replays, ``_time_ms``) beside its bytes bound (inputs read and
    outputs written once, at HBM_BYTES_PER_S).  Ops whose outputs are
    views of their inputs launch no kernel.  Then the host-read and random
    types: their plans stay on the interpreter (``eager_ops``); py_func,
    load and linspace against the CPU, sampling_id by a chi-square test of
    its ids and uniform_random_batch_size_like by its moments."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    _free_device_memory(torch)
    rng = np.random.default_rng(SEED + 29)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    rows, failures = [], []
    kernels.reset_launch_counts()
    for case in _core_op_cases(rng):
        row, ok = _measure_op_case(torch, fluid, cpu_exe, rng, case)
        rows.append(row)
        if not ok:
            failures.append(row)
    saved, host_cases = _host_op_cases(rng, workdir)
    for op_type, label, feeds in host_cases:
        main = _build_host_op(fluid, op_type, feeds, saved, CORE_SHAPES["spectral"])
        exe = fluid.Executor()
        plan = exe._analyze(main, tuple(sorted(feeds)), ("out",))
        runs = [exe.run(main, feed=feeds, fetch_list=["out"], scope=fluid.Scope())[0]
                for _ in range(3)]
        row = {"name": op_type, "op": op_type, "shape": label, "eager_ops": list(plan.eager_ops),
               "graphs": exe.jit_cache_stats()["graphs"],
               "repeatable": all(np.array_equal(r, runs[0]) for r in runs)}
        exe.close()
        out = runs[0]
        if op_type == "sampling_id":
            p = feeds["p"][0].astype(np.float64)
            row["chi2_p"] = _chi2_ok(np.bincount(out, minlength=16), p / p.sum())
            ok = row["chi2_p"] > 1e-3 and out.shape == (CORE_SHAPES["logits"][0],)
        elif op_type == "uniform_random_batch_size_like":
            n, var = out.size, 25.0 / 12
            row["mean"], row["var"] = float(out.mean()), float(out.var())
            ok = (out.shape == feeds["x"].shape and out.min() >= -2.0 and out.max() < 3.0
                  and abs(out.mean() - 0.5) < 5 * np.sqrt(var / n)
                  and abs(out.var() - var) < 5 * np.sqrt((5.0 ** 4 / 80 - var ** 2) / n))
        else:
            cpu, = cpu_exe.run(main, feed=feeds, fetch_list=["out"], scope=fluid.Scope())
            row["max_abs_vs_cpu"] = float(np.abs(out - cpu).max())
            ok = row["max_abs_vs_cpu"] <= 1e-5
        rows.append(row)
        if not (ok and row["graphs"] == 0 and row["eager_ops"] == [op_type] and row["repeatable"]):
            failures.append(row)
    launches = _hand_kernel_launches()
    stats = {"ops": rows, "op_types": len({r["op"] for r in rows}), "launches": launches,
             "failures": [r["name"] for r in failures]}
    log("[core-ops]", json.dumps(stats))
    if failures:
        raise AssertionError("core op types failed on the card: %s" % failures)
    _no_hand_kernel("phase 29", launches)
    return stats


# ---------------------------------------------------------------------------
# phases 30 and 31: the book's sentiment model, and the sequence, RNN-unit
# and sampled-loss op types
# ---------------------------------------------------------------------------
def sentiment_program(fluid, is_test=False, lr=SENT_LR):
    """(main, startup, prob, loss, acc, params_grads) of the Fluid book's
    chapter 06 ``convolution_net`` at SENT's widths, as
    tests/book/test_understand_sentiment.py builds it: embedding, two
    ``nets.sequence_conv_pool`` windows (3 and 4 words, tanh, sqrt
    pooling), concat, fc softmax; in training the mean cross entropy, the
    accuracy and ``AdagradOptimizer(lr)``.  The ``is_test`` build is the
    forward alone, with the same parameter names."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = SEED
    loss = acc = params_grads = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        words = fluid.layers.data("words", [SENT["max_len"]], dtype="int64", lod_level=1)
        seq_len = main.global_block().var("words_seq_len")
        emb = fluid.layers.embedding(words, size=[SENT["dict_size"], SENT["emb"]])
        convs = [fluid.nets.sequence_conv_pool(emb, SENT["hid"], size, act="tanh",
                                               pool_type="sqrt", seq_len=seq_len)
                 for size in (3, 4)]
        prob = fluid.layers.fc(fluid.layers.concat(convs, axis=1), SENT["classes"],
                               act="softmax")
        if not is_test:
            label = fluid.layers.data("label", [1], dtype="int64")
            loss = fluid.layers.mean(fluid.layers.cross_entropy(prob, label))
            acc = fluid.layers.accuracy(prob, label)
            _, params_grads = fluid.optimizer.AdagradOptimizer(lr).minimize(loss)
    return main, startup, prob, loss, acc, params_grads


def sentiment_batch(rng, rows):
    """A batch of ``rows`` synthetic reviews: lengths uniform in [min_len,
    max_len], word ids uniform over the dictionary (0 past each end), labels
    0 or 1."""
    lens = rng.randint(SENT["min_len"], SENT["max_len"] + 1, rows)
    words = rng.randint(1, SENT["dict_size"], (rows, SENT["max_len"]))
    words[np.arange(SENT["max_len"])[None, :] >= lens[:, None]] = 0
    return {"words": words.astype(np.int64), "words_seq_len": lens.astype(np.int32),
            "label": rng.randint(0, SENT["classes"], (rows, 1)).astype(np.int64)}


def _sentiment_flops(rows):
    """A training step's operations: the two windows' products (3 and 4
    times emb wide, hid out) over every padded position, forward and twice
    that backward; the fc and the rest are below 0.1%."""
    T, E, H = SENT["max_len"], SENT["emb"], SENT["hid"]
    return 3 * sum(2 * rows * T * size * E * H for size in (3, 4))


def run_sentiment_train(torch):
    """Phase 30's training: the sentiment model at SENT's widths on the
    card, batch SENT_BATCH in fp32: startup on the card, the entry's eager
    step, its captured step and SENT_STEPS replays, each on a batch of its
    own; the median replay, reviews/s and real tokens/s, the share of the
    fp32 peak, peak memory, the graph pool, and one profiled replay's
    kernels by class.  Every loss finite, the step captured, no attention
    or dropout kernel.  Returns the stats and the trained scope."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    sync = torch.cuda.synchronize
    stats = {"widths": SENT, "batch": SENT_BATCH, "lr": SENT_LR,
             "allocated_before_bytes": _free_device_memory(torch)}
    main, startup, _, loss, acc, _ = sentiment_program(fluid)
    ops = [op.type for op in main.global_block().ops]
    stats["ops"] = len(ops)
    stats["op_types"] = {t: ops.count(t) for t in sorted(set(ops))}
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(SEED + 300)
    n = 2 + SENT_STEPS
    batches = [sentiment_batch(rng, SENT_BATCH) for _ in range(n + 1)]
    kernels.reset_launch_counts()  # counts from here on belong to the sentiment path
    losses, accs, times = [], [], []
    for f in batches[:n]:
        sync()
        t = time.perf_counter()
        l, a = exe.run(main, feed=f, fetch_list=[loss, acc], scope=scope)
        sync()
        times.append(time.perf_counter() - t)
        losses.append(float(l))
        accs.append(float(a))
    stats["launches"] = _hand_kernel_launches()  # read right after the sentiment path
    prof = _profile_step(torch, lambda: exe.run(main, feed=batches[n], fetch_list=[loss],
                                                scope=scope), all_kernels=True)
    if prof is not None:
        prof["kernel_classes"] = _kernel_classes(prof)
        del prof["all_kernels"]
    stats["profile"] = prof
    stats["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    stats["cache"] = exe.jit_cache_stats()
    stats["graph_pool_bytes"] = stats["cache"]["graph_pool_bytes"]
    stats.update(losses=losses, accuracies=accs, step_s=times)
    stats["eager_first_step_ms"], stats["capture_step_ms"] = 1e3 * times[0], 1e3 * times[1]
    step_s = statistics.median(times[2:])
    stats["step_ms_median"] = 1e3 * step_s
    stats["reviews_per_s"] = SENT_BATCH / step_s
    stats["real_tokens_per_s"] = float(np.mean([b["words_seq_len"].sum() for b in batches[2:n]])
                                       ) / step_s
    stats["tflop_per_s"] = _sentiment_flops(SENT_BATCH) / step_s / 1e12
    stats["share_of_fp32_peak"] = _sentiment_flops(SENT_BATCH) / step_s / FP32_PEAK
    if prof is not None:  # the profiled replay's device time against the unprofiled replay
        stats["device_idle_share_of_replay"] = 1 - prof["device_ms"] / stats["step_ms_median"]
    exe.close()
    log("[sentiment]", json.dumps(stats))
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite sentiment loss: %s" % losses)
    if stats["cache"]["graphs"] != 1:
        raise AssertionError("the sentiment step was not captured: %s" % stats["cache"])
    _no_hand_kernel("phase 30", stats["launches"])
    return stats, scope


def run_sentiment_capture_check(torch):
    """SENT_CAPTURE_STEPS captured steps of the sentiment model at batch
    SENT_BATCH against as many eager ones from one state, under
    deterministic algorithms (the embedding's gradient adds with atomics
    otherwise): the losses and every persistable (parameters and Adagrad's
    moments) bit for bit."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    _free_device_memory(torch)
    main, startup, _, loss, _, _ = sentiment_program(fluid)
    boot_exe, boot = fluid.Executor(), fluid.Scope()
    boot_exe.run(startup, scope=boot)
    init = _clone_state(boot)
    del boot
    rng = np.random.RandomState(SEED + 301)
    feeds = [sentiment_batch(rng, SENT_BATCH) for _ in range(SENT_CAPTURE_STEPS)]
    paths = {}
    with _deterministic(torch):
        for name, cached in (("eager", False), ("captured", True)):
            exe, scope = fluid.Executor(), fluid.Scope()
            if cached:  # the entry's eager warm-up, on a scope of its own
                warm = fluid.Scope()
                _load_state(warm, init)
                exe.run(main, feed=feeds[0], fetch_list=[loss], scope=warm)
                del warm
            _load_state(scope, init)
            losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                              use_program_cache=cached)[0] for f in feeds]
            paths[name] = {"losses": losses, "cache": exe.jit_cache_stats(),
                           "state": {n: to_numpy(v) for n, v in scope.vars.items()}}
            exe.close()
    eager, cap = paths["eager"], paths["captured"]
    differing = sorted(n for n in eager["state"]
                       if not np.array_equal(eager["state"][n], cap["state"][n]))
    stats = {"batch": SENT_BATCH, "steps": SENT_CAPTURE_STEPS,
             "losses": {n: [float(v) for v in p["losses"]] for n, p in paths.items()},
             "losses_bit_equal": all(a.tobytes() == b.tobytes()
                                     for a, b in zip(eager["losses"], cap["losses"])),
             "persistables": len(eager["state"]), "differing": differing[:10],
             "cache": {n: p["cache"] for n, p in paths.items()}}
    log("[sentiment-capture-check]", json.dumps(stats))
    if not (stats["losses_bit_equal"] and not differing and cap["cache"]["graphs"] == 1
            and eager["cache"]["entries"] == 0):
        raise AssertionError("captured and eager sentiment steps differ: %s" % stats)
    return stats


def check_sentiment_against_cpu(torch):
    """SENT_CHECK_STEPS steps at batch SENT_CHECK_BATCH on the card (a
    captured entry, warmed on a scope of its own) and on the CPU from one
    state: each step's loss within TRAIN_TOL relative, each step's
    gradients within TRAIN_TOL by relative L2 over all of them and for each
    parameter, and the parameters after the steps within TRAIN_TOL."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.scope import to_numpy

    _free_device_memory(torch)
    main, startup, _, loss, _, pg = sentiment_program(fluid)
    names = [p.name for p, _ in pg]
    fetch = [loss.name] + [g.name for _, g in pg]
    card_exe, card_scope = fluid.Executor(), fluid.Scope()
    card_exe.run(startup, scope=card_scope)
    state = {n: to_numpy(v) for n, v in card_scope.vars.items()}
    rng = np.random.RandomState(SEED + 302)
    feeds = [sentiment_batch(rng, SENT_CHECK_BATCH) for _ in range(SENT_CHECK_STEPS)]
    warm = fluid.Scope()
    _load_state(warm, card_scope.vars)
    card_exe.run(main, feed=feeds[0], fetch_list=fetch, scope=warm)
    del warm
    cpu_exe, cpu_scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    fluid.io.set_params_from_numpy(cpu_scope, state, "cpu")
    steps = []
    for f in feeds:
        card = card_exe.run(main, feed=f, fetch_list=fetch, scope=card_scope)
        cpu = cpu_exe.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
        steps.append({"loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
                      "loss_rel_err": _max_rel(card[0], cpu[0]),
                      "grads_all_rel_l2": _global_rel(card[1:], cpu[1:]),
                      "grads_rel_l2": {n: _global_rel([a], [b])
                                       for n, a, b in zip(names, card[1:], cpu[1:])},
                      "finite": all(bool(np.isfinite(a).all()) for a in card)})
    params = {n: _global_rel([to_numpy(card_scope.vars[n])], [to_numpy(cpu_scope.vars[n])])
              for n in names}
    stats = {"batch": SENT_CHECK_BATCH, "steps": steps, "params_rel_l2": params,
             "card_cache": card_exe.jit_cache_stats()}
    card_exe.close()
    log("[sentiment-check]", json.dumps(stats))
    ok = stats["card_cache"]["graphs"] == 1 and all(
        st["finite"] and st["loss_rel_err"] <= TRAIN_TOL and st["grads_all_rel_l2"] <= TRAIN_TOL
        and max(st["grads_rel_l2"].values()) <= TRAIN_TOL for st in steps) and max(
        params.values()) <= TRAIN_TOL
    if not ok:
        raise AssertionError("card and CPU sentiment steps differ: %s" % stats)
    return stats


def run_sentiment_serving(torch, workdir, scope):
    """The sentiment model served: the ``is_test`` build with phase 30's
    trained weights through ``save_inference_model``, ``AnalysisPredictor``
    and ``InferenceServer`` (max_batch_size 16) to SENT_SERVE_ROWS
    concurrent requests of mixed lengths, twice.  Every answer of shape
    [rows, 2], finite, within SERVE_TOL of the request run alone and of the
    eager executor on the saved model, and within CPU_REF_TOL of the CPU
    predictor."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    _free_device_memory(torch)
    test_main, _, prob, _, _, _ = sentiment_program(fluid, is_test=True)
    model_dir = os.path.join(workdir, "sentiment")
    fluid.io.save_inference_model(model_dir, ["words", "words_seq_len"], [prob],
                                  fluid.Executor(), main_program=test_main, scope=scope)
    predictor = fluid.inference.create_paddle_predictor(fluid.inference.AnalysisConfig(model_dir))
    server = serving.InferenceServer(predictor, max_batch_size=16, batch_timeout_ms=5.0)
    stats = {"rows": SENT_SERVE_ROWS}
    t0 = time.perf_counter()
    server.warmup()
    stats["warmup_s"] = time.perf_counter() - t0
    rng = np.random.RandomState(SEED + 303)
    feeds = []
    for r in SENT_SERVE_ROWS:
        b = sentiment_batch(rng, r)
        feeds.append({"words": b["words"], "words_seq_len": b["words_seq_len"]})
    try:
        bursts = _serve_bursts(serving.Client(server), feeds, 2)
    finally:
        server.stop(drain=True, timeout=60)
    m = server.metrics()
    stats["bursts"] = _burst_stats(bursts, sum(SENT_SERVE_ROWS))
    stats.update(batches=m["batches"], warmup_runs=m["warmup_runs"])
    alone = [predictor.run(f)[0] for f in feeds]
    eager_exe, eager_scope = fluid.Executor(), fluid.Scope()
    prog, _, fetch_vars = fluid.io.load_inference_model(model_dir, eager_exe, scope=eager_scope)
    eager = [eager_exe.run(prog, feed=f, fetch_list=fetch_vars, scope=eager_scope,
                           use_program_cache=False)[0] for f in feeds]
    cpu_cfg = fluid.inference.AnalysisConfig(model_dir)
    cpu_cfg.disable_gpu()
    cpu_pred = fluid.inference.create_paddle_predictor(cpu_cfg)
    cpu = [cpu_pred.run(f)[0] for f in feeds]
    worst = {"alone": 0.0, "eager": 0.0, "cpu": 0.0}
    for answers, _, _ in bursts:
        for f, (out,), a, e, c in zip(feeds, answers, alone, eager, cpu):
            if out.shape != (f["words"].shape[0], SENT["classes"]) or not np.isfinite(out).all():
                raise AssertionError("bad served sentiment output: shape %s" % (out.shape,))
            worst["alone"] = max(worst["alone"], float(np.abs(out - a).max()))
            worst["eager"] = max(worst["eager"], float(np.abs(out - e).max()))
            worst["cpu"] = max(worst["cpu"], float(np.abs(out - c).max()))
    stats["served_max_abs"] = worst
    stats["cache"] = predictor.jit_cache_stats()
    log("[sentiment-serve]", json.dumps(stats))
    if not (worst["alone"] <= SERVE_TOL and worst["eager"] <= SERVE_TOL
            and worst["cpu"] <= CPU_REF_TOL and stats["cache"]["graphs"] >= 1):
        raise AssertionError("served sentiment answers differ: %s" % stats)
    return stats


def _nce_dist(vocab):
    """A skewed custom distribution over ``vocab`` classes (Zipf-like,
    shuffled), as a unigram table of a corpus is."""
    p = 1.0 / (np.arange(vocab) + 10.0) ** 1.1
    return np.random.RandomState(SEED + 310).permutation(p / p.sum()).astype(np.float32)


def _seq_unit_op_cases(rng):
    """Phase 31's cases, in ``_core_op_cases``' form."""
    f32 = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    su = SEQ_UNIT
    rows, vocab, width = su["rows"], su["vocab"], su["width"]
    B, T, D = su["seq"]
    lens = rng.integers(SENT["min_len"], T + 1, B).astype(np.int32)
    x = f32(rows, width)
    label = rng.integers(0, vocab, (rows, 1))
    table, bias = f32(vocab, width) * 0.05, f32(vocab) * 0.1
    seq = f32(B, T, D)
    ub, uh = su["unit"]
    cb, ct, cc = su["ctc"]
    V = "vocab [%d,%d], %d rows" % (vocab, width, rows)
    S = "[%d,%d,%d]" % (B, T, D)
    cases = []
    for sampler in ("uniform", "log_uniform", "custom_dist"):
        attrs = {"num_neg_samples": su["neg"], "sampler": sampler, "seed": 31}
        if sampler == "custom_dist":
            attrs["custom_dist"] = _nce_dist(vocab)
        cases.append(("nce_" + sampler, "nce", V + ", %d negatives" % su["neg"],
                      {"x": x, "label": label, "w": table, "b": bias},
                      lambda L, v, attrs=attrs: _append_op(
                          "nce", {"Input": [v["x"]], "Label": [v["label"]], "Weight": [v["w"]],
                                  "Bias": [v["b"]]}, {"Cost": 1}, attrs),
                      ("x", "w", "b"), 1e-4))
    cases += [
        ("hierarchical_sigmoid", "hierarchical_sigmoid", V + ", the default tree",
         {"x": x, "label": label, "w": table[:vocab - 1], "b": bias[:vocab - 1]},
         lambda L, v: _append_op("hierarchical_sigmoid", {"X": [v["x"]], "Label": [v["label"]],
                                                          "W": [v["w"]], "Bias": [v["b"]]},
                                 {"Out": 1, "PreOut": 1}, {"num_classes": vocab})[:1],
         ("x", "w", "b"), 1e-4),
        ("cos_sim", "cos_sim", "[%d,%d] x2" % (rows, width), {"x": x, "y": f32(rows, width)},
         lambda L, v: L.cos_sim(v["x"], v["y"]), ("x", "y"), 1e-4),
        ("sequence_conv", "sequence_conv", S + " -> %d, window 3" % su["filters"],
         {"x": seq, "len": lens, "w": f32(3 * D, su["filters"]) * 0.05},
         lambda L, v: _append_op("sequence_conv", {"X": [v["x"]], "Filter": [v["w"]],
                                                   "SeqLen": [v["len"]]}, {"Out": 1},
                                 {"contextStart": -1, "contextLength": 3}),
         ("x", "w"), 1e-4),
        ("row_conv", "row_conv", S + ", lookahead %d" % su["lookahead"],
         {"x": seq, "len": lens, "w": f32(su["lookahead"] + 1, D) * 0.2},
         lambda L, v: _append_op("row_conv", {"X": [v["x"]], "Filter": [v["w"]],
                                              "SeqLen": [v["len"]]}, {"Out": 1}),
         ("x", "w"), 1e-5),
        ("lstm_unit", "lstm_unit", "[%d,%d]" % (ub, uh),
         {"x": f32(ub, 4 * uh), "c": f32(ub, uh)},
         lambda L, v: _append_op("lstm_unit", {"X": [v["x"]], "C_prev": [v["c"]]},
                                 {"C": 1, "H": 1}, {"forget_bias": 1.0}), ("x", "c"), 1e-5),
        ("gru_unit", "gru_unit", "[%d,%d]" % (ub, uh),
         {"x": f32(ub, 3 * uh), "h": f32(ub, uh), "w": f32(uh, 3 * uh) * 0.05,
          "b": f32(1, 3 * uh)},
         lambda L, v: _append_op("gru_unit", {"Input": [v["x"]], "HiddenPrev": [v["h"]],
                                              "Weight": [v["w"]], "Bias": [v["b"]]},
                                 {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1}),
         ("x", "h", "w", "b"), 1e-4),
        ("im2sequence", "im2sequence", "%s, 3x3" % list(su["img"]), {"x": f32(*su["img"])},
         lambda L, v: L.im2sequence(v["x"], filter_size=3, stride=1), ("x",), 1e-5),
        ("warpctc", "warpctc", "logits %s, labels up to %d" % (list(su["ctc"]), su["ctc_label"]),
         {"logits": f32(cb, ct, cc), "label": rng.integers(1, cc, (cb, su["ctc_label"])),
          "llen": rng.integers(ct // 2, ct + 1, cb),
          "blen": rng.integers(su["ctc_label"] // 3, su["ctc_label"] + 1, cb)},
         lambda L, v: L.warpctc(v["logits"], v["label"], blank=0, norm_by_times=True,
                                input_length=v["llen"], label_length=v["blen"]),
         ("logits",), 1e-4),
        ("sequence_reshape", "sequence_reshape", S + " -> new_dim %d" % (2 * D),
         {"x": seq, "len": lens},
         lambda L, v: L.sequence_reshape(v["x"], 2 * D, seq_len=v["len"]), ("x",), 1e-5),
        ("sequence_scatter", "sequence_scatter",
         "[%d,%d] <- [%d,%d]" % (B, SENT["dict_size"], B, T),
         {"x": f32(B, SENT["dict_size"]), "ids": rng.integers(0, SENT["dict_size"], (B, T)),
          "upd": f32(B, T), "len": lens},
         lambda L, v: L.sequence_scatter(v["x"], v["ids"], v["upd"], seq_len=v["len"]),
         ("x", "upd"), 1e-5),
        ("chunk_eval", "chunk_eval", "[%d,%d], IOB, %d types" % (B, T, su["chunk_types"]),
         {"inf": rng.integers(0, 2 * su["chunk_types"] + 1, (B, T)),
          "lab": rng.integers(0, 2 * su["chunk_types"] + 1, (B, T)), "len": lens},
         lambda L, v: list(L.chunk_eval(v["inf"], v["lab"], "IOB", su["chunk_types"],
                                        seq_length=v["len"])), (), 0.0),
    ]
    return cases


def _merged_chi2(counts, p, min_expected=20.0):
    """Pearson's chi-square p-value of ``counts`` against ``p``, classes
    merged in order until each bin expects ``min_expected`` draws."""
    from scipy import stats as sstats

    n = counts.sum()
    obs, exp, o, e = [], [], 0.0, 0.0
    for c, q in zip(counts, p):
        o, e = o + c, e + n * q
        if e >= min_expected:
            obs.append(o)
            exp.append(e)
            o = e = 0.0
    if e:
        obs[-1] += o
        exp[-1] += e
    return float(sstats.chisquare(obs, exp).pvalue), len(obs)


def check_nce_sampler_on_card(torch):
    """nce's draw on the card: the same label sum twice gives the same
    negatives; NCE_CHI2_DRAWS label sums' negatives (10 each, over BERT's
    vocabulary) are the CPU's draws, id for id, and against each sampler's
    distribution a chi-square test gives p > 1e-3."""
    from paddle_tpu_torch.ops import nn_ops

    vocab, k = SEQ_UNIT["vocab"], SEQ_UNIT["neg"]
    dist = _nce_dist(vocab)
    c = np.arange(vocab, dtype=np.float64)
    want = {"uniform": np.full(vocab, 1.0 / vocab),
            "log_uniform": np.log((c + 2) / (c + 1)) / np.log(vocab + 1),
            "custom_dist": dist.astype(np.float64) / dist.sum()}
    out = {}
    for sampler, p in want.items():
        probs = torch.from_numpy(dist).to(CARD)
        probs = probs / torch.sum(probs)
        one = torch.tensor(123457, device=CARD)
        a = nn_ops.nce_negatives(one, 31, k, vocab, sampler, probs)
        b = nn_ops.nce_negatives(one, 31, k, vocab, sampler, probs)
        sums = torch.arange(NCE_CHI2_DRAWS, device=CARD)
        draws = nn_ops.nce_negatives(sums, 31, k, vocab, sampler, probs)
        cpu = nn_ops.nce_negatives(sums.cpu(), 31, k, vocab, sampler, probs.cpu())
        counts = np.bincount(draws.reshape(-1).cpu().numpy(), minlength=vocab)
        pvalue, bins = _merged_chi2(counts, p)
        out[sampler] = {"repeat_equal": bool(torch.equal(a, b)),
                        "equal_cpu": bool(torch.equal(draws.cpu(), cpu)), "chi2_p": pvalue,
                        "bins": bins, "draws": int(counts.sum())}
    log("[nce-sampler]", json.dumps(out))
    if not all(r["repeat_equal"] and r["equal_cpu"] and r["chi2_p"] > 1e-3 for r in out.values()):
        raise AssertionError("nce's sampler on the card: %s" % out)
    return out


def run_seq_unit_ops(torch):
    """Phase 31: every op type of A1b's second part at SEQ_UNIT's widths,
    each alone through ``Executor.run`` on cuda:0 by ``_measure_op_case``
    (captured with no eager op, bit for bit against eager, forward and vjp
    against the CPU, the replay's device time beside its bytes bound);
    then nce's sampler on the card (``check_nce_sampler_on_card``).  No
    attention or dropout kernel is launched."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import kernels

    _free_device_memory(torch)
    rng = np.random.default_rng(SEED + 31)
    cpu_exe = fluid.Executor(fluid.CPUPlace())
    rows, failures = [], []
    su = SEQ_UNIT
    B, T, D = su["seq"]
    ub, uh = su["unit"]
    flops = {"sequence_conv": 2 * B * T * 3 * D * su["filters"],  # the products of the window
             "gru_unit": 2 * ub * uh * 3 * uh}
    kernels.reset_launch_counts()
    for case in _seq_unit_op_cases(rng):
        row, ok = _measure_op_case(torch, fluid, cpu_exe, rng, case)
        if row["name"] in flops:  # bound by fp32 operations where those take longer
            row["ops_bound_ms"] = 1e3 * flops[row["name"]] / FP32_PEAK
        row["bound_ms"] = max(row["bytes_bound_ms"], row.get("ops_bound_ms", 0.0))
        row["bound_by"] = "operations" if row["bound_ms"] > row["bytes_bound_ms"] else "bytes"
        rows.append(row)
        if not ok:
            failures.append(row)
    launches = _hand_kernel_launches()
    sampler = check_nce_sampler_on_card(torch)
    stats = {"ops": rows, "op_types": len({r["op"] for r in rows}), "launches": launches,
             "nce_sampler": sampler, "failures": [r["name"] for r in failures]}
    log("[seq-unit-ops]", json.dumps(stats))
    if failures:
        raise AssertionError("sequence, RNN-unit and sampled-loss op types failed on the card: %s"
                             % failures)
    _no_hand_kernel("phase 31", launches)
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
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        _, deepfm_batches = run_deepfm_hbm(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run_deepfm_ps(torch, deepfm_batches)
    del deepfm_batches
    run_geo_and_descriptors(torch)
    nmt, nmt_state = run_nmt_train(torch)
    check_nmt_against_cpu(amp=False)
    check_nmt_against_cpu(amp=True)
    nmt_decode = run_nmt_decode(torch, nmt_state)
    del nmt_state
    book = run_book_rnn(torch)
    vgg, vgg_scope = run_vgg_train(torch)
    run_vgg_capture_check(torch)
    check_vgg_against_cpu(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run_vgg_serving(torch, workdir, vgg_scope)
        del vgg_scope
        core_ops = run_core_ops(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    sentiment, sentiment_scope = run_sentiment_train(torch)
    run_sentiment_capture_check(torch)
    check_sentiment_against_cpu(torch)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run_sentiment_serving(torch, workdir, sentiment_scope)
        del sentiment_scope
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seq_unit_ops = run_seq_unit_ops(torch)
    # the A7 paths (NMT training, decoding, the book's RNN models) run no hand kernel
    a7_launches = {"nmt_train": nmt["hand_kernel_launches"],
                   "nmt_decode": nmt_decode["hand_kernel_launches"],
                   "book_rnn": book["hand_kernel_launches"]}
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
    fwd_launches.update({p: c[fa.KERNEL_NAME] for p, c in a7_launches.items()})
    # phases 28 and 29 (VGG-16, the core op types) launch no attention kernel (checked)
    # and neither do phases 30 and 31 (the sentiment model, the sequence, RNN-unit
    # and sampled-loss op types)
    a1b_launches = {"vgg16": vgg["launches"], "core_ops": core_ops["launches"],
                    "sentiment": sentiment["launches"], "seq_unit_ops": seq_unit_ops["launches"]}
    fwd_launches.update({p: c[fa.KERNEL_NAME] for p, c in a1b_launches.items()})
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
                                     **{p: c.get(name, 0) for p, c in lamb_launches.items()},
                                     **{p: c[name] for p, c in a7_launches.items()},
                                     **{p: c[name] for p, c in a1b_launches.items()}),
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
        "launches": (sum(c.get("dropout", 0) for c in lm_launches.values())
                     + vgg["launches"]["dropout"]),
        "launches_by_path": dict({p: c.get("dropout", 0) for p, c in lm_launches.items()},
                                 **{p: c["dropout"] for p, c in a7_launches.items()},
                                 **{p: c["dropout"] for p, c in a1b_launches.items()}),
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
        "vgg16_sites": [r for r in dropout_checks["timed"] if r["p"] == 0.5],
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
