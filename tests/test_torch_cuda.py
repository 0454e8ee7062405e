"""paddle_tpu_torch on an NVIDIA card: the attention kernels (forward,
its row statistics, and the dK/dV and dQ backward kernels) against their
plain versions (on batches with an all-pad row too, and twice on the
same inputs, bit for bit), the small encoder served on the card against the CPU,
a small pretraining step on the card against the CPU, and the executor's
captured steps (CUDA graphs) against its eager path, with bf16 AMP; and
the causal LM slice: the dropout kernel bit for bit against its plain
version, the causal kernels at the LM's shape, every op type the slice
adds under capture, and the unfused dropout LM captured against eager;
and the rest of the training surface: each new optimizer op under
capture against the eager path (bit for bit) and against float64, the
EMA's and ModelAverage's backup across a captured step under ``apply``,
the reader's side-stream staging under a slow consumer, PyReader
feeding the captured step, and FLAGS_check_nan_inf on a replay; and
DeepFM: captured against eager bit for bit under deterministic
algorithms, a parameter-server ``Rows`` feed through two id buckets
(an entry and a graph each), the async Communicator's queue holding
host copies that a replay does not change, and GeoSGD's pulls landing
on the card and read by the next captured step; and the seq2seq
slice: bounded_while, static_rnn and dynamic_rnn training plans
captured bit for bit against eager, plans with a host-read loop or
branch (at any depth) staying eager and matching the CPU, and
beam_search / beam_search_decode on the card against the CPU, and the
decode's program logits captured on the card against the CPU; and a
``persistable`` toggle taking a fresh captured entry, every op type of
the math, tensor and plain nn part of the core layers under capture
(bit for bit against eager, and against the CPU), the host-read and
random ones staying eager, their layers trained captured against eager,
and VGG-16 under AMP with its dropouts captured against eager; and every
op type of the sequence, RNN-unit and sampled-loss part (nce with each
sampler, its negatives the CPU's draw) under capture, and their layers
trained captured against eager; and continuous-batching decode: kernel
B3 (int8-KV decode attention) against its plain version, the slot
pool's captured ``chunk`` against the same chunk run eagerly, zero
captures after warmup, and a resize across rungs while slots are live;
and a dense-PS trainer's captured steps against their eager twin (the
pulled parameters reach the graph), and a one-rank collective plan
captured; and kernel B2, ring attention's step (B1's forward with the
merge in its epilogue), against its plain version in place, and a ring
of steps against attention over the whole sequence; and the ring's
backward: each block's dQ, dK, dV by B1's dK/dV and dQ kernels from a
two-block ring's merged statistics against the plain version and, summed,
against float64 attention, and the differentiable ring of one rank.

Every test here needs a CUDA card and skips without one (marker
``cuda``).  The file imports neither jax nor paddle_tpu, so it also runs
where JAX is not installed; there, skip the repo's conftest (which
imports JAX):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: fp32 1e-4 (summation order: the kernels' 3xTF32
tensor-core products against cuBLAS).  bf16 atol 2e-2 plus rtol 2**-7: one to two bf16 ulps at any
output scale.  The plain version rounds scores and weights to bf16
where the kernel keeps fp32, and outputs of rows that attend few keys
(early causal rows) reach magnitude 4 to 8, where one bf16 ulp is
0.03.  The backward kernels take the same limits: fp32 at
1e-4 * max(1, max|ref|) (the products sum over up to 200 keys or
queries), bf16 at atol 2e-2 plus rtol 2**-7.  The log-sum-exp rebuilt
from the row statistics is fp32 in both dtypes, at 1e-4.  The encoder on the card against the CPU at 1e-4,
as the JAX/port run parity; a training step's loss and gradients at
1e-3 relative (fp32 sums in other orders through two layers forward and
back).  The captured-step tests state their own tolerances.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import kernels, serving
from paddle_tpu_torch.kernels import fused_attention as fa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2.0 ** -7)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(card, n, h, s, d, dtype, head_split, seed=0, all_pad=False):
    """Q, K, V and a padding Mask with row 0 all real; with ``all_pad``
    the last row is all pad (a batch padded with empty rows)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def make():
        if head_split:  # the [N, S, H, D] view the model's head split makes
            return torch.randn(n, s, h, d, generator=g, device=card).to(dtype).permute(0, 2, 1, 3)
        return torch.randn(n, h, s, d, generator=g, device=card).to(dtype)

    q, k, v = make(), make(), make()
    lens = torch.randint(1, s + 1, (n,), generator=g, device=card)
    lens[0] = s
    if all_pad:
        lens[-1] = 0
    mask = (torch.arange(s, device=card)[None, :] < lens[:, None]).float()
    return q, k, v, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,head_split", [
    ((16, 12, 128, 64), True), ((1, 12, 128, 64), True), ((3, 4, 77, 32), False),
    ((2, 2, 200, 128), False), ((2, 3, 5, 7), False),
], ids=["bert16", "bert1", "ragged77", "d128", "tiny"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_kernel_matches_plain(card, dtype, causal, shape, head_split, with_mask):
    q, k, v, mask = _inputs(card, *shape, dtype, head_split)
    mask = mask if with_mask else None
    scale = 1.0 / float(np.sqrt(shape[3]))
    kernels.reset_launch_counts()
    out = fa.fused_attention_fwd(q, k, v, mask, causal, scale)
    assert kernels.launch_counts()[fa.KERNEL_NAME] == 1
    ref = fa.fused_attention_plain(q, k, v, mask, causal, scale)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


CASES = [((16, 12, 128, 64), True), ((1, 12, 128, 64), True), ((3, 4, 77, 32), False),
         ((2, 2, 200, 128), False), ((2, 3, 5, 7), False)]
CASE_IDS = ["bert16", "bert1", "ragged77", "d128", "tiny"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,head_split", CASES, ids=CASE_IDS)
def test_lse_matches_logsumexp(card, dtype, causal, shape, head_split):
    q, k, v, mask = _inputs(card, *shape, dtype, head_split, seed=1)
    scale = 1.0 / float(np.sqrt(shape[3]))
    kernels.reset_launch_counts()
    out, stats = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_stats=True)
    assert kernels.launch_counts() == {fa.KERNEL_NAME: 1}
    ref_out = fa.fused_attention_plain(q, k, v, mask, causal, scale)
    # the kernel scores bf16 inputs in fp32: the reference statistics are
    # those of the fp32 scores of the same values
    _, ref_stats = fa.fused_attention_plain(q.float(), k.float(), v.float(), mask, causal, scale,
                                            return_stats=True)
    torch.cuda.synchronize()
    assert stats.dtype == torch.float32 and stats.shape == (2,) + q.shape[:3]
    torch.testing.assert_close(fa.row_lse(stats), fa.row_lse(ref_stats), atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(stats[0], ref_stats[0], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,head_split", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("with_stats", [False, True], ids=["out", "stats"])
def test_forward_all_pad_row(card, dtype, causal, shape, head_split, with_stats):
    """A batch whose last row is all pad: every score of it is -1e9, and
    the kernel must give each of its queries the uniform softmax over its
    keys, with row max -1e9 in the statistics.  Two launches on the same
    inputs give the same bits, and Out does not depend on whether the
    statistics are asked for."""
    q, k, v, mask = _inputs(card, *shape, dtype, head_split, seed=7, all_pad=True)
    scale = 1.0 / float(np.sqrt(shape[3]))
    runs = [fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_stats=with_stats)
            for _ in range(2)]
    plain_out = fa.fused_attention_fwd(q, k, v, mask, causal, scale)
    ref_out = fa.fused_attention_plain(q, k, v, mask, causal, scale)
    torch.cuda.synchronize()
    if with_stats:
        (out, stats), (out2, stats2) = runs
        _, ref_stats = fa.fused_attention_plain(q.float(), k.float(), v.float(), mask, causal,
                                                scale, return_stats=True)
        assert torch.equal(stats, stats2)
        torch.testing.assert_close(stats, ref_stats, atol=1e-4, rtol=1e-5)
        assert (stats[0, -1] == -1e9).all()
    else:
        out, out2 = runs
    assert torch.equal(out, out2) and torch.equal(out, plain_out)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,head_split", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_backward_kernels_match_plain(card, dtype, causal, shape, head_split, with_mask):
    _check_backward(card, dtype, causal, shape, head_split, with_mask, all_pad=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,head_split", CASES[:4], ids=CASE_IDS[:4])
def test_backward_kernels_all_pad_row(card, dtype, causal, shape, head_split):
    """A batch whose last row is all pad: every score of it is -1e9, and
    the kernels must rebuild P = 1/S (causal: 1/(i+1)) there."""
    _check_backward(card, dtype, causal, shape, head_split, True, all_pad=True)


def _check_backward(card, dtype, causal, shape, head_split, with_mask, all_pad):
    q, k, v, mask = _inputs(card, *shape, dtype, head_split, seed=2, all_pad=all_pad)
    mask = mask if with_mask else None
    scale = 1.0 / float(np.sqrt(shape[3]))
    d_out = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(3),
                        device=card).to(dtype)
    out, stats = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_stats=True)
    kernels.reset_launch_counts()
    grads = fa.fused_attention_bwd(q, k, v, mask, causal, scale, out, d_out, stats)
    assert kernels.launch_counts() == {fa.BWD_DKV_NAME: 1, fa.BWD_DQ_NAME: 1}
    refs = fa.fused_attention_bwd_plain(q, k, v, mask, causal, scale, out, d_out, stats)
    torch.cuda.synchronize()
    for name, g, ref, t in zip("QKV", grads, refs, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape, name
        assert torch.isfinite(g.float()).all(), name
        if dtype == torch.float32:
            err = (g - ref).abs().max().item()
            assert err <= 1e-4 * max(1.0, ref.abs().max().item()), (name, err)
        else:
            torch.testing.assert_close(g.float(), ref.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_backward_kernels_repeat_bit_for_bit(card, dtype):
    """No atomics: two launches of each kernel on the same inputs give
    the same bits."""
    q, k, v, mask = _inputs(card, 8, 12, 128, 64, dtype, True, seed=5, all_pad=True)
    d_out = torch.randn(8, 128, 12, 64, generator=torch.Generator(device=card).manual_seed(6),
                        device=card).to(dtype).permute(0, 2, 1, 3)
    out, stats = fa.fused_attention_fwd(q, k, v, mask, True, 0.125, return_stats=True)
    di = (out.float() * d_out.float()).sum(-1)
    runs = [fa.fused_attention_bwd_dkv(q, k, v, mask, True, 0.125, d_out, stats, di)
            + (fa.fused_attention_bwd_dq(q, k, v, mask, True, 0.125, d_out, stats, di),)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_autograd_through_kernels(card):
    """The op's gradient on a CUDA tensor runs the forward kernel with the
    row statistics, then the two backward kernels; nothing of the plain
    version."""
    q, k, v, mask = _inputs(card, 2, 4, 40, 16, torch.float32, True, seed=4)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    kernels.reset_launch_counts()
    out = fa.fused_attention_fwd(q, k, v, mask, False, 0.25)
    out.square().sum().backward()
    assert kernels.launch_counts() == {fa.KERNEL_NAME: 1, fa.BWD_DKV_NAME: 1, fa.BWD_DQ_NAME: 1}
    qc, kc, vc = (t.detach().cpu().requires_grad_(True) for t in (q, k, v))
    ref = fa.fused_attention_plain(qc, kc, vc, mask.cpu(), False, 0.25)
    ref.square().sum().backward()
    for g, r in ((q.grad, qc.grad), (k.grad, kc.grad), (v.grad, vc.grad)):
        torch.testing.assert_close(g.cpu(), r, atol=1e-4, rtol=1e-4)


def test_kernel_refuses_what_it_does_not_take(card):
    q, k, v, _ = _inputs(card, 1, 2, 8, 16, torch.float32, False)
    with pytest.raises(TypeError):
        fa.fused_attention_fwd(q.half(), k.half(), v.half())
    big = torch.randn(1, 1, 8, 160, device=card)
    with pytest.raises(ValueError, match="head dims"):
        fa.fused_attention_fwd(big, big, big)
    with pytest.raises(ValueError, match="unit stride"):
        fa.fused_attention_fwd(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    with pytest.raises(ValueError, match="Mask"):
        fa.fused_attention_fwd(q, k, v, torch.ones(1, 8))  # mask on the CPU


SMALL_BERT = dict(vocab_size=100, d_model=64, n_layer=2, n_head=4, d_inner=128,
                  max_pos=32, seq_len=16, dropout_rate=0.0, is_test=True,
                  fused_attention=True)
FEEDS = ["src_ids", "input_mask"]


def _bert_feed(rng, rows, s=16):
    ids = rng.randint(0, SMALL_BERT["vocab_size"], (rows, s)).astype("int64")
    lens = rng.randint(1, s + 1, rows)
    lens[0] = s
    return {"src_ids": ids,
            "input_mask": (np.arange(s)[None, :] < lens[:, None]).astype("float32")}


def test_encoder_on_card_matches_cpu_and_serves(card, tmp_path):
    from paddle_tpu_torch.models import transformer

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 6
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("src_ids", [16], dtype="int64")
        mask = tfluid.layers.data("input_mask", [16], dtype="float32")
        out = transformer.bert_encoder(ids, mask, **SMALL_BERT)
    exe = tfluid.Executor()
    assert exe.device == card
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.save_inference_model(str(tmp_path), FEEDS, [out], exe, main_program=main, scope=scope)
    gpu = tfluid.inference.create_paddle_predictor(tfluid.inference.AnalysisConfig(str(tmp_path)))
    cpu_cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    cpu_cfg.disable_gpu()
    cpu = tfluid.inference.create_paddle_predictor(cpu_cfg)
    rng = np.random.RandomState(3)
    feeds = [_bert_feed(rng, r) for r in (1, 3, 5)]
    for f in feeds:
        np.testing.assert_allclose(gpu.run(f)[0], cpu.run(f)[0], atol=1e-4, rtol=1e-4)
    server = serving.InferenceServer(gpu, max_batch_size=8)
    kernels.reset_launch_counts()
    try:
        server.warmup()
        answers = serving.Client(server).infer_many(feeds)
    finally:
        server.stop(drain=True, timeout=60)
    m = server.metrics()
    assert kernels.launch_counts()[fa.KERNEL_NAME] == 2 * (m["batches"] + m["warmup_runs"])
    for f, (o,) in zip(feeds, answers):
        np.testing.assert_allclose(o, gpu.run(f)[0], atol=1e-4, rtol=0)


def test_pretrain_step_on_card_matches_cpu(card):
    """One Adam step of the small pretraining program from the same state:
    loss and gradients on the card match the CPU within 1e-3 relative
    (the key biases' gradients, zero but for rounding, are held to 1e-6),
    and each step launches 2 dK/dV, 2 dQ and 4 forward kernels (2 layers;
    each grad op runs the forward again for its log-sum-exp)."""
    from paddle_tpu_torch.models import transformer

    cfg = dict(vocab_size=100, d_model=64, n_layer=2, n_head=4, d_inner=128, max_pos=64,
               seq_len=16, dropout_rate=0.0, fused_attention=True)
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 8
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        names = ["src_ids", "sent_ids", "input_mask", "mask_pos", "mask_label", "nsp_label"]
        shapes = [[16], [16], [16], [1], [1], [1]]
        dts = ["int64", "int64", "float32", "int64", "int64", "int64"]
        ins = [tfluid.layers.data(n, s, dtype=d) for n, s, d in zip(names, shapes, dts)]
        total, _, _ = transformer.bert_pretrain(*ins, **cfg)
        _, pg = tfluid.optimizer.AdamOptimizer(1e-4).minimize(total)
    rng = np.random.RandomState(0)
    feed = {"src_ids": rng.randint(0, 100, (3, 16)), "sent_ids": np.zeros((3, 16), "int64"),
            "input_mask": np.ones((3, 16), "float32"),
            "mask_pos": np.array([[1], [5], [17], [20], [40], [47]]),
            "mask_label": rng.randint(0, 100, (6, 1)), "nsp_label": np.array([[0], [1], [1]])}
    feed["input_mask"][1, 10:] = 0
    gexe = tfluid.Executor()
    gscope = tfluid.Scope()
    gexe.run(startup, scope=gscope)
    cexe = tfluid.Executor(tfluid.CPUPlace())
    cscope = tfluid.Scope()
    tfluid.io.set_params_from_numpy(
        cscope, {n: v.cpu().numpy() for n, v in gscope.vars.items()}, "cpu")
    fetch = [total] + [g for _, g in pg]
    kernels.reset_launch_counts()
    gres = gexe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
    assert kernels.launch_counts() == {fa.KERNEL_NAME: 4, fa.BWD_DKV_NAME: 2, fa.BWD_DQ_NAME: 2}
    cres = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope)
    for (p, _), g, c in zip([(total, None)] + pg, gres, cres):
        assert np.isfinite(g).all()
        if p.name.endswith("_att_k_b"):
            # zero in exact arithmetic (the softmax cancels a bias on the
            # keys): both devices give rounding noise, held to its size
            assert np.abs(g).max() < 1e-6 and np.abs(c).max() < 1e-6, p.name
            continue
        assert np.abs(g - c).max() <= 1e-3 * np.abs(c).max(), p.name


# ---------------------------------------------------------------------------
# captured steps (CUDA graphs) and bf16 AMP on the card
# ---------------------------------------------------------------------------
PRETRAIN_CFG = dict(vocab_size=97, d_model=64, n_layer=2, n_head=4, d_inner=128, max_pos=64,
                    seq_len=16, dropout_rate=0.0, fused_attention=True)
PER_STEP = {fa.KERNEL_NAME: 4, fa.BWD_DKV_NAME: 2, fa.BWD_DQ_NAME: 2}  # 2 layers


def _pretrain(amp=False, seed=8):
    from paddle_tpu_torch.contrib import mixed_precision
    from paddle_tpu_torch.models import transformer

    s = PRETRAIN_CFG["seq_len"]
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ins = [tfluid.layers.data(n, [w], dtype=d) for n, w, d in (
            ("src_ids", s, "int64"), ("sent_ids", s, "int64"), ("input_mask", s, "float32"),
            ("mask_pos", 1, "int64"), ("mask_label", 1, "int64"), ("nsp_label", 1, "int64"))]
        total, _, _ = transformer.bert_pretrain(*ins, **PRETRAIN_CFG)
        opt = tfluid.optimizer.AdamOptimizer(1e-4)
        if amp:
            opt = mixed_precision.decorate(opt)
        _, pg = opt.minimize(total)
    return main, startup, total, pg


def _pretrain_feed(rng, rows=4, masks=3):
    s, vocab = PRETRAIN_CFG["seq_len"], PRETRAIN_CFG["vocab_size"]
    lens = rng.randint(s // 2, s + 1, rows)
    lens[0] = s
    pos = np.stack([rng.choice(np.arange(1, lens[i]), masks, replace=False) + i * s
                    for i in range(rows)])
    return {"src_ids": rng.randint(0, vocab, (rows, s)),
            "sent_ids": (np.arange(s)[None, :] >= (lens[:, None] // 2)).astype("int64"),
            "input_mask": (np.arange(s)[None, :] < lens[:, None]).astype("float32"),
            "mask_pos": pos.reshape(-1, 1), "mask_label": rng.randint(0, vocab, (rows * masks, 1)),
            "nsp_label": rng.randint(0, 2, (rows, 1))}


def _state(scope):
    return {n: v.detach().cpu().numpy() for n, v in scope.vars.items()}


def _scope_from(state, device):
    scope = tfluid.Scope()
    tfluid.io.set_params_from_numpy(scope, state, device)
    return scope


def test_captured_step_matches_eager(card):
    """Three steps through the cached executor (its entry warmed first on
    a scope of its own, so the three are captured and replayed, then
    replayed twice) against three eager runs (``use_program_cache=False``)
    from the same state.  The captured first step runs the same kernels
    on the same inputs as the eager one, so its loss is bit-equal.  Later
    state is held to
    rtol 1e-5 (loss) and atol 1e-6 (parameters): the word embedding's
    gradient comes from ``index_select``'s backward (``index_add_``) and
    the masked-token and label picks from ``torch.gather``'s
    (``scatter_add_``), which add with atomics in an order that varies
    from run to run, eager or captured.  The key biases, whose true
    gradient is zero, are held to Adam's step bound (2 * lr a step)."""
    main, startup, total, pg = _pretrain()
    exe = tfluid.Executor()
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    init = _state(scope)
    feeds = [_pretrain_feed(np.random.RandomState(i)) for i in range(3)]
    exe.run(main, feed=feeds[0], fetch_list=[total], scope=_scope_from(init, card))  # warm-up
    ref_exe, ref_scope = tfluid.Executor(), _scope_from(init, card)
    got, ref = [], []
    for f in feeds:
        got.append(exe.run(main, feed=f, fetch_list=[total], scope=scope)[0])
        ref.append(ref_exe.run(main, feed=f, fetch_list=[total], scope=ref_scope,
                               use_program_cache=False)[0])
    assert exe.jit_cache_stats()["graphs"] == 1
    assert ref_exe.jit_cache_stats()["graphs"] == ref_exe.jit_cache_stats()["entries"] == 0
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(np.array(got), np.array(ref), rtol=1e-5)
    for p, _ in pg:
        a, b = _state(scope)[p.name], _state(ref_scope)[p.name]
        tol = 2 * 1e-4 * 3 if p.name.endswith("_att_k_b") else 1e-6
        assert np.abs(a - b).max() <= tol, p.name


def test_launch_counts_under_replay(card):
    """Each step counts its kernels once, whether it ran eagerly, was
    captured and replayed, or replayed; ``steps=3`` counts three."""
    main, startup, total, _ = _pretrain()
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = _pretrain_feed(np.random.RandomState(0))
    for _ in range(3):
        kernels.reset_launch_counts()
        exe.run(main, feed=feed, fetch_list=[total], scope=scope)
        assert kernels.launch_counts() == PER_STEP
    kernels.reset_launch_counts()
    exe.run(main, feed=feed, fetch_list=[total], scope=scope, steps=3)  # a new entry: eager
    exe.run(main, feed=feed, fetch_list=[total], scope=scope, steps=3)  # captured, replayed 3x
    assert kernels.launch_counts() == {k: 6 * v for k, v in PER_STEP.items()}
    assert kernels.launch_counts_by_dtype()[fa.KERNEL_NAME] == {"float32": 24}


def test_steps_and_per_step_feed_on_card(card):
    """``steps=3, per_step_feed=True`` against three single captured runs
    from the same state, at the tolerance of the test above."""
    main, startup, total, _ = _pretrain()
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    init = _state(scope)
    feeds = [_pretrain_feed(np.random.RandomState(i)) for i in range(3)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    for f in feeds:  # warm the single-step entry, then restore the state
        exe.run(main, feed=f, fetch_list=[total], scope=scope)
    tfluid.io.set_params_from_numpy(scope, init, card)
    singles = [exe.run(main, feed=f, fetch_list=[total], scope=scope)[0] for f in feeds]
    after_singles = _state(scope)
    multi_exe, multi_scope = tfluid.Executor(), _scope_from(init, card)
    multi_exe.run(main, feed=stacked, fetch_list=[total], scope=multi_scope, steps=3,
                  per_step_feed=True)  # eager warm-up of the entry
    tfluid.io.set_params_from_numpy(multi_scope, init, card)
    last, = multi_exe.run(main, feed=stacked, fetch_list=[total], scope=multi_scope, steps=3,
                          per_step_feed=True)
    assert multi_exe.jit_cache_stats()["graphs"] == 1
    np.testing.assert_allclose(last, singles[-1], rtol=1e-5)
    for n, v in _state(multi_scope).items():
        tol = 2 * 1e-4 * 3 if n.endswith("_att_k_b") else 1e-6
        assert np.abs(v - after_singles[n].reshape(v.shape)).max() <= tol, n


def test_replaced_scope_tensor_is_picked_up(card):
    """A scope tensor replaced behind a captured graph's back (here by
    ``set_params_from_numpy``, and by an eager run) is copied into the
    graph's buffer before the next replay: the replay reads the new
    weights, never stale ones."""
    main, startup, total, pg = _pretrain()
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    init = _state(scope)
    feed = _pretrain_feed(np.random.RandomState(1))
    first = exe.run(main, feed=feed, fetch_list=[total], scope=scope)[0]
    exe.run(main, feed=feed, fetch_list=[total], scope=scope)  # captured
    tfluid.io.set_params_from_numpy(scope, init, card)
    again = exe.run(main, feed=feed, fetch_list=[total], scope=scope)[0]  # replayed
    np.testing.assert_allclose(again, first, rtol=1e-6)
    # an eager run writes new tensors into the scope; the replay after it
    # continues from them
    exe.run(main, feed=feed, fetch_list=[total], scope=scope, use_program_cache=False)
    ref_scope = _scope_from(_state(scope), card)
    nxt = exe.run(main, feed=feed, fetch_list=[total], scope=scope)[0]
    ref = tfluid.Executor().run(main, feed=feed, fetch_list=[total], scope=ref_scope,
                                use_program_cache=False)[0]
    np.testing.assert_allclose(nxt, ref, rtol=1e-6)


def test_random_op_is_never_captured(card):
    """A plan with random ops (a startup program's ``uniform_random``)
    stays on the interpreter, whose generators are seeded by the op: one
    executor runs the startup program on a fresh scope, again on it and on
    a second scope, captures nothing, and gives the same values each time."""
    _, startup, _, _ = _pretrain()
    exe, scope_a, scope_b = tfluid.Executor(), tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=scope_a)
    first = _state(scope_a)
    exe.run(startup, scope=scope_a)
    exe.run(startup, scope=scope_b)
    stats = exe.jit_cache_stats()
    assert stats["graphs"] == 0 and stats["hits"] == 2 and stats["misses"] == 1
    for n, v in first.items():
        np.testing.assert_array_equal(_state(scope_a)[n], v, err_msg=n)
        np.testing.assert_array_equal(_state(scope_b)[n], v, err_msg=n)


def test_second_scope_gets_its_own_graph(card):
    """One executor captures a step on scope A, then runs it on scope B:
    B gets a graph of its own over its own tensors.  A's state is
    untouched by B's runs, the two scopes share no tensor, and B's step
    equals an eager step from B's state (the tolerance of
    test_captured_step_matches_eager)."""
    main, startup, total, pg = _pretrain()
    exe = tfluid.Executor()
    boot = tfluid.Scope()
    exe.run(startup, scope=boot)
    init = _state(boot)
    feed = _pretrain_feed(np.random.RandomState(4))
    scope_a = _scope_from(init, card)
    for _ in range(2):  # eager, then captured
        exe.run(main, feed=feed, fetch_list=[total], scope=scope_a)
    after_a = _state(scope_a)
    b_init = {n: v * 0.5 if n in {p.name for p, _ in pg} else v for n, v in init.items()}
    scope_b = _scope_from(b_init, card)
    got = [exe.run(main, feed=feed, fetch_list=[total], scope=scope_b)[0] for _ in range(2)]
    assert exe.jit_cache_stats()["graphs"] == 2
    for n, v in after_a.items():
        np.testing.assert_array_equal(_state(scope_a)[n], v, err_msg=n)
    ptrs_a = {t.data_ptr() for t in scope_a.vars.values()}
    assert not ptrs_a & {t.data_ptr() for t in scope_b.vars.values()}
    ref_exe, ref_scope = tfluid.Executor(), _scope_from(b_init, card)
    ref = [ref_exe.run(main, feed=feed, fetch_list=[total], scope=ref_scope,
                       use_program_cache=False)[0] for _ in range(2)]
    np.testing.assert_allclose(np.array(got), np.array(ref), rtol=1e-5)
    for p, _ in pg:
        tol = 2 * 1e-4 * 2 if p.name.endswith("_att_k_b") else 1e-6
        assert np.abs(_state(scope_b)[p.name] - _state(ref_scope)[p.name]).max() <= tol, p.name


def test_threads_share_a_captured_bucket(card):
    """Four threads run one captured serving bucket (the eval program,
    one feed signature) with feeds of their own, 20 times each: every
    answer is its own feed's, as an eager run gives it (rtol 1e-6: the
    eval forward has no atomics), never another thread's."""
    main, startup, total, _ = _pretrain()
    test_prog = main.clone(for_test=True)
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [_pretrain_feed(np.random.RandomState(10 + i)) for i in range(4)]
    ref = [exe.run(test_prog, feed=f, fetch_list=[total], scope=scope,
                   use_program_cache=False)[0] for f in feeds]
    for f in feeds[:2]:  # eager, then captured, on this thread
        exe.run(test_prog, feed=f, fetch_list=[total], scope=scope)
    errors = []

    def worker(i):
        try:
            for _ in range(20):
                out, = exe.run(test_prog, feed=feeds[i], fetch_list=[total], scope=scope)
                np.testing.assert_allclose(out, ref[i], rtol=1e-6)
        except Exception as e:  # reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[0]
    assert exe.jit_cache_stats()["graphs"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_attention_op_takes_bf16_mask(card, dtype):
    """The AMP rewrite casts every float input of a white op, the padding
    Mask too: the op gives the same bits with a bf16 Mask (0 and 1 are
    exact in bf16) as with the fp32 one."""
    from paddle_tpu_torch.core import registry

    q, k, v, mask = _inputs(card, 4, 4, 16, 16, dtype, head_split=False)
    attn = registry.get_kernel("fused_attention")
    attrs = {"causal": False, "scale": 0.25}
    a = attn({"Q": [q], "K": [k], "V": [v], "Mask": [mask]}, attrs, card)["Out"]
    b = attn({"Q": [q], "K": [k], "V": [v], "Mask": [mask.to(torch.bfloat16)]}, attrs, card)["Out"]
    assert torch.equal(a, b)


def test_amp_step_on_card_matches_cpu(card):
    """One AMP Adam step of the small pretraining from the same state, on
    the card (bf16 kernels: cuBLAS and the attention kernels' bf16
    instantiations) and on the CPU (the plain versions): the loss within
    5e-3 relative and each gradient within 3e-2 of its largest magnitude
    (bf16 rounds each product's inputs and output to 8 bits of mantissa,
    and the two devices sum in different orders), and bf16 launches."""
    main, startup, total, pg = _pretrain(amp=True)
    gexe, gscope = tfluid.Executor(), tfluid.Scope()
    gexe.run(startup, scope=gscope)
    cexe, cscope = tfluid.Executor(tfluid.CPUPlace()), _scope_from(_state(gscope), "cpu")
    feed = _pretrain_feed(np.random.RandomState(2))
    fetch = [total] + [g for _, g in pg]
    kernels.reset_launch_counts()
    gres = gexe.run(main, feed=feed, fetch_list=fetch, scope=gscope)
    assert kernels.launch_counts_by_dtype() == {k: {"bfloat16": n} for k, n in PER_STEP.items()}
    cres = cexe.run(main, feed=feed, fetch_list=fetch, scope=cscope)
    np.testing.assert_allclose(gres[0], cres[0], rtol=5e-3)
    for (p, _), g, c in zip(pg, gres[1:], cres[1:]):
        assert np.isfinite(g).all() and g.dtype == np.float32, p.name
        if not p.name.endswith("_att_k_b"):
            assert np.abs(g - c).max() <= 3e-2 * np.abs(c).max(), p.name
    for p, _ in pg:
        assert gscope.get(p.name).dtype == torch.float32, p.name


# ---------------------------------------------------------------------------
# the LeNet / ResNet slice on the card: fetches, captured steps with
# in-place state, checkpoints, and every new op type under capture
# ---------------------------------------------------------------------------
def _image_model(model="resnet18", fmt="NHWC", hw=64, amp=False, seed=42, lr=0.01):
    from paddle_tpu_torch import models
    from paddle_tpu_torch.contrib import mixed_precision

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        if model == "lenet5":
            img = tfluid.layers.data("img", [1, 28, 28])
        else:
            img = tfluid.layers.data("img", [3, hw, hw] if fmt == "NCHW" else [hw, hw, 3])
        lbl = tfluid.layers.data("lbl", [1], dtype="int64")
        if model == "lenet5":
            loss, _, _ = models.lenet5(img, lbl)
        else:
            loss, _, _ = getattr(models.resnet, model)(img, lbl, class_num=10, data_format=fmt)
        opt = tfluid.optimizer.MomentumOptimizer(lr, 0.9)
        if amp:
            opt = mixed_precision.decorate(opt)
        opt.minimize(loss)
    return main, startup, loss


def _image_feed(seed, model="resnet18", fmt="NHWC", hw=64, batch=4):
    rng = np.random.RandomState(seed)
    if model == "lenet5":
        shape = [batch, 1, 28, 28]
    else:
        shape = [batch, 3, hw, hw] if fmt == "NCHW" else [batch, hw, hw, 3]
    return {"img": rng.uniform(0, 1, shape).astype("float32"),
            "lbl": rng.randint(0, 10, (batch, 1)).astype("int64")}


def test_fetched_parameter_survives_capture_and_replay(card):
    """A parameter fetched with ``return_numpy=False`` on the entry's eager
    run is the scope's own tensor unless the executor copies it; the next
    run captures the graph over that tensor and the one after replays into
    it.  The fetched tensor must keep the value it was returned with."""
    main, startup, loss = _image_model("lenet5", "NCHW")
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    w = "conv2d_0.w_0"
    got, = exe.run(main, feed=_image_feed(0, "lenet5"), fetch_list=[w], scope=scope,
                   return_numpy=False)
    first = got.detach().cpu().clone()
    for i in (1, 2):  # captured, then replayed
        exe.run(main, feed=_image_feed(i, "lenet5"), fetch_list=[loss], scope=scope)
    assert exe.jit_cache_stats()["graphs"] == 1
    assert torch.equal(got.cpu(), first)
    assert not torch.equal(scope.get(w).cpu(), first)  # the parameter itself moved on


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_captured_resnet_step_matches_eager(card, fmt, monkeypatch):
    """ResNet-18 at 64x64, batch 4: three Momentum steps through the cached
    executor (its entry warmed on a scope of its own, so the three are a
    capture and two replays) against three eager steps from the same
    state, bit for bit: the losses, the parameters, the velocities and the
    running statistics, which batch_norm reads and writes in place
    (MeanOut is Mean), so they enter the graph's state buffers and are
    written back at each replay.  cuDNN is held to its deterministic
    algorithms: its default weight gradients add with atomics, so two
    eager runs already differ, and a random ResNet's gradients amplify
    that by the third step."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    main, startup, loss = _image_model("resnet18", fmt)
    exe, boot = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=boot)
    init = _state(boot)
    feeds = [_image_feed(i, "resnet18", fmt) for i in range(3)]
    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))  # warm-up
    scope, ref_exe, ref_scope = _scope_from(init, card), tfluid.Executor(), _scope_from(init, card)
    got, ref = [], []
    for f in feeds:
        got.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
        ref.append(ref_exe.run(main, feed=f, fetch_list=[loss], scope=ref_scope,
                               use_program_cache=False)[0])
    assert exe.jit_cache_stats()["graphs"] == 1
    np.testing.assert_array_equal(np.array(got), np.array(ref))
    a, b = _state(scope), _state(ref_scope)
    stats = [n for n in a if n.endswith((".mean_0", ".variance_0"))]
    assert len(stats) == 40 and any(n.endswith("_velocity_0") for n in a)
    for n in stats:
        assert not np.array_equal(a[n], init[n]), n  # the graph wrote them back
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_resnet_checkpoint_round_trip_on_card(card, tmp_path):
    """Two steps (the entry's eager run, then its capture), save_persistables,
    load_persistables into a fresh scope on the card: the next step there
    (a capture over the new scope's tensors) gives the uninterrupted
    run's loss (a replay; the same forward kernels, rtol 1e-6) and the
    same running statistics."""
    main, startup, loss = _image_model("resnet18", "NHWC")
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    feeds = [_image_feed(10 + i) for i in range(3)]
    for f in feeds[:2]:
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
    tfluid.io.save_persistables(exe, str(tmp_path), main, scope=scope)
    fresh = tfluid.Scope()
    tfluid.io.load_persistables(exe, str(tmp_path), main, scope=fresh)
    assert sorted(fresh.vars) == sorted(scope.vars)
    ref, = exe.run(main, feed=feeds[2], fetch_list=[loss], scope=scope)
    got, = exe.run(main, feed=feeds[2], fetch_list=[loss], scope=fresh)
    assert exe.jit_cache_stats()["graphs"] == 2
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    a, b = _state(fresh), _state(scope)
    for n in a:
        if n.endswith((".mean_0", ".variance_0")):
            np.testing.assert_allclose(a[n], b[n], rtol=1e-6, atol=1e-7, err_msg=n)


def _one_op(card, op_type, inputs, attrs, out_slots, state):
    """A program of one op over ``inputs`` (numpy): feeds, and the slots in
    ``state`` as persistable vars the op also writes (batch_norm's running
    statistics, momentum's parameter and velocity)."""
    main = tfluid.Program()
    blk = main.global_block()
    feed = {}
    for slot, arr in inputs.items():
        blk.create_var(name=slot.lower(), shape=arr.shape, dtype=str(arr.dtype),
                       persistable=slot in state)
        if slot not in state:
            feed[slot.lower()] = arr
    outputs = {s: [state.get(s, s.lower() + "_out")] for s in out_slots}
    for s in out_slots:
        if s not in state:
            blk.create_var(name=s.lower() + "_out", dtype="float32")
    blk.append_op(op_type, inputs={s: [s.lower()] for s in inputs}, outputs=outputs, attrs=attrs)
    scope_init = {s.lower(): a for s, a in inputs.items() if s in state}
    return main, feed, [outputs[s][0] for s in out_slots], scope_init


def _f32(rng, *shape):
    return rng.randn(*shape).astype("float32")


def _op_cases():
    rng = np.random.RandomState(3)
    probs = np.exp(_f32(rng, 8, 10))
    probs /= probs.sum(-1, keepdims=True)
    bn = {"X": _f32(rng, 4, 6, 6, 8), "Scale": _f32(rng, 8), "Bias": _f32(rng, 8),
          "Mean": _f32(rng, 8), "Variance": np.abs(_f32(rng, 8)) + 0.5}
    mom = {"Param": _f32(rng, 5, 7), "Grad": _f32(rng, 5, 7), "Velocity": _f32(rng, 5, 7),
           "LearningRate": np.array([0.1], "float32")}
    return {
        "relu": ("relu", {"X": _f32(rng, 4, 9)}, {}, ("Out",), {}),
        "softmax": ("softmax", {"X": _f32(rng, 4, 9)}, {"axis": -1}, ("Out",), {}),
        "cross_entropy": ("cross_entropy",
                          {"X": probs.astype("float32"),
                           "Label": rng.randint(0, 10, (8, 1)).astype("int64")},
                          {}, ("Y",), {}),
        "conv2d": ("conv2d", {"Input": _f32(rng, 2, 9, 9, 4), "Filter": _f32(rng, 6, 2, 3, 3)},
                   {"strides": [2, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 2,
                    "data_format": "NHWC"}, ("Output",), {}),
        "pool2d": ("pool2d", {"X": _f32(rng, 2, 3, 9, 9)},
                   {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                    "paddings": [1, 1], "ceil_mode": True}, ("Out",), {}),
        "batch_norm": ("batch_norm", bn, {"is_test": False, "data_layout": "NHWC"},
                       ("Y", "MeanOut", "VarianceOut"),
                       {"Mean": "mean", "Variance": "variance", "MeanOut": "mean",
                        "VarianceOut": "variance"}),
        "batch_norm_test": ("batch_norm", bn, {"is_test": True, "data_layout": "NHWC"},
                            ("Y", "MeanOut", "VarianceOut"),
                            {"Mean": "mean", "Variance": "variance", "MeanOut": "mean",
                             "VarianceOut": "variance"}),
        "momentum": ("momentum", mom, {"mu": 0.9, "use_nesterov": True},
                     ("ParamOut", "VelocityOut"),
                     {"Param": "param", "Velocity": "velocity", "LearningRate": "learningrate",
                      "ParamOut": "param", "VelocityOut": "velocity"}),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_new_op_type_under_capture(card, case):
    """Each op type of the slice, alone in a program, through the cached
    executor: an eager run, a capture, two replays, against the same runs
    through the eager path (``use_program_cache=False``) on a scope of its
    own, within 1e-6 (the same kernels; a reduction may take another
    order).  State the op writes (batch_norm's running statistics, in
    place, also in ``is_test`` mode where MeanOut is the unchanged Mean
    tensor itself; momentum's parameter and velocity) goes back to the
    scope at every replay."""
    op_type, inputs, attrs, out_slots, state = _op_cases()[case]
    main, feed, fetch, init = _one_op(card, op_type, inputs, attrs, out_slots, state)
    exe, scope = tfluid.Executor(), _scope_from(init, card)
    ref_exe, ref_scope = tfluid.Executor(), _scope_from(init, card)
    for _ in range(4):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        ref = ref_exe.run(main, feed=feed, fetch_list=fetch, scope=ref_scope,
                          use_program_cache=False)
        for n, g, r in zip(fetch, got, ref):
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6, err_msg=n)
    assert exe.jit_cache_stats()["graphs"] == 1
    for n, v in _state(ref_scope).items():
        np.testing.assert_allclose(_state(scope)[n], v, rtol=1e-6, atol=1e-6, err_msg=n)


def test_gaussian_random_startup_stays_eager(card):
    """ResNet's startup draws every filter with gaussian_random: a random
    plan, never captured, whose seeded generators give the same values on
    every run."""
    _, startup, _ = _image_model("resnet18", "NHWC")
    assert "gaussian_random" in {op.type for op in startup.global_block().ops}
    exe, a, b = tfluid.Executor(), tfluid.Scope(), tfluid.Scope()
    for s in (a, a, b):
        exe.run(startup, scope=s)
    assert exe.jit_cache_stats()["graphs"] == 0
    for n, v in _state(a).items():
        np.testing.assert_array_equal(_state(b)[n], v, err_msg=n)


def test_amp_resnet_step_on_card_matches_cpu(card):
    """One AMP Momentum step of ResNet-18 (NHWC, 64x64, batch 4) from the
    same state, on the card (cuDNN's bf16 NHWC kernels) and on the CPU:
    the losses within 2e-2 relative (bf16 rounds each conv's inputs to 8
    bits of mantissa; the CPU test of the port against the JAX package
    reads 2e-3 to 1.1e-2), every parameter fp32 and finite."""
    main, startup, loss = _image_model("resnet18", "NHWC", amp=True)
    gexe, gscope = tfluid.Executor(), tfluid.Scope()
    gexe.run(startup, scope=gscope)
    cexe, cscope = tfluid.Executor(tfluid.CPUPlace()), _scope_from(_state(gscope), "cpu")
    feed = _image_feed(5)
    g, = gexe.run(main, feed=feed, fetch_list=[loss], scope=gscope)
    c, = cexe.run(main, feed=feed, fetch_list=[loss], scope=cscope)
    np.testing.assert_allclose(g, c, rtol=2e-2)
    for p in main.all_parameters():
        t = gscope.get(p.name)
        assert t.dtype == torch.float32 and bool(torch.isfinite(t).all()), p.name


def test_no_garbage_collection_while_capturing(card, monkeypatch):
    """A cyclic collection on the capturing thread can destroy another,
    dead graph (an old executor's, held in a reference cycle), which
    invalidates the capture (cudaErrorStreamCaptureInvalidated; seen in a
    full card run of this file).  The executor keeps the collector off for
    the capture and turns it back on after."""
    import gc

    from paddle_tpu_torch.core import registry

    main, feed, fetch, _ = _one_op(card, *_op_cases()["relu"])
    seen = []
    relu = registry.get_op("relu")
    kernel = relu.kernel

    def spy(inputs, attrs, device):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return kernel(inputs, attrs, device)

    monkeypatch.setattr(relu, "kernel", spy)  # after the program's shape inference ran it
    exe, scope = tfluid.Executor(), tfluid.Scope()
    assert gc.isenabled()
    for _ in range(3):  # eager, captured, replayed
        exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    assert exe.jit_cache_stats()["graphs"] == 1
    assert seen == [(False, True), (True, False)]
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# the causal LM slice: the dropout kernel, the causal kernels at the LM's
# shape, the slice's op types under capture, and the unfused dropout LM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 256, 2048), (2, 8, 256, 256), (7, 1001), (3,)],
                         ids=["ffn", "weights", "odd", "tiny"])
def test_dropout_kernel_bit_equal_to_plain(card, shape, dtype, impl):
    """Out and Mask of the kernel equal the plain version's (the same
    Philox in torch's int64 ops, on the card) bit for bit, on an aligned
    tensor and on a view one element in (the kernel's unaligned path)."""
    from paddle_tpu_torch.kernels import dropout as kd

    x = torch.randn(shape, generator=torch.Generator(device=card).manual_seed(9),
                    device=card).to(dtype)
    up = impl == "upscale_in_train"
    for t in (x, x.reshape(-1)[1:]):
        kernels.reset_launch_counts()
        out, mask = kd.dropout_train(t, 0.3, 4242, up)
        assert kernels.launch_counts() == ({kd.KERNEL_NAME: 1} if t.numel() else {})
        ref_out, ref_mask = kd.dropout_plain(t, 0.3, 4242, up)
        torch.cuda.synchronize()
        assert out.dtype == mask.dtype == dtype and out.shape == t.shape
        assert torch.equal(out, ref_out) and torch.equal(mask, ref_mask)
        # and the CPU's plain version draws the same mask
        assert torch.equal(mask.cpu(), kd.dropout_plain(t.cpu(), 0.3, 4242, up)[1])


def test_dropout_refuses_what_it_does_not_take(card):
    from paddle_tpu_torch.kernels import dropout as kd

    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            kd.dropout_train(torch.ones(8, device=card, dtype=dt), 0.5, 1, False)


def test_dropout_gradient_on_card(card):
    """dX = where(Mask, dOut / (1 - p), 0) through the autograd Function,
    the kernel launched once."""
    from paddle_tpu_torch.kernels import dropout as kd

    x = torch.randn(6, 50, device=card, requires_grad=True)
    kernels.reset_launch_counts()
    out, mask = kd.dropout_train(x, 0.25, 5, True)
    g = torch.randn_like(out)
    out.backward(g)
    assert kernels.launch_counts() == {kd.KERNEL_NAME: 1}
    want = torch.where(mask != 0, g / torch.full_like(g, 0.75), 0.0)
    assert torch.equal(x.grad, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_causal_kernels_at_lm_shape(card, dtype):
    """The LM's attention: causal, no Mask, [N, 8, 256, 64] in the head
    split's layout, forward and backward against the plain versions."""
    q, k, v, _ = _inputs(card, 4, 8, 256, 64, dtype, True, seed=12)
    out = fa.fused_attention_fwd(q, k, v, None, True, 0.125)
    ref = fa.fused_attention_plain(q, k, v, None, True, 0.125)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    _check_backward(card, dtype, True, (4, 8, 256, 64), True, False, all_pad=False)


def _lm_op_cases():
    rng = np.random.RandomState(17)
    x, y = _f32(rng, 4, 9), _f32(rng, 4, 9)
    pos = np.abs(x) + 0.5
    cases = {}
    for op in ("elementwise_sub", "elementwise_mul", "elementwise_min", "elementwise_max"):
        cases[op] = (op, {"X": x, "Y": _f32(rng, 9)}, {"axis": -1}, ("Out",), {})
    cases["elementwise_div"] = ("elementwise_div", {"X": x, "Y": pos}, {"axis": -1}, ("Out",), {})
    cases["elementwise_pow"] = ("elementwise_pow", {"X": pos, "Y": y}, {"axis": -1}, ("Out",), {})
    for op in ("sqrt", "rsqrt", "log", "reciprocal"):
        cases[op] = (op, {"X": pos}, {}, ("Out",), {})
    for op in ("square", "exp", "abs", "ceil", "floor", "round", "sign", "cos", "sin",
               "logsigmoid", "relu6", "sigmoid", "leaky_relu", "elu", "softplus", "softsign",
               "swish", "hard_sigmoid", "hard_swish", "thresholded_relu", "stanh", "soft_relu",
               "brelu", "gelu", "tanh"):
        cases[op] = (op, {"X": x}, {}, ("Out",), {})
    cases["clip"] = ("clip", {"X": x}, {"min": -0.5, "max": 0.5}, ("Out",), {})
    cases["clip_by_norm"] = ("clip_by_norm", {"X": x}, {"max_norm": 1.0}, ("Out",), {})
    cases["reduce_sum"] = ("reduce_sum", {"X": x}, {"dim": [1], "keep_dim": False,
                                                  "reduce_all": False}, ("Out",), {})
    cases["reduce_sum_all"] = ("reduce_sum", {"X": x}, {"dim": [0], "reduce_all": True}, ("Out",), {})
    b1, b2 = x > 0, y > 0
    for op in ("equal", "not_equal", "less_than", "less_equal", "greater_than", "greater_equal"):
        cases[op] = (op, {"X": np.round(x), "Y": np.round(y)}, {}, ("Out",), {})
    for op in ("logical_and", "logical_or", "logical_xor"):
        cases[op] = (op, {"X": b1, "Y": b2}, {}, ("Out",), {})
    cases["logical_not"] = ("logical_not", {"X": b1}, {}, ("Out",), {})
    cases["where"] = ("where", {"Condition": b1, "X": x, "Y": y}, {}, ("Out",), {})
    for impl in ("downgrade_in_infer", "upscale_in_train"):
        for is_test in (False, True):
            cases["dropout_%s%s" % (impl.split("_")[0], "_test" if is_test else "")] = (
                "dropout", {"X": _f32(rng, 8, 33)},
                {"dropout_prob": 0.3, "is_test": is_test, "seed": 77,
                 "dropout_implementation": impl}, ("Out", "Mask"), {})
    return cases


@pytest.mark.parametrize("case", sorted(_lm_op_cases()))
def test_lm_op_type_under_capture(card, case):
    """Each op type this slice adds, alone in a program, captured and
    replayed against the eager path on the same inputs: the same bits
    (the same kernels in the same order; dropout's mask is a function of
    its seed, so a replay draws the same one)."""
    op_type, inputs, attrs, out_slots, state = _lm_op_cases()[case]
    main, feed, fetch, init = _one_op(card, op_type, inputs, attrs, out_slots, state)
    exe, scope = tfluid.Executor(), _scope_from(init, card)
    ref_exe, ref_scope = tfluid.Executor(), _scope_from(init, card)
    for _ in range(4):
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        ref = ref_exe.run(main, feed=feed, fetch_list=fetch, scope=ref_scope,
                          use_program_cache=False)
        for n, g, r in zip(fetch, got, ref):
            np.testing.assert_array_equal(g, r, err_msg=n)
    assert exe.jit_cache_stats()["graphs"] == 1


SMALL_LM = dict(vocab_size=97, d_model=64, n_layer=2, n_head=4, d_inner=128, max_pos=64,
                seq_len=32)


def _lm(fused=True, dropout=0.0, amp=False, recipe=False):
    from paddle_tpu_torch.models import transformer

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 3
    s = SMALL_LM["seq_len"]
    lr = None
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("src_ids", [s], dtype="int64")
        labels = tfluid.layers.data("labels", [s, 1], dtype="int64")
        loss, _ = transformer.transformer_lm(ids, labels, dropout_rate=dropout,
                                             fused_attention=fused, **SMALL_LM)
        if recipe:
            lr = tfluid.layers.noam_decay(64, 10)
            opt = tfluid.optimizer.AdamOptimizer(lr, beta2=0.98, epsilon=1e-9,
                                                 regularization=tfluid.regularizer.L2Decay(1e-4))
            tfluid.clip.set_gradient_clip(tfluid.clip.GradientClipByGlobalNorm(1.0))
        else:
            opt = tfluid.optimizer.AdamOptimizer(1e-3)
        if amp:
            opt = tfluid.contrib.mixed_precision.decorate(opt)
        try:
            opt.minimize(loss)
        finally:
            tfluid.clip.set_gradient_clip(None)
    return main, startup, loss, lr


def _lm_feed(seed, rows=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL_LM["vocab_size"], (rows, SMALL_LM["seq_len"] + 1)).astype("int64")
    return {"src_ids": ids[:, :-1], "labels": ids[:, 1:, None]}


def test_fused_lm_step_on_card_matches_cpu(card):
    """The fused causal LM's first step on the card (captured after its
    eager warm-up on another scope) against the CPU from one state: loss
    and parameters after the step within 1e-3 relative."""
    main, startup, loss, _ = _lm()
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    feed = _lm_feed(1)
    exe = tfluid.Executor()
    exe.run(main, feed=feed, fetch_list=[loss], scope=_scope_from(init, card))  # warm-up
    card_scope, cpu_scope = _scope_from(init, card), _scope_from(init, "cpu")
    got, = exe.run(main, feed=feed, fetch_list=[loss], scope=card_scope)
    ref, = tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed, fetch_list=[loss], scope=cpu_scope)
    assert exe.jit_cache_stats()["graphs"] == 1
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-3)
    a, b = _state(card_scope), _state(cpu_scope)
    for n in ("lm_word_emb", "lm_dec_0_att_q_w", "lm_head_w"):
        assert np.abs(a[n] - b[n]).max() <= 1e-3 * max(np.abs(b[n]).max(), 1e-30), n


def test_unfused_dropout_lm_captured_matches_eager(card):
    """The unfused dropout LM as the Transformer recipe trains it (noam,
    Adam beta2 0.98, global-norm clipping, L2 decay, bf16 AMP) through
    the cached executor against the eager path from one state: the step
    is captured, it launches 8 dropout kernels a layer (4 forward, 4 in
    the grad ops' recompute), the first loss is bit-equal, and the later
    ones within 1e-5 relative (the embedding's gradient adds with
    atomics); the learning rate follows noam's formula."""
    from paddle_tpu_torch.kernels import dropout as kd

    main, startup, loss, lr = _lm(fused=False, dropout=0.1, amp=True, recipe=True)
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    feed = _lm_feed(2)
    exe = tfluid.Executor()
    exe.run(main, feed=feed, fetch_list=[loss], scope=_scope_from(init, card))  # warm-up
    cap_scope, eager_scope = _scope_from(init, card), _scope_from(init, card)
    eager_exe = tfluid.Executor()
    cap, eager, lrs = [], [], []
    for _ in range(3):
        kernels.reset_launch_counts()
        l, r = exe.run(main, feed=feed, fetch_list=[loss, lr], scope=cap_scope)
        assert kernels.launch_counts().get(kd.KERNEL_NAME) == 8 * SMALL_LM["n_layer"]
        cap.append(float(l))
        lrs.append(float(np.asarray(r).reshape(())))
        eager.append(float(eager_exe.run(main, feed=feed, fetch_list=[loss], scope=eager_scope,
                                         use_program_cache=False)[0]))
    assert exe.jit_cache_stats()["graphs"] == 1  # the warm-up ran eagerly on its own scope
    assert cap[0] == eager[0]
    np.testing.assert_allclose(cap, eager, rtol=1e-5)
    t = np.arange(1, 4, dtype=np.float64)
    np.testing.assert_allclose(lrs, 64 ** -0.5 * np.minimum(t ** -0.5, t * 10 ** -1.5), rtol=1e-6)


# ---------------------------------------------------------------------------
# the rest of the training surface: the other optimizers' ops, the
# averages' backup under capture, the reader's staging, FLAGS_check_nan_inf
# ---------------------------------------------------------------------------
_STATE_OUT = {"ParamOut": "Param", "VelocityOut": "Velocity", "MomentOut": "Moment",
              "InfNormOut": "InfNorm", "Moment1Out": "Moment1", "Moment2Out": "Moment2",
              "Beta1PowOut": "Beta1Pow", "Beta2PowOut": "Beta2Pow",
              "AvgSquaredGradOut": "AvgSquaredGrad", "AvgSquaredUpdateOut": "AvgSquaredUpdate",
              "MeanSquareOut": "MeanSquare", "MeanGradOut": "MeanGrad",
              "SquaredAccumOut": "SquaredAccumulator", "LinearAccumOut": "LinearAccumulator",
              "Sum1Out": "Sum1", "Sum2Out": "Sum2", "Sum3Out": "Sum3",
              "NumAccumulatesOut": "NumAccumulates",
              "OldNumAccumulatesOut": "OldNumAccumulates", "NumUpdatesOut": "NumUpdates",
              "UOut": "U", "VOut": "V"}


def _update_op_cases():
    """(op type, inputs, attrs): every input but Grad is state the op
    reads and writes back, as an optimizer's program holds it."""
    rng = np.random.RandomState(21)
    sh = (96, 80)
    p, lr = _f32(rng, *sh), np.array([0.05], "float32")
    pos = lambda: np.abs(_f32(rng, *sh)) + 0.1  # noqa: E731
    n = int(np.prod(sh))
    distinct = lambda s: (((rng.permutation(n) + 1.0) / n) * rng.choice([-1.0, 1.0], n)  # noqa: E731
                          ).reshape(sh).astype("float32") * s
    mg = _f32(rng, *sh) * 0.1
    cases = {
        "lars_momentum": ("lars_momentum", {"Velocity": _f32(rng, *sh)},
                          {"mu": 0.9, "lars_coeff": 0.001, "lars_weight_decay": 0.0005}),
        "adamax": ("adamax", {"Moment": _f32(rng, *sh), "InfNorm": pos(),
                              "Beta1Pow": np.array([0.81], "float32")}, {}),
        "adagrad": ("adagrad", {"Moment": pos()}, {"epsilon": 1e-6}),
        "decayed_adagrad": ("decayed_adagrad", {"Moment": pos()}, {"decay": 0.95}),
        "adadelta": ("adadelta", {"AvgSquaredGrad": pos(), "AvgSquaredUpdate": pos()},
                     {"rho": 0.95, "epsilon": 1e-6}),
        "ftrl": ("ftrl", {"SquaredAccumulator": np.zeros(sh, "float32"),
                          "LinearAccumulator": np.zeros(sh, "float32")},
                 {"l1": 0.01, "l2": 0.01, "lr_power": -0.5}),
        "lamb": ("lamb", {"Moment1": _f32(rng, *sh) * 0.1, "Moment2": pos() * 0.1,
                          "Beta1Pow": np.array([0.9], "float32"),
                          "Beta2Pow": np.array([0.999], "float32")}, {"weight_decay": 0.01}),
        "average_accumulates": ("average_accumulates",
                                {"Sum1": _f32(rng, *sh), "Sum2": _f32(rng, *sh),
                                 "Sum3": _f32(rng, *sh),
                                 "NumAccumulates": np.array([1], "int64"),
                                 "OldNumAccumulates": np.array([0], "int64"),
                                 "NumUpdates": np.array([2], "int64")},
                                {"average_window": 0.5, "max_num_accumulates": 3,
                                 "min_average_window": 2, "max_average_window": 3}),
        "dgc_momentum": ("dgc_momentum", {"U": distinct(0.5), "V": distinct(0.25),
                                          "CurrentStep": np.array([1.0], "float32")},
                         {"mu": 0.9, "sparsity": 0.99, "rampup_begin_step": 2.0}),
    }
    for centered in (False, True):
        cases["rmsprop_" + ("centered" if centered else "plain")] = (
            "rmsprop", {"Moment": _f32(rng, *sh), "MeanSquare": pos() + mg * mg, "MeanGrad": mg},
            {"decay": 0.9, "momentum": 0.9, "centered": centered})
    out = {}
    for name, (op, state, attrs) in cases.items():
        inputs = dict(state, Param=p)
        if op != "average_accumulates":
            inputs["Grad"] = distinct(1.0) if op == "dgc_momentum" else _f32(rng, *sh)
        if op not in ("adadelta", "average_accumulates"):
            inputs["LearningRate"] = lr
        out[name] = (op, inputs, attrs)
    return out


@pytest.mark.parametrize("case", sorted(_update_op_cases()))
def test_update_op_under_capture(card, case):
    """Each optimizer op the training surface adds, alone in a program
    whose state (parameter, accumulators, counters) is persistable,
    through the cached executor: an eager run, a capture and two replays,
    against the eager path on the same inputs, bit for bit (the same
    kernels; data-dependent choices are selects, so nothing syncs inside
    the graph).  dgc_momentum's step is a feed: 1 for the eager run and
    the capture (dense, before rampup), 5 for the replays (sparse).  Each
    run is also held to the same kernel in float64 on the CPU over the
    state it started from, within 1e-5 of the largest magnitude (integer
    counters exactly)."""
    from paddle_tpu_torch.core import registry as treg

    op_type, inputs, attrs = _update_op_cases()[case]
    kernel = treg.get_kernel(op_type)
    outs = tuple(kernel({s: [torch.from_numpy(a)] for s, a in inputs.items()}, dict(attrs),
                        torch.device("cpu")))
    state = {s: s.lower() for s in inputs if s not in ("Grad", "CurrentStep")}
    state.update({o: _STATE_OUT[o].lower() for o in outs})
    main, feed, fetch, init = _one_op(card, op_type, inputs, attrs, outs, state)
    exe, scope = tfluid.Executor(), _scope_from(init, card)
    ref_exe, ref_scope = tfluid.Executor(), _scope_from(init, card)
    for i in range(4):
        if "currentstep" in feed:
            feed["currentstep"] = np.array([1.0 if i < 2 else 5.0], "float32")
        held = dict(_state(ref_scope), **feed)
        before = {s: held[s.lower()] for s in inputs}
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        ref = ref_exe.run(main, feed=feed, fetch_list=fetch, scope=ref_scope,
                          use_program_cache=False)
        f64 = kernel({s: [torch.from_numpy(a.astype(np.float64) if a.dtype.kind == "f" else a)]
                      for s, a in before.items()}, dict(attrs), torch.device("cpu"))
        for n, g, r, slot in zip(fetch, got, ref, outs):
            np.testing.assert_array_equal(g, r, err_msg=n)
            want = f64[slot].numpy()
            g = g.reshape(want.shape)
            if want.dtype.kind == "i":
                np.testing.assert_array_equal(g, want, err_msg=n)
            else:
                assert np.abs(g - want).max() <= 1e-5 * max(1.0, np.abs(want).max()), (n, i)
    assert exe.jit_cache_stats()["graphs"] == 1


def _avg_program(kind):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [16])
        y = tfluid.layers.data("y", [1])
        h = tfluid.layers.fc(x, 32, act="tanh")
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(tfluid.layers.fc(h, 1), y))
        tfluid.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
        if kind == "ema":
            avg = tfluid.optimizer.ExponentialMovingAverage(0.9)
            avg.update()
        else:
            avg = tfluid.optimizer.ModelAverage(0.5, min_average_window=2, max_average_window=4)
    return main, startup, loss, avg


@pytest.mark.parametrize("kind", ["ema", "model_average"])
def test_average_backup_survives_a_captured_step(card, kind):
    """Captured training steps, then a captured eval step under
    ``apply()`` (its replay copies the averaged weights into the graph's
    buffers, the tensors the scope held before), then ``restore()``: the
    next captured training step's loss and every parameter equal those of
    a run that never applied the average, bit for bit."""
    main, startup, loss, avg = _avg_program(kind)
    test = main.clone(for_test=True)
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(4)
    feeds = [{"x": rng.randn(8, 16).astype("float32"), "y": rng.randn(8, 1).astype("float32")}
             for _ in range(5)]
    runs = {}
    for applied in (True, False):
        exe, scope = tfluid.Executor(), _scope_from(init, card)
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))  # warm-up
        exe.run(test, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))
        losses = []
        with tfluid.scope_guard(scope):
            for f in feeds[:4]:
                losses.append(float(exe.run(main, feed=f, fetch_list=[loss])[0]))
            if applied:
                with avg.apply(exe):
                    ev = exe.run(test, feed=feeds[0], fetch_list=[loss])[0]
                    ev2 = exe.run(test, feed=feeds[0], fetch_list=[loss])[0]
                assert np.isfinite(ev) and ev == ev2
            losses.append(float(exe.run(main, feed=feeds[4], fetch_list=[loss])[0]))
        runs[applied] = (losses, _state(scope), exe.jit_cache_stats())
    assert runs[True][2]["graphs"] == 2  # the train step and the eval step
    assert runs[True][0] == runs[False][0]
    params = [p.name for p in main.all_parameters()]
    for n in params:
        np.testing.assert_array_equal(runs[True][1][n], runs[False][1][n], err_msg=n)


@pytest.mark.parametrize("consumer", ["host_sleep", "busy_stream"])
def test_reader_side_stream_staging(card, consumer):
    """device_buffered stages on its own stream while the consumer is
    slow (asleep on the host, or its stream busy with a long kernel): the
    batches arrive on the card in order with the bytes the host gave, and
    a tensor freed by the consumer is not reused under its pending work."""
    import time

    from paddle_tpu_torch import reader as TR

    host = [{"a": np.full((512, 1024), i, "float32") + np.arange(1024, dtype="float32"),
             "ids": np.arange(64, dtype="int64") * (i + 1)} for i in range(12)]
    copies = []
    for b in TR.device_buffered(host, size=2, device="cuda:0")():
        assert b["a"].device == card and b["ids"].device == card
        if consumer == "host_sleep":
            time.sleep(0.02)
        else:
            torch.cuda._sleep(5_000_000)  # the consumer's stream is busy; the copies run ahead
        copies.append({k: v * 1 for k, v in b.items()})  # read on the consumer's stream
        del b
    torch.cuda.synchronize()
    assert len(copies) == len(host)
    for want, got in zip(host, copies):
        for k in want:
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k], err_msg=k)


def test_reader_feeds_the_captured_step(card):
    """PyReader (double buffer on the card) feeding the cached executor:
    the same losses, bit for bit, as the same batches fed as numpy dicts."""
    from paddle_tpu_torch import reader as TR

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 2
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [16])
        y = tfluid.layers.data("y", [1], dtype="int64")
        loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
            tfluid.layers.fc(tfluid.layers.fc(x, 32, act="relu"), 4), y))
        tfluid.optimizer.LambOptimizer(0.01).minimize(loss)
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(8)
    samples = [(rng.randn(16).astype("float32"), np.array([rng.randint(0, 4)], "int64"))
               for _ in range(48)]
    reader = tfluid.PyReader(feed_list=[x, y], capacity=4)
    reader.decorate_sample_list_generator(TR.batch(lambda: iter(samples), 8))
    a, b = tfluid.Executor(), tfluid.Executor()
    sa, sb = _scope_from(init, card), _scope_from(init, card)
    via_reader = [float(a.run(main, feed=f, fetch_list=[loss], scope=sa)[0]) for f in reader()]
    via_dicts = [float(b.run(main, feed={"x": np.stack([s[0] for s in samples[i:i + 8]]),
                                         "y": np.stack([s[1] for s in samples[i:i + 8]])},
                             fetch_list=[loss], scope=sb)[0]) for i in range(0, 48, 8)]
    assert a.jit_cache_stats()["graphs"] == 1
    assert via_reader == via_dicts


def test_check_nan_inf_on_a_replayed_entry(card, monkeypatch):
    """With FLAGS_check_nan_inf on, a replay whose feed holds an inf
    raises naming the nan weights it wrote; clean replays pass."""
    from paddle_tpu_torch import flags as tflags

    monkeypatch.setenv("FLAGS_check_nan_inf", "0")
    monkeypatch.setattr(tflags, "_OVERRIDES", {})
    main, startup, loss, _ = _avg_program("ema")
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(1)
    clean = {"x": rng.randn(8, 16).astype("float32"), "y": rng.randn(8, 1).astype("float32")}
    bad = {"x": clean["x"].copy(), "y": clean["y"]}
    bad["x"][0, 0] = np.inf
    tfluid.set_flags({"FLAGS_check_nan_inf": True})
    for _ in range(3):  # eager, capture, replay
        exe.run(main, feed=clean, fetch_list=[loss], scope=scope)
    assert exe.jit_cache_stats()["graphs"] == 1
    with pytest.raises(RuntimeError, match="nan/inf detected") as err:
        exe.run(main, feed=bad, fetch_list=[loss], scope=scope)
    assert "fc_0.w_0" in str(err.value)


# ---------------------------------------------------------------------------
# DeepFM and the parameter server on the card
# ---------------------------------------------------------------------------
class _Deterministic:
    """``torch.use_deterministic_algorithms`` for a block whose runs are
    compared bit for bit: the embedding's backward (``index_add_``)
    otherwise adds with atomics."""

    def __enter__(self):
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        torch.use_deterministic_algorithms(False)


def _deepfm(distributed=False, fields=8, features=1000, embed=8, deep=(64, 64), seed=3):
    from paddle_tpu_torch import models

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("feat_ids", [fields, 1], dtype="int64")
        vals = tfluid.layers.data("feat_vals", [fields])
        label = tfluid.layers.data("label", [1], dtype="int64")
        loss, prob = models.deepfm_ctr(ids, vals, label, num_features=features,
                                       num_fields=fields, embed_dim=embed, deep_layers=deep,
                                       distributed_emb=distributed)
        opt = (tfluid.optimizer.SGDOptimizer(0.05) if distributed
               else tfluid.optimizer.AdamOptimizer(1e-3))
        opt.minimize(loss)
    return main, startup, loss


def _ctr_feed(rng, rows, fields=8, features=1000):
    return {"feat_ids": rng.randint(0, features, (rows, fields)).astype("int64"),
            "feat_vals": rng.uniform(0, 1, (rows, fields)).astype("float32"),
            "label": rng.randint(0, 2, (rows, 1)).astype("int64")}


def test_deepfm_captured_bit_equal_to_eager(card):
    """Four DeepFM Adam steps through the cached executor (captured, then
    replayed) against four eager ones from the same state, under
    deterministic algorithms: losses and every persistable bit-equal.
    The ids come as [B, F] for the [F, 1] var, as a dataset gives them."""
    main, startup, loss = _deepfm()
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(0)
    feeds = [_ctr_feed(rng, 256) for _ in range(4)]
    with _Deterministic():
        exe = tfluid.Executor()
        exe.run(main, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))  # warm-up
        ref_exe, scope, ref_scope = tfluid.Executor(), _scope_from(init, card), _scope_from(init, card)
        got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0] for f in feeds]
        ref = [ref_exe.run(main, feed=f, fetch_list=[loss], scope=ref_scope,
                           use_program_cache=False)[0] for f in feeds]
    assert exe.jit_cache_stats()["graphs"] == 1
    assert [g.tobytes() for g in got] == [r.tobytes() for r in ref]
    a, b = _state(scope), _state(ref_scope)
    for n in a:
        assert a[n].tobytes() == b[n].tobytes(), n


def _ps_run(card, init, feeds, main, loss, cached, comm=None):
    from paddle_tpu_torch.distributed import ps as tps

    server = tps.ParameterServer().start()
    try:
        tfluid.distributed.bind_distributed_tables(main, [server.endpoint], optimizer="sgd",
                                                   lr=0.05, initializer="zeros")
        exe, scope = tfluid.Executor(), _scope_from(init, card)
        out = [exe.run(main, feed=dict(f), fetch_list=[loss], scope=scope,
                       use_program_cache=cached)[0] for f in feeds]
        return out, exe.jit_cache_stats()
    finally:
        server.stop()


def test_ps_rows_through_two_buckets_each_captured(card):
    """A PS-fed ``Rows`` feed whose unique-id count falls in two buckets
    (batch 16 and batch 128 of 8 fields over 100,000 features: 128 and
    1,024 rows): each bucket is an entry of its own with a graph of its
    own, and the captured runs give the eager runs' losses bit for bit."""
    main, startup, loss = _deepfm(distributed=True, features=100_000)
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(1)
    feeds = [_ctr_feed(rng, rows, features=100_000) for rows in (16, 128) * 4]
    with _Deterministic():
        got, stats = _ps_run(card, init, feeds, main, loss, cached=True)
        main2, _, loss2 = _deepfm(distributed=True, features=100_000)
        ref, _ = _ps_run(card, init, feeds, main2, loss2, cached=False)
    assert stats["entries"] == 2 and stats["graphs"] == 2 and stats["misses"] == 2
    assert {tfluid.executor.pow2_id_bucket(n) for n in main._uniq_id_hist} == {128, 1024}
    assert [g.tobytes() for g in got] == [r.tobytes() for r in ref]


def test_queued_async_pushes_are_host_copies(card):
    """The Communicator's queue (its send thread not started) holds each
    step's row gradients as host arrays, and a batch queued after a
    replay is unchanged after the next replay overwrote the graph's
    fetch buffers."""
    from paddle_tpu_torch.distributed import ps as tps
    from paddle_tpu_torch.distributed.communicator import Communicator

    main, startup, loss = _deepfm(distributed=True)
    server = tps.ParameterServer().start()
    try:
        client = tfluid.distributed.bind_distributed_tables(main, [server.endpoint], lr=0.05)
        comm = main._ps_communicator = Communicator(client)  # not started: pushes stay queued
        exe, scope = tfluid.Executor(), tfluid.Scope()
        exe.run(startup, scope=scope)
        rng = np.random.RandomState(2)
        snapshots = []
        for step in range(4):  # eager, capture, replay, replay
            exe.run(main, feed=_ctr_feed(rng, 64), fetch_list=[loss], scope=scope)
            queued = {t: list(q.queue) for t, q in comm._queues.items()}
            assert all(isinstance(a, np.ndarray)
                       for items in queued.values() for item in items for a in item)
            snapshots.append({t: [(i.copy(), g.copy()) for i, g in items]
                              for t, items in queued.items()})
        assert exe.jit_cache_stats()["graphs"] == 1
        final = {t: list(q.queue) for t, q in comm._queues.items()}
        assert sorted(final) == ["deepfm_fm_emb", "deepfm_w1_emb"]
        for t, items in final.items():
            assert len(items) == 4
            # the batches queued up to the first replay, after two more replays
            for (i0, g0), (i1, g1) in zip(snapshots[2][t], items[:3]):
                np.testing.assert_array_equal(i0, i1)
                np.testing.assert_array_equal(g0, g1)
        assert comm.pending() == 8
        comm.flush()
        assert comm.pending() == 0
    finally:
        server.stop()


def test_geo_sgd_pulls_land_on_the_card(card):
    """GeoSGD with sync_every=2 on a small fc program: the pulled params
    are CUDA tensors on the scope's card, and the next captured step reads
    them: its loss is bit-equal to an eager step from the same state."""
    from paddle_tpu_torch.distributed import GeoSGD
    from paddle_tpu_torch.distributed import ps as tps

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 4
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [6])
        y = tfluid.layers.data("y", [1])
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(
            tfluid.layers.fc(tfluid.layers.fc(x, 16, act="relu"), 1), y))
        tfluid.optimizer.SGDOptimizer(0.1).minimize(loss)
    server = tps.ParameterServer().start()
    try:
        exe, scope = tfluid.Executor(), tfluid.Scope()
        exe.run(startup, scope=scope)
        geo = GeoSGD(main, scope, [server.endpoint], sync_every=2).init_worker()
        rng = np.random.RandomState(3)
        feeds = [{"x": rng.randn(32, 6).astype("float32"),
                  "y": rng.randn(32, 1).astype("float32")} for _ in range(5)]
        for f in feeds[:4]:  # eager, capture, replay, replay; two syncs
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            synced = geo.step()
        assert synced and exe.jit_cache_stats()["graphs"] == 1
        params = [p.name for p in main.all_parameters()]
        assert all(scope.vars[n].device == card for n in params)
        with _Deterministic():
            ref_scope = _scope_from(_state(scope), card)
            got = exe.run(main, feed=feeds[4], fetch_list=[loss], scope=scope)[0]
            ref = tfluid.Executor().run(main, feed=feeds[4], fetch_list=[loss], scope=ref_scope,
                                        use_program_cache=False)[0]
        assert got.tobytes() == ref.tobytes()
    finally:
        server.stop()


def test_thread2_ps_ids_stay_on_the_host(card, monkeypatch):
    """``train_from_dataset(thread=2)`` on a CUDA executor with
    distributed tables in async mode: the prefetch stages the dense feeds
    on the card, but the ids reach each batch's unique-id expansion as
    host arrays (no copy back from the card); the loss falls and after
    ``flush()`` nothing is left queued."""
    from paddle_tpu_torch.distributed import ps as tps

    main, startup, loss = _deepfm(distributed=True)
    expand, kinds = tfluid.Executor._sparse_expand_ids, []

    def spied(meta, ids_val, ladder=None):
        kinds.append(type(ids_val))
        return expand(meta, ids_val, ladder)

    monkeypatch.setattr(tfluid.Executor, "_sparse_expand_ids", staticmethod(spied))
    server = tps.ParameterServer().start()
    try:
        tfluid.distributed.bind_distributed_tables(main, [server.endpoint], lr=0.05,
                                                   async_mode=True)
        exe, scope = tfluid.Executor(), tfluid.Scope()
        exe.run(startup, scope=scope)
        feed = _ctr_feed(np.random.RandomState(5), 64)
        out = exe.train_from_dataset(main, [dict(feed) for _ in range(6)], scope=scope,
                                     thread=2, fetch_list=[loss])
        losses = [float(o[0]) for o in out]
        assert len(losses) == 6 and losses[-1] < losses[0], losses
        assert len(kinds) == 2 * 6 and set(kinds) == {np.ndarray}, kinds
        comm = main._ps_communicator
        comm.flush()
        assert comm.pending() == 0 and comm.dropped == 0
        comm.stop()
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# control flow, the recurrences and the beam ops on the card
# ---------------------------------------------------------------------------
def _cf_case(case):
    from torch_control_flow_cases import CASES

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup):
        fetch, feeds, _ = CASES[case](tfluid)
    boot = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=boot)
    return main, fetch, feeds, _state(boot)


@pytest.mark.parametrize("case", ["bounded_while", "static_rnn", "dynamic_rnn"])
def test_fixed_trip_loop_plan_is_captured(card, case):
    """A bounded_while, static_rnn or dynamic_rnn training plan reads
    nothing on the host: the cached executor captures it, and three
    replayed steps equal three eager ones from the same state, bit for
    bit (under deterministic algorithms), fetches and persistables."""
    main, fetch, feeds, init = _cf_case(case)
    feeds = [feeds[0]] * 3 if len(feeds) == 1 else feeds
    with _Deterministic():
        exe = tfluid.Executor()
        exe.run(main, feed=feeds[0], fetch_list=fetch, scope=_scope_from(init, card))  # warm-up
        scope, ref_scope = _scope_from(init, card), _scope_from(init, card)
        got = [exe.run(main, feed=f, fetch_list=fetch, scope=scope) for f in feeds]
        ref = [tfluid.Executor().run(main, feed=f, fetch_list=fetch, scope=ref_scope,
                                     use_program_cache=False) for f in feeds]
    assert exe.jit_cache_stats()["graphs"] == 1
    for g, r in zip(got, ref):
        assert [a.tobytes() for a in g] == [b.tobytes() for b in r]
    a, b = _state(scope), _state(ref_scope)
    for n in a:
        assert a[n].tobytes() == b[n].tobytes(), n


@pytest.mark.parametrize("case", ["while", "cond", "conditional_block", "while_in_dynamic_rnn"])
def test_host_read_plan_stays_eager(card, case):
    """A plan holding while, conditional_block or select_branch (here or
    nested in a DynamicRNN body) is never captured: three cached runs
    build no graph, and each equals the CPU's run from the same state
    (within 1e-5)."""
    main, fetch, feeds, init = _cf_case(case)
    exe, scope = tfluid.Executor(), _scope_from(init, card)
    cpu_exe, cpu_scope = tfluid.Executor(tfluid.CPUPlace()), _scope_from(init, "cpu")
    for i in range(3):
        f = feeds[i % len(feeds)]
        got = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        want = cpu_exe.run(main, feed=f, fetch_list=fetch, scope=cpu_scope)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    stats = exe.jit_cache_stats()
    assert stats["graphs"] == 0 and stats["entries"] == 1


@pytest.mark.parametrize("ties", [False, True])
def test_beam_ops_on_card_match_cpu(card, ties):
    """beam_search (also on constructed ties) and beam_search_decode on
    CUDA tensors: the ids and parents equal the CPU's, the scores within
    1e-6."""
    from paddle_tpu_torch.core import registry

    rng = np.random.RandomState(int(ties))
    B, K, C, steps = 4, 4, 8, 6
    pre_ids = rng.randint(3, 9, (B * K, 1)).astype("int64")
    pre_ids[::5] = 2  # finished beams
    pre_sc = rng.randn(B * K, 1).astype("float32")
    sc = np.full((B * K, C), 0.125, "float32") if ties else rng.uniform(0.01, 1, (B * K, C))
    ins = {"pre_ids": [pre_ids], "pre_scores": [pre_sc],
           "ids": [rng.randint(0, 50, (B * K, C)).astype("int64")],
           "scores": [np.asarray(sc, "float32")]}
    dec = {"Ids": [rng.randint(0, 9, (steps, B * K, 1)).astype("int64")],
           "Scores": [np.cumsum(-rng.uniform(0, 1, (steps, B * K, 1)), 0).astype("float32")],
           "Parents": [(rng.randint(0, K, (steps, B * K)) + np.arange(B * K) // K * K)
                       .astype("int32")]}
    attrs = {"beam_size": K, "end_id": 2, "is_accumulated": False}
    for op, inputs in (("beam_search", ins), ("beam_search_decode", dec)):
        kernel = registry.get_kernel(op)
        outs = {}
        for dev in (card, torch.device("cpu")):
            t = {s: [torch.from_numpy(v).to(dev) for v in vs] for s, vs in inputs.items()}
            outs[dev.type] = kernel(t, attrs, dev)
        for slot, got in outs["cuda"].items():
            assert got.is_cuda, slot
            got, want = got.cpu().numpy(), outs["cpu"][slot].numpy()
            if got.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=slot)
            else:
                np.testing.assert_array_equal(got, want, err_msg=slot)


def test_program_logits_fn_is_captured_on_card(card):
    """decoding.make_program_logits_fn on the card runs the program as a
    captured executor entry: three calls with one feed shape build one
    graph, each call's logits within 1e-4 of the CPU interpreter's, and a
    greedy decode through it gives the CPU's tokens."""
    from paddle_tpu_torch import decoding
    from paddle_tpu_torch.models import seq2seq

    S, T, V = 10, 7, 40
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 9
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        src = tfluid.layers.data("src", [S], dtype="int64")
        tgt = tfluid.layers.data("tgt", [T], dtype="int64")
        smask = tfluid.layers.data("smask", [S])
        _, logits = seq2seq.transformer_nmt(src, tgt, None, src_mask=smask, src_vocab=V,
                                            tgt_vocab=V, d_model=32, n_layer=2, n_head=4,
                                            d_inner=64, src_len=S, tgt_len=T, is_test=True)
    boot = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=boot)
    state = _state(boot)
    feeds = ["src", "tgt", "smask"]
    fn = decoding.make_program_logits_fn(main, state, feeds, logits.name)
    cpu_fn = decoding.make_program_logits_fn(main, state, feeds, logits.name,
                                             place=tfluid.CPUPlace())
    rng = np.random.RandomState(0)
    for _ in range(3):
        f = {"src": rng.randint(0, V, (3, S)), "tgt": rng.randint(0, V, (3, T)),
             "smask": (np.arange(S)[None, :] < rng.randint(5, S + 1, (3, 1))).astype("float32")}
        got = fn(f)
        assert got.is_cuda
        np.testing.assert_allclose(got.cpu().numpy(), cpu_fn(f).numpy(), rtol=1e-4, atol=1e-4)
    assert fn.executor.jit_cache_stats()["graphs"] == 1
    src_ids = torch.from_numpy(rng.randint(0, V, (3, S))).to(card)
    mask = np.ones((3, S), "float32")
    got, _ = decoding.greedy_search(fn, src_ids, 1, 2, max_len=T, extra_feeds={"smask": mask})
    want, _ = decoding.greedy_search(cpu_fn, src_ids.cpu(), 1, 2, max_len=T,
                                     extra_feeds={"smask": mask})
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# ---------------------------------------------------------------------------
# faults C1 and C2, and the math, tensor and plain nn op types (A1b)
# ---------------------------------------------------------------------------
def test_persistable_toggle_takes_a_fresh_captured_entry(card):
    """``y = scale(x)`` captured and replayed; then ``y.persistable = True``
    bumps the program's version, which the plan key and so the entry key
    hold: the next run builds a new entry (eager), the one after captures
    a second graph, and the replays write y to the scope."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.scale(x, scale=2.0)
    exe, scope = tfluid.Executor(), tfluid.Scope()
    feeds = [{"x": np.full((2, 4), i, np.float32)} for i in range(6)]
    for f in feeds[:3]:
        exe.run(main, feed=f, fetch_list=[y], scope=scope)
    stats = exe.jit_cache_stats()
    assert stats["graphs"] == 1 and stats["misses"] == 1 and scope.get(y.name) is None
    y.persistable = True
    for i, f in enumerate(feeds[3:]):
        out, = exe.run(main, feed=f, fetch_list=[y], scope=scope)
        np.testing.assert_array_equal(out, 2 * f["x"])
        np.testing.assert_array_equal(scope.get(y.name).cpu().numpy(), 2 * f["x"])
        stats = exe.jit_cache_stats()
        assert stats["misses"] == 2 and stats["plan_misses"] == 2
        assert stats["graphs"] == (1 if i == 0 else 2)  # eager first, then a graph of its own


def test_placeholder_var_in_state_out_is_not_captured_over(card):
    """A persistable output made in the scope by ``Scope.var`` and never
    set holds no buffer: the first run writes it outside a graph, and the
    runs after it capture and replay, each writing y to the scope."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        y = tfluid.layers.scale(x, scale=2.0)
    y.persistable = True
    exe, scope = tfluid.Executor(), tfluid.Scope()
    scope.var(y.name)
    assert y.name in scope.vars and scope.get(y.name) is None
    for i in range(4):
        f = {"x": np.full((2, 4), i, np.float32)}
        out, = exe.run(main, feed=f, fetch_list=[y], scope=scope)
        np.testing.assert_array_equal(out, 2 * f["x"])
        np.testing.assert_array_equal(scope.get(y.name).cpu().numpy(), 2 * f["x"])
    assert exe.jit_cache_stats()["graphs"] == 1


def _a1b_program(card, op_type, inputs, attrs, outs):
    """A program of one op: each array of ``inputs`` (slot -> list) fed as
    its own var, ``outs`` slot -> number of outputs."""
    main = tfluid.Program()
    blk = main.global_block()
    feed, ins = {}, {}
    for slot, arrs in inputs.items():
        names = []
        for i, a in enumerate(arrs):
            n = "%s_%d" % (slot.lower(), i)
            blk.create_var(name=n, shape=a.shape, dtype=str(a.dtype))
            feed[n] = a
            names.append(n)
        ins[slot] = names
    outputs = {}
    for slot, k in outs.items():
        outputs[slot] = ["%s_out_%d" % (slot.lower(), i) for i in range(k)]
        for n in outputs[slot]:
            blk.create_var(name=n, dtype="float32")
    blk.append_op(op_type, inputs=ins, outputs=outputs, attrs=attrs)
    return main, feed, [n for ns in outputs.values() for n in ns]


def _a1b_cases():
    """name -> (op type, inputs, attrs, outputs) for every op type A1b's
    first part adds that a capture holds."""
    rng = np.random.RandomState(21)
    x = _f32(rng, 3, 4, 5)
    img = _f32(rng, 2, 4, 6, 6)
    pos = np.abs(x) + 0.3
    b = x > 0
    one = {"Out": 1}
    c = {}
    for op in ("reduce_mean", "reduce_max", "reduce_min", "reduce_prod"):
        c[op] = (op, {"X": [x]}, {"dim": [1], "keep_dim": False}, one)
    for op in ("reduce_all", "reduce_any"):
        c[op] = (op, {"X": [b]}, {"dim": [2]}, one)
    c["elementwise_mod"] = ("elementwise_mod", {"X": [x * 5], "Y": [pos]}, {}, one)
    c["elementwise_floordiv"] = ("elementwise_floordiv", {"X": [x * 5], "Y": [pos]}, {}, one)
    c["pow"] = ("pow", {"X": [pos]}, {"factor": 1.5}, one)
    c["isfinite"] = ("isfinite", {"X": [x]}, {}, one)
    c["transpose"] = ("transpose", {"X": [x]}, {"axis": [2, 0, 1]}, one)
    xs = {"Out": 1, "XShape": 1}
    c["squeeze2"] = ("squeeze2", {"X": [x[:, :1]]}, {"axes": [1]}, xs)
    c["unsqueeze2"] = ("unsqueeze2", {"X": [x]}, {"axes": [0, 3]}, xs)
    c["flatten2"] = ("flatten2", {"X": [img]}, {"axis": 2}, xs)
    c["squeeze"] = ("squeeze", {"X": [x[:, :1]]}, {"axes": [1]}, xs)
    c["unsqueeze"] = ("unsqueeze", {"X": [x]}, {"axes": [1]}, xs)
    c["flatten"] = ("flatten", {"X": [img]}, {"axis": 1}, xs)
    c["split"] = ("split", {"X": [img]}, {"num": 2, "axis": 1}, {"Out": 2})
    c["stack"] = ("stack", {"X": [x, x * 2]}, {"axis": 1}, {"Y": 1})
    c["unstack"] = ("unstack", {"X": [x]}, {"axis": 1}, {"Y": 4})
    c["strided_slice"] = ("strided_slice", {"Input": [x]},
                          {"axes": [2, 1], "starts": [4, 0], "ends": [0, 4], "strides": [-2, 2]},
                          one)
    c["shape"] = ("shape", {"Input": [img]}, {}, one)
    c["pad"] = ("pad", {"X": [x]}, {"paddings": [0, 1, 2, 0, 1, 1], "pad_value": 0.5}, one)
    c["pad2d"] = ("pad2d", {"X": [img]}, {"paddings": [1, 2, 0, 1], "mode": "reflect"}, one)
    c["lookup_table_v2"] = ("lookup_table_v2", {"W": [_f32(rng, 10, 4)],
                                                "Ids": [rng.randint(0, 10, (3, 2))]}, {}, one)
    c["one_hot"] = ("one_hot", {"X": [np.array([[0], [3], [9], [1]])]}, {"depth": 5}, one)
    c["gather_nd"] = ("gather_nd", {"X": [x], "Index": [np.array([[0, 1], [2, 3]])]}, {}, one)
    c["scatter"] = ("scatter", {"X": [_f32(rng, 6, 3)], "Ids": [np.array([4, 0, 4])],
                                "Updates": [_f32(rng, 3, 3)]}, {"overwrite": False}, one)
    c["arg_min"] = ("arg_min", {"X": [x]}, {"axis": 1}, one)
    c["argsort"] = ("argsort", {"X": [x]}, {"axis": -1, "descending": True},
                    {"Out": 1, "Indices": 1})
    c["cumsum"] = ("cumsum", {"X": [x]}, {"axis": 1, "exclusive": True, "reverse": True}, one)
    c["crop"] = ("crop", {"X": [img]}, {"offsets": [0, 1, 2, 0], "shape": [2, 2, 3, 4]}, one)
    c["crop_tensor"] = ("crop_tensor", {"X": [img]}, {"offsets": [1, 0, 0, 0],
                                                      "shape": [1, 4, 2, 2]}, one)
    c["pad_constant_like"] = ("pad_constant_like", {"X": [img], "Y": [img[:1, :3]]},
                              {"pad_value": 2.0}, one)
    c["meshgrid"] = ("meshgrid", {"X": [_f32(rng, 3), _f32(rng, 5)]}, {}, {"Out": 2})
    c["roll"] = ("roll", {"X": [x]}, {"shifts": [2], "axis": [2]}, one)
    c["fill_zeros_like2"] = ("fill_zeros_like2", {"X": [x]}, {}, one)
    c["fill"] = ("fill", {}, {"shape": [2, 3], "dtype": "float32", "value": 2.5}, one)
    c["prelu"] = ("prelu", {"X": [img], "Alpha": [_f32(rng, 4)]}, {"mode": "channel"}, one)
    c["prelu_channel"] = ("prelu_channel", {"X": [img]}, {}, one)
    c["log_softmax"] = ("log_softmax", {"X": [x]}, {"axis": -1}, one)
    conv = {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}
    c["depthwise_conv2d"] = ("depthwise_conv2d", {"Input": [img], "Filter": [_f32(rng, 4, 1, 3, 3)]},
                             conv, {"Output": 1})
    c["conv2d_transpose"] = ("conv2d_transpose",
                             {"Input": [img], "Filter": [_f32(rng, 4, 3, 3, 3)]}, conv,
                             {"Output": 1})
    c["depthwise_conv2d_transpose"] = ("depthwise_conv2d_transpose",
                                       {"Input": [img], "Filter": [_f32(rng, 4, 2, 3, 3)]}, conv,
                                       {"Output": 1})
    c["group_norm"] = ("group_norm", {"X": [img], "Scale": [_f32(rng, 4)], "Bias": [_f32(rng, 4)]},
                       {"groups": 2}, {"Y": 1, "Mean": 1, "Variance": 1})
    c["huber_loss"] = ("huber_loss", {"X": [x], "Y": [x * 0.5]}, {"delta": 0.7},
                       {"Out": 1, "Residual": 1})
    c["smooth_l1_loss"] = ("smooth_l1_loss", {"X": [x], "Y": [x * 0.5]}, {"sigma": 2.0},
                           {"Out": 1, "Diff": 1})
    c["log_loss"] = ("log_loss", {"Predicted": [np.clip(pos / 4, 0.05, 0.95)],
                                  "Labels": [b.astype("float32")]}, {}, {"Loss": 1})
    c["l2_normalize"] = ("l2_normalize", {"X": [x]}, {"axis": 1}, {"Out": 1, "Norm": 1})
    c["norm"] = ("norm", {"X": [x]}, {"axis": -1}, {"Out": 1, "Norm": 1})
    c["maxout"] = ("maxout", {"X": [img]}, {"groups": 2}, one)
    c["bilinear_interp"] = ("bilinear_interp", {"X": [img]}, {"out_h": 11, "out_w": 9}, one)
    c["nearest_interp"] = ("nearest_interp", {"X": [img]}, {"scale": 2.0}, one)
    c["pixel_shuffle"] = ("pixel_shuffle", {"X": [img]}, {"upscale_factor": 2}, one)
    c["shuffle_channel"] = ("shuffle_channel", {"X": [img]}, {"group": 2}, one)
    c["spectral_norm"] = ("spectral_norm", {"Weight": [_f32(rng, 6, 8)], "U": [_f32(rng, 6)],
                                            "V": [_f32(rng, 8)]}, {"power_iters": 2}, one)
    c["data_norm"] = ("data_norm", {"X": [_f32(rng, 8, 5)],
                                    "BatchSize": [np.full(5, 100.0, "float32")],
                                    "BatchSum": [_f32(rng, 5)],
                                    "BatchSquareSum": [np.full(5, 120.0, "float32")]}, {},
                      {"Y": 1, "Means": 1, "Scales": 1})
    c["bilinear_tensor_product"] = ("bilinear_tensor_product",
                                    {"X": [_f32(rng, 5, 4)], "Y": [_f32(rng, 5, 3)],
                                     "Weight": [_f32(rng, 2, 4, 3)], "Bias": [_f32(rng, 1, 2)]},
                                    {}, one)
    return c


@pytest.mark.parametrize("case", sorted(_a1b_cases()))
def test_a1b_op_type_under_capture(card, case):
    """Each op type alone in a program on the card: an eager run, a
    capture and two replays against the eager path, bit for bit under
    deterministic algorithms, and against the CPU interpreter within
    1e-5 (ids and bools exactly)."""
    op_type, inputs, attrs, outs = _a1b_cases()[case]
    main, feed, fetch = _a1b_program(card, op_type, inputs, attrs, outs)
    cpu = tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                                 scope=tfluid.Scope())
    exe, scope = tfluid.Executor(), tfluid.Scope()
    ref_exe, ref_scope = tfluid.Executor(), tfluid.Scope()
    with _Deterministic():
        for _ in range(4):
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            ref = ref_exe.run(main, feed=feed, fetch_list=fetch, scope=ref_scope,
                              use_program_cache=False)
            for n, g, r, h in zip(fetch, got, ref, cpu):
                np.testing.assert_array_equal(g, r, err_msg=n)
                np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(h, np.float64),
                                           rtol=1e-5, atol=1e-5, err_msg=n)
    assert exe.jit_cache_stats()["graphs"] == 1


@pytest.mark.parametrize("case", ["py_func", "load", "linspace", "sampling_id",
                                  "uniform_random_batch_size_like"])
def test_a1b_host_and_random_plans_stay_eager(card, case, tmp_path):
    """py_func, load and linspace read on the host, sampling_id and
    uniform_random_batch_size_like draw from a generator: their plans run
    the interpreter on every run (no graph), and give the CPU's values
    (the seeded generators draw other bits on the card than on the CPU,
    so those two are held by their support and seed-stability)."""
    main = tfluid.Program()
    blk = main.global_block()
    feed = {}
    with tfluid.program_guard(main, tfluid.Program()):
        if case == "py_func":
            x = tfluid.layers.data("x", [3])
            out = blk.create_var(name="out", shape=[-1, 3], dtype="float32")
            tfluid.layers.py_func(lambda a: a * 3.0 + 1.0, x, out)
            feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
        elif case == "load":
            np.save(str(tmp_path / "w.npy"), np.arange(6, dtype=np.float32))
            out = blk.create_var(name="out", shape=[6], dtype="float32")
            tfluid.layers.load(out, str(tmp_path / "w"))
        elif case == "linspace":
            for n, v in (("start", [0.5]), ("stop", [2.0])):
                blk.create_var(name=n, shape=[1], dtype="float32")
                feed[n] = np.array(v, np.float32)
            blk.create_var(name="num", shape=[1], dtype="int32")
            feed["num"] = np.array([4], np.int32)
            blk.create_var(name="out", dtype="float32")
            blk.append_op("linspace", inputs={"Start": ["start"], "Stop": ["stop"],
                                              "Num": ["num"]},
                          outputs={"Out": ["out"]}, attrs={"dtype": "float32"})
        else:
            x = tfluid.layers.data("x", [6])
            feed = {"x": np.full((64, 6), 1.0 / 6, np.float32)}
            blk.create_var(name="out", dtype="float32")
            attrs = ({"seed": 4} if case == "sampling_id" else
                     {"seed": 4, "shape": [-1, 8], "min": -1.0, "max": 1.0})
            blk.append_op(case, inputs={"X" if case == "sampling_id" else "Input": [x.name]},
                          outputs={"Out": ["out"]}, attrs=attrs)
    exe = tfluid.Executor()
    runs = [exe.run(main, feed=feed, fetch_list=["out"], scope=tfluid.Scope())[0]
            for _ in range(3)]
    assert exe.jit_cache_stats()["graphs"] == 0
    cpu, = tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed, fetch_list=["out"],
                                                  scope=tfluid.Scope())
    for r in runs:
        np.testing.assert_array_equal(r, runs[0])
    if case == "sampling_id":
        assert runs[0].shape == (64,) and runs[0].min() >= 0 and runs[0].max() < 6
    elif case == "uniform_random_batch_size_like":
        assert runs[0].shape == (64, 8) and -1 <= runs[0].min() and runs[0].max() < 1
    else:
        np.testing.assert_allclose(runs[0], cpu, rtol=1e-6)


def _a1b_train_program(seed=5):
    """The differentiable A1b layers in one small training program."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    L = tfluid.layers
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        img = L.data("img", [4, 8, 8])
        vec = L.data("vec", [6])
        h = L.conv2d_transpose(img, 8, filter_size=3, stride=2, padding=1)
        h = L.group_norm(L.prelu(h, "channel"), groups=4)
        h = L.maxout(L.pad2d(h, [1, 1, 0, 2], mode="edge"), groups=2)
        h = L.pixel_shuffle(L.shuffle_channel(L.resize_bilinear(h, out_shape=[10, 10]), 2), 2)
        h = L.log_softmax(L.flatten(h, axis=1))
        parts = L.split(h, 2, dim=1)
        h = L.reduce_mean(L.stack(parts, axis=1), dim=[1])
        v = L.bilinear_tensor_product(L.l2_normalize(vec, axis=1),
                                      L.data_norm(vec, name="dn"), 3)
        w = L.spectral_norm(L.create_parameter([6, 4], "float32", name="sn_w"))
        loss = L.sums([L.reduce_mean(L.pow(L.cumsum(h, axis=1), 2.0)),
                       L.reduce_mean(L.square(v)), L.reduce_mean(L.mul(vec, w)),
                       L.reduce_mean(L.huber_loss(L.reduce_max(v, dim=[1], keep_dim=True),
                                                  L.reduce_min(v, dim=[1], keep_dim=True), 0.5))])
        tfluid.optimizer.MomentumOptimizer(0.05, 0.9).minimize(loss)
    return main, startup, loss


def test_a1b_layers_train_captured_bit_equal_to_eager(card):
    """Their forward and vjp in one training program: three captured
    steps against three eager ones from one state, under deterministic
    algorithms, the losses and every persistable bit for bit; and the
    first step's loss against the CPU within 1e-4."""
    main, startup, loss = _a1b_train_program()
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(0)
    feeds = [{"img": rng.randn(4, 4, 8, 8).astype("float32"),
              "vec": rng.randn(4, 6).astype("float32")} for _ in range(3)]
    with _Deterministic():
        paths = {}
        for cached in (False, True):
            exe, scope = tfluid.Executor(), _scope_from(init, card)
            if cached:  # the entry's eager warm-up, on a scope of its own
                exe.run(main, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))
            losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                                    use_program_cache=cached)[0]) for f in feeds]
            paths[cached] = (losses, _state(scope), exe.jit_cache_stats()["graphs"])
    assert paths[True][0] == paths[False][0] and paths[True][2] == 1
    for n, v in paths[False][1].items():
        np.testing.assert_array_equal(paths[True][1][n], v, err_msg=n)
    cpu_scope = tfluid.Scope(device="cpu")
    for n, v in init.items():
        cpu_scope.set(n, v)
    cpu, = tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feeds[0], fetch_list=[loss],
                                                  scope=cpu_scope)
    np.testing.assert_allclose(paths[False][0][0], float(cpu), rtol=1e-4)


def _vgg(hw=32, dropout=True, seed=6):
    from paddle_tpu_torch import models

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        img = tfluid.layers.data("img", [3, hw, hw])
        lbl = tfluid.layers.data("lbl", [1], dtype="int64")
        loss, _, _ = models.vgg16(img, lbl, class_num=10, dropout=dropout)
        tfluid.contrib.mixed_precision.decorate(
            tfluid.optimizer.MomentumOptimizer(1e-3, 0.9)).minimize(loss)
    return main, startup, loss


def test_vgg16_amp_with_dropout_captured_bit_equal_to_eager(card):
    """VGG-16 (32x32, batch 8, bf16 AMP, both dropouts) captured against
    eager from one state under deterministic algorithms and cuDNN's
    deterministic algorithms: three losses and every persistable bit for
    bit, and each step launches the dropout kernel 4 times (2 forward, 2
    in the vjp's recompute)."""
    main, startup, loss = _vgg()
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(1)
    feeds = [{"img": rng.uniform(-1, 1, (8, 3, 32, 32)).astype("float32"),
              "lbl": rng.randint(0, 10, (8, 1)).astype("int64")} for _ in range(3)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with _Deterministic():
            paths = {}
            for cached in (False, True):
                exe, scope = tfluid.Executor(), _scope_from(init, card)
                if cached:
                    exe.run(main, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))
                kernels.reset_launch_counts()
                losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                                        use_program_cache=cached)[0]) for f in feeds]
                paths[cached] = (losses, _state(scope), kernels.launch_counts())
    finally:
        torch.backends.cudnn.deterministic = det
    assert paths[True][0] == paths[False][0] and all(np.isfinite(paths[True][0]))
    for n, v in paths[False][1].items():
        np.testing.assert_array_equal(paths[True][1][n], v, err_msg=n)
    assert paths[False][2].get("dropout") == 12 and paths[True][2].get("dropout") == 12


# ---------------------------------------------------------------------------
# the sequence, RNN-unit and sampled-loss op types (A1b part 2) and their
# layers, and the book's sentiment program
# ---------------------------------------------------------------------------
def _seq_unit_cases():
    """name -> (op type, inputs, attrs, outputs) for every op type A1b's
    second part adds, each a capture must hold (nce with each sampler)."""
    rng = np.random.RandomState(22)
    seq = _f32(rng, 4, 7, 5)
    lens = np.array([0, 7, 3, 5], "int32")
    one = {"Out": 1}
    c = {"cos_sim": ("cos_sim", {"X": [_f32(rng, 6, 8)], "Y": [_f32(rng, 1, 8)]}, {},
                     {"Out": 1, "XNorm": 1, "YNorm": 1}),
         "sequence_conv": ("sequence_conv", {"X": [seq], "Filter": [_f32(rng, 20, 6)],
                                             "SeqLen": [lens]},
                           {"contextStart": -2, "contextLength": 4}, one),
         "row_conv": ("row_conv", {"X": [seq], "Filter": [_f32(rng, 3, 5)], "SeqLen": [lens]},
                      {}, one),
         "im2sequence": ("im2sequence", {"X": [_f32(rng, 2, 3, 7, 9)]},
                         {"kernels": [2, 3], "strides": [1, 2]}, one),
         "lstm_unit": ("lstm_unit", {"X": [_f32(rng, 5, 24)], "C_prev": [_f32(rng, 5, 6)]},
                       {"forget_bias": 0.5}, {"C": 1, "H": 1}),
         "gru_unit": ("gru_unit", {"Input": [_f32(rng, 5, 18)], "HiddenPrev": [_f32(rng, 5, 6)],
                                   "Weight": [_f32(rng, 6, 18)], "Bias": [_f32(rng, 1, 18)]},
                      {}, {"Gate": 1, "ResetHiddenPrev": 1, "Hidden": 1}),
         "hierarchical_sigmoid": ("hierarchical_sigmoid",
                                  {"X": [_f32(rng, 6, 8)], "Label": [rng.randint(0, 10, (6, 1))],
                                   "W": [_f32(rng, 9, 8)], "Bias": [_f32(rng, 9)]},
                                  {"num_classes": 10}, {"Out": 1, "PreOut": 1}),
         "hierarchical_sigmoid_custom": (
             "hierarchical_sigmoid",
             {"X": [_f32(rng, 4, 8)], "Label": [np.zeros((4, 1), "int64")],
              "W": [_f32(rng, 5, 8)], "PathTable": [np.array([[0, 1, 3], [0, 2, -1],
                                                              [0, 1, 4], [0, -1, -1]])],
              "PathCode": [rng.randint(0, 2, (4, 3))]},
             {"num_classes": 5, "is_custom": True}, {"Out": 1, "PreOut": 1}),
         "warpctc": ("warpctc", {"Logits": [_f32(rng, 4, 12, 6)],
                                 "Label": [rng.randint(1, 6, (4, 4))],
                                 "LogitsLength": [np.array([12, 9, 3, 12])],
                                 "LabelLength": [np.array([4, 2, 4, 0])]},
                     {"norm_by_times": True}, {"Loss": 1}),
         "sequence_reshape": ("sequence_reshape", {"X": [_f32(rng, 3, 4, 6)],
                                                   "SeqLen": [np.array([4, 2, 0], "int32")]},
                              {"new_dim": 8}, {"Out": 1, "OutSeqLen": 1}),
         "sequence_scatter": ("sequence_scatter",
                              {"X": [_f32(rng, 3, 10)], "Ids": [rng.randint(0, 10, (3, 5))],
                               "Updates": [_f32(rng, 3, 5)],
                               "SeqLen": [np.array([5, 2, 0], "int32")]}, {}, one),
         "chunk_eval": ("chunk_eval", {"Inference": [rng.randint(0, 7, (5, 9))],
                                       "Label": [rng.randint(0, 7, (5, 9))],
                                       "SeqLength": [np.array([9, 0, 4, 7, 1])]},
                        {"chunk_scheme": "IOB", "num_chunk_types": 3,
                         "excluded_chunk_types": [1]},
                        {"Precision": 1, "Recall": 1, "F1-Score": 1, "NumInferChunks": 1,
                         "NumLabelChunks": 1, "NumCorrectChunks": 1})}
    dist = rng.uniform(0.1, 1.0, 50).astype("float32")
    for sampler in ("uniform", "log_uniform", "custom_dist"):
        attrs = {"num_neg_samples": 7, "sampler": sampler, "seed": 3}
        if sampler == "custom_dist":
            attrs["custom_dist"] = dist
        c["nce_" + sampler] = ("nce", {"Input": [_f32(rng, 6, 8)],
                                       "Label": [rng.randint(0, 50, (6, 1))],
                                       "Weight": [_f32(rng, 50, 8)], "Bias": [_f32(rng, 50)],
                                       "SampleWeight": [np.abs(_f32(rng, 6, 1)) + 0.5]},
                               attrs, {"Cost": 1})
    return c


@pytest.mark.parametrize("case", sorted(_seq_unit_cases()))
def test_seq_unit_op_type_under_capture(card, case):
    """Each op type alone in a program on the card, its plan free of eager
    ops: an eager run, a capture and two replays against the eager path,
    bit for bit under deterministic algorithms, and against the CPU
    interpreter within 1e-5 (ids and counts exactly); nce draws the same
    negatives on either device, so its cost is held to the CPU's too."""
    op_type, inputs, attrs, outs = _seq_unit_cases()[case]
    main, feed, fetch = _a1b_program(card, op_type, inputs, attrs, outs)
    cpu = tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed, fetch_list=fetch,
                                                 scope=tfluid.Scope())
    exe, scope = tfluid.Executor(), tfluid.Scope()
    ref_exe, ref_scope = tfluid.Executor(), tfluid.Scope()
    assert exe._analyze(main, tuple(sorted(feed)), tuple(fetch)).eager_ops == ()
    with _Deterministic():
        for _ in range(4):
            got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
            ref = ref_exe.run(main, feed=feed, fetch_list=fetch, scope=ref_scope,
                              use_program_cache=False)
            for n, g, r, h in zip(fetch, got, ref, cpu):
                np.testing.assert_array_equal(g, r, err_msg=n)
                np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(h, np.float64),
                                           rtol=1e-5, atol=1e-5, err_msg=n)
    assert exe.jit_cache_stats()["graphs"] == 1


@pytest.mark.parametrize("sampler", ["uniform", "log_uniform", "custom_dist"])
def test_nce_negatives_on_card_equal_the_cpu_draw(card, sampler):
    """The sampler reads nothing on the host: a device label sum in, the
    same Philox words, so the same ids, on either device; captured in a
    graph of its own, a replay draws them again."""
    from paddle_tpu_torch.ops import nn_ops

    probs = torch.rand(30522, generator=torch.Generator().manual_seed(1)) + 0.1
    probs = probs / probs.sum()
    sums = torch.arange(0, 4096 * 977, 977)
    cpu = nn_ops.nce_negatives(sums, 11, 10, 30522, sampler, probs)
    dev_sums = sums.to(card)
    dev_probs = probs.to(card)
    got = nn_ops.nce_negatives(dev_sums, 11, 10, 30522, sampler, dev_probs)
    torch.testing.assert_close(got.cpu(), cpu, rtol=0, atol=0)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        nn_ops.nce_negatives(dev_sums, 11, 10, 30522, sampler, dev_probs)  # warm-up
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = nn_ops.nce_negatives(dev_sums, 11, 10, 30522, sampler, dev_probs)
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=0)


def _seq_unit_train_program(seed=7):
    """The differentiable A1b part 2 layers but im2sequence (whose rows
    are patches, not examples) in one small training program."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = seed
    L, nets = tfluid.layers, tfluid.nets
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        words = L.data("words", [12], dtype="int64", lod_level=1)
        lens = main.global_block().var("words_seq_len")
        label = L.data("label", [1], dtype="int64")
        emb = L.embedding(words, size=[40, 8])
        a = nets.sequence_conv_pool(emb, 6, 3, act="tanh", pool_type="sqrt", seq_len=lens)
        r = L.sequence_pool(L.row_conv(emb, 2, seq_len=lens), "sum", seq_len=lens)
        h, c = L.lstm_unit(a, L.fc(r, 4), L.fc(r, 4))
        gh, _, _ = L.gru_unit(L.fc(h, 12), h, 12)
        feat = L.concat([gh, L.fc(c, 18)], axis=1)
        ctc = L.warpctc(L.reshape(L.fc(feat, 24), [-1, 4, 6]),
                        L.data("ctc_label", [2], dtype="int64"))
        loss = L.mean(L.sums([
            L.hsigmoid(feat, label, 20), L.nce(feat, label, 20, num_neg_samples=5,
                                               sampler="log_uniform"),
            ctc * 0.1, L.reshape(L.cos_sim(feat, L.fc(feat, 22)), [-1, 1])]))
        tfluid.optimizer.AdamOptimizer(1e-3).minimize(loss)
    return main, startup, loss


def test_seq_unit_layers_train_captured_bit_equal_to_eager(card):
    """Their forward and vjp in one training program: three captured
    steps against three eager ones from one state, under deterministic
    algorithms, the losses and every persistable bit for bit; and the
    first step's loss against the CPU within 1e-4."""
    main, startup, loss = _seq_unit_train_program()
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(1)
    # no empty review: its row of the cos_sim is 0, whose norm has no gradient
    feeds = [{"words": rng.randint(0, 40, (4, 12)), "words_seq_len": np.array([12, 5, 1, 9],
                                                                               "int32"),
              "label": rng.randint(0, 20, (4, 1)), "ctc_label": rng.randint(1, 6, (4, 2))}
             for _ in range(3)]
    with _Deterministic():
        paths = {}
        for cached in (False, True):
            exe, scope = tfluid.Executor(), _scope_from(init, card)
            if cached:  # the entry's eager warm-up, on a scope of its own
                exe.run(main, feed=feeds[0], fetch_list=[loss], scope=_scope_from(init, card))
            losses = [float(exe.run(main, feed=f, fetch_list=[loss], scope=scope,
                                    use_program_cache=cached)[0]) for f in feeds]
            paths[cached] = (losses, _state(scope), exe.jit_cache_stats()["graphs"])
    assert paths[True][0] == paths[False][0] and paths[True][2] == 1
    assert np.isfinite(paths[True][0]).all()
    for n, v in paths[False][1].items():
        np.testing.assert_array_equal(paths[True][1][n], v, err_msg=n)
    cpu_scope = tfluid.Scope(device="cpu")
    for n, v in init.items():
        cpu_scope.set(n, v)
    cpu, = tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feeds[0], fetch_list=[loss],
                                                  scope=cpu_scope)
    np.testing.assert_allclose(paths[False][0][0], float(cpu), rtol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints against captured steps (faults/checkpoint.py): a captured step
# writes each new value into the scope's own tensor in place, so an async
# save must copy before the next replay, and a restore must land where the
# graph reads
# ---------------------------------------------------------------------------
def _ckpt_program():
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [16])
        y = tfluid.layers.data("y", [1])
        h = tfluid.layers.fc(x, 32, act="relu")
        loss = tfluid.layers.mean(tfluid.layers.square_error_cost(tfluid.layers.fc(h, 1), y))
        tfluid.optimizer.AdamOptimizer(0.01).minimize(loss)
    return main, startup, loss


def _ckpt_feed(i):
    rng = np.random.RandomState(100 + i)
    x = rng.randn(8, 16).astype("float32")
    return {"x": x, "y": x[:, :1] * 2.0}


def test_async_snapshot_is_taken_before_the_next_replay(card, tmp_path):
    """save_async returns with every persistable already on the host: the
    replay right after it and in-place writes to the live tensors do not
    reach the checkpoint."""
    from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint

    main, startup, loss = _ckpt_program()
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    for i in range(3):  # eager, capture, replay
        exe.run(main, feed=_ckpt_feed(i), fetch_list=[loss], scope=scope)
    assert exe.jit_cache_stats()["graphs"] == 1
    want = {n: t.detach().cpu().clone() for n, t in scope.vars.items()}
    ck = TrainCheckpoint(str(tmp_path / "run"))
    ck.save_async(main, scope, step=3)
    exe.run(main, feed=_ckpt_feed(3), fetch_list=[loss], scope=scope)  # an in-place replay
    for t in scope.vars.values():
        t.add_(1.0)  # and a direct in-place write
    ck.wait()
    fresh = tfluid.Scope(device=card)
    assert ck.restore(main, fresh)["step"] == 3
    for n, t in want.items():
        assert torch.equal(fresh.vars[n].cpu(), t), n


def test_restore_writes_into_a_captured_graphs_buffers(card, tmp_path):
    """A restore into a scope a graph was captured on writes the graph's own
    buffers in place (the scope keeps the same tensors), so the next replay
    continues from the checkpoint: its loss equals a run that never left
    that step, bit for bit."""
    from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint

    main, startup, loss = _ckpt_program()
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    ck = TrainCheckpoint(str(tmp_path / "run"))
    losses = []
    for i in range(6):
        if i == 3:
            ck.save(main, scope, step=3)
        losses.append(exe.run(main, feed=_ckpt_feed(i), fetch_list=[loss], scope=scope)[0])
    tensors = dict(scope.vars)
    assert ck.restore(main, scope)["step"] == 3
    assert all(scope.vars[n] is t for n, t in tensors.items())  # in place: the same tensors
    again = [exe.run(main, feed=_ckpt_feed(i), fetch_list=[loss], scope=scope)[0]
             for i in range(3, 6)]
    assert exe.jit_cache_stats()["graphs"] == 1
    np.testing.assert_array_equal(np.array(again), np.array(losses[3:]))


def test_restore_keeps_a_bf16_persistable_bf16(card, tmp_path):
    """A bf16 scope tensor saved (as float32, numpy has no bfloat16) comes
    back as bf16, in place, with its values."""
    from paddle_tpu_torch.faults.checkpoint import TrainCheckpoint

    main, startup, loss = _ckpt_program()
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    name = sorted(n for n in scope.vars if n.endswith("w_0"))[0]
    scope.vars[name] = scope.vars[name].to(torch.bfloat16)
    want = scope.vars[name].clone()
    ck = TrainCheckpoint(str(tmp_path / "run"))
    ck.save(main, scope, step=1)
    scope.vars[name].zero_()
    ck.restore(main, scope)
    assert scope.vars[name].dtype == torch.bfloat16
    assert torch.equal(scope.vars[name], want)


# ---------------------------------------------------------------------------
# continuous-batching decode: kernel B3 and the slot pool's CUDA graphs
# ---------------------------------------------------------------------------
DEC_LM = dict(vocab=97, d_model=128, n_layer=2, n_head=2, d_inner=256, max_pos=64)
DEC_DIMS = [DEC_LM[k] for k in ("vocab", "d_model", "n_layer", "n_head", "d_inner")]
B3_TOL = 1e-5  # of max |ctx|: fp32 sums in another order


def _b3_case(card, T, K, dh, q_scale=1.0):
    from torch_b3_cases import b3_inputs

    rng = np.random.RandomState(T * 100 + K * 10 + dh)
    q, kc, ks, vc, vs, ts = (torch.from_numpy(a).to(card)
                             for a in b3_inputs(rng, T, K, dh, q_scale=q_scale))
    return q, kc, ks, vc, vs, ts, dh ** -0.5


def _b3_holds(got, want):
    err = float((got.double() - want.double()).abs().max())
    assert torch.isfinite(got).all()
    assert err <= B3_TOL * float(want.abs().max()), err


@pytest.mark.parametrize("T", [100, 300, 2048])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("dh", [32, 64, 128])
def test_decode_attention_kernel_against_plain(card, T, K, dh):
    """ts at 0, at each chunk boundary of split_plan(T) (its widest split)
    and one either side of it (and where the last query lands there), at
    T - K and at T - 1: the kernel with its own plan, and with that widest
    split (merged over a cluster), within B3_TOL of the plain version, each
    bit for bit across two launches."""
    from paddle_tpu_torch.kernels import decode_attention as kda

    args = _b3_case(card, T, K, dh)
    kernels.reset_launch_counts()
    got = kda.decode_attention(*args)
    assert kernels.launch_counts().get(kda.KERNEL_NAME) == 1
    want = kda.decode_attention_plain(*args)
    _b3_holds(got, want)
    assert torch.equal(got, kda.decode_attention(*args))  # one order of sums: bit for bit
    split = kda.decode_attention_kernel(*args, plan=kda.split_plan(T))
    _b3_holds(split, want)
    assert torch.equal(split, kda.decode_attention_kernel(*args, plan=kda.split_plan(T)))


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("S,T", [(8, 256), (8, 512), (16, 256), (16, 512)])
def test_decode_attention_kernel_at_the_server_rungs(card, S, T, K):
    """The int8 server's lower slot rungs at its length rungs, 8 heads of
    64, ts spread from 0 to T - 4 as in traffic, under the card's own
    split_plan: within B3_TOL of the plain version, bit for bit across two
    launches."""
    from paddle_tpu_torch import quant
    from paddle_tpu_torch.kernels import decode_attention as kda

    gen = torch.Generator(device=card).manual_seed(S * 1000 + T + K)
    H, dh = 8, 64
    q = torch.randn(S, K, H, dh, device=card, generator=gen)
    kc, ks = quant.quantize_rows(torch.randn(S, H, T, dh, device=card, generator=gen) * 2)
    vc, vs = quant.quantize_rows(torch.randn(S, H, T, dh, device=card, generator=gen))
    ts = torch.linspace(0, T - 4, S, device=card).round().to(torch.int32)
    args = (q, kc, ks, vc, vs, ts, dh ** -0.5)
    got = kda.decode_attention(*args)
    _b3_holds(got, kda.decode_attention_plain(*args))
    assert torch.equal(got, kda.decode_attention(*args))


@pytest.mark.parametrize("K", [1, 4, 8])
def test_decode_attention_kernel_large_scores(card, K):
    """q scaled x100: scores in the thousands, so the running max moves
    across tiles, warps and chunks, and nearly all weight sits on few
    positions.  Held to the plain version's math in float64, within
    B3_TOL of max |ctx| or twice the plain version's own fp32 error
    against it, whichever is larger: in fp32 a dot product of 64 terms
    near 1e4 rounds by about 1e-2, so either version's scores move by
    about 1e-4, and its weights by as much relatively (a wrong merge of
    the running max moves them by order 1)."""
    from paddle_tpu_torch.kernels import decode_attention as kda

    args = _b3_case(card, 2048, K, 64, q_scale=100.0)
    q, kc, ks, vc, vs, ts, scale = args
    want = kda.decode_attention_plain(q.double(), kc, ks.double(), vc, vs.double(), ts, scale)
    plain_err = float((kda.decode_attention_plain(*args).double() - want).abs().max())
    tol = max(B3_TOL * float(want.abs().max()), 2 * plain_err)
    for got in (kda.decode_attention(*args),
                kda.decode_attention_kernel(*args, plan=kda.split_plan(2048))):
        assert torch.isfinite(got).all()
        err = float((got.double() - want).abs().max())
        assert err <= tol, (err, tol, plain_err)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("split", [False, True])
def test_decode_attention_kernel_in_a_cuda_graph(card, K, split):
    """The kernel launched inside a captured CUDA graph (its own plan, or
    split 8 ways: a cluster launch captured): the replay writes what the
    eager launch wrote, bit for bit."""
    from paddle_tpu_torch.kernels import decode_attention as kda

    args = _b3_case(card, 2048, K, 64)

    def launch():
        if not split:
            return kda.decode_attention(*args)
        return kda.decode_attention_kernel(*args, plan=kda.split_plan(2048))

    eager = launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = launch()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def _dec_pool(card, kv_dtype, **kw):
    from paddle_tpu_torch import decoding
    from paddle_tpu_torch.serving.kv_pool import KVSlotPool

    state = decoding.random_transformer_lm_state(np.random.RandomState(3), **DEC_LM)
    sf, mc = decoding.make_transformer_lm_pooled_step_fn(state, *DEC_DIMS, kv_dtype=kv_dtype,
                                                         place=tfluid.CUDAPlace(0))
    return KVSlotPool(sf, mc, eos_id=DEC_LM["vocab"] + 1, max_slots=4, max_seq_len=64,
                      slot_ladder=[2, 4], len_ladder=[32, 64], steps=3, kv_dtype=kv_dtype, **kw)


def _seat(pool, st, rng, slots):
    for slot in slots:
        n = int(rng.randint(3, 12))
        st = pool.admit(st, slot, rng.randint(0, DEC_LM["vocab"], n).astype(np.int32), n,
                        int(pool.state_rungs(st)[1]))
    return st


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8"])
def test_captured_chunk_equals_eager_chunk(card, kv_dtype):
    """The same admits and five chunks, through the warmed graphs and
    through the plain functions on a copy of the state: ids and flags
    equal, the cache within 1e-5 (a replay and an eager run launch the
    same kernels, but cuBLAS may pick another algorithm under capture)."""
    from paddle_tpu_torch import decoding

    pool = _dec_pool(card, kv_dtype)
    pool.warmup()
    st = _seat(pool, pool.alloc(2, 32), np.random.RandomState(0), [0, 1])
    eager = {k: (v.clone() if isinstance(v, torch.Tensor) else
                 [{n: x.clone() for n, x in layer.items()} for layer in v]) for k, v in st.items()}
    chunk = pool._plain["chunk"]
    kernels.reset_launch_counts()
    for _ in range(5):
        st = pool.chunk(st)
        chunk(eager)
    torch.cuda.synchronize()
    for k in ("tokens", "pos", "active", "finished", "n_gen"):
        assert torch.equal(st[k], eager[k]), k
    for a, b in zip(decoding.kv_tree_leaves(st["cache"]), decoding.kv_tree_leaves(eager["cache"])):
        assert float((a.float() - b.float()).abs().max()) <= (1.0 if a.dtype == torch.int8 else 1e-5)
    assert int(st["n_gen"].sum()) > 0
    b3 = kernels.launch_counts().get("decode_attention_int8", 0)
    # 2 layers x 3 steps a chunk x 5 chunks, each path (replays and eager)
    assert b3 == (2 * 3 * 5 * 2 if kv_dtype == "int8" else 0)


def test_zero_captures_after_warmup_and_resize_with_live_slots(card):
    """Every dispatch after warmup is a replay (no miss), across a slot
    and a length rung transition while two slots are mid-decode: the
    resize copies the live state into the larger pair's buffers on the
    card (zero-padded, as the JAX package's host resize leaves it), and
    decoding goes on from there."""
    from paddle_tpu_torch import decoding

    pool = _dec_pool(card, "fp32")
    n = pool.warmup()
    assert n == len(pool.rung_pairs()) * 3
    assert pool.state_bytes() > 0 and pool.graph_pool_bytes() >= 0
    st = _seat(pool, pool.alloc(2, 32), np.random.RandomState(1), [0, 1])
    for _ in range(2):
        st = pool.chunk(st)
    before = {k: st[k].clone() for k in ("tokens", "pos", "n_gen", "active")}
    kv_before = [x.clone() for x in decoding.kv_tree_leaves(st["cache"])]
    big = pool.resize(st, 4, 64)
    assert pool.state_rungs(big) == (4, 64) and big is pool._buffers(4, 64)
    assert torch.equal(big["tokens"][:2, :32], before["tokens"])
    assert int(big["tokens"][2:].abs().sum()) == 0 and int(big["tokens"][:, 32:].abs().sum()) == 0
    for k in ("pos", "n_gen", "active"):
        assert torch.equal(big[k][:2], before[k]) and not bool(big[k][2:].any()), k
    for a, b in zip(decoding.kv_tree_leaves(big["cache"]), kv_before):
        assert torch.equal(a[:2, :, :32], b) and float(a[2:].abs().max()) == 0.0
    big = pool.chunk(big)
    assert bool((big["n_gen"][:2] >= before["n_gen"]).all())
    big = pool.release(big, [1])
    assert not bool(big["active"][1])
    assert pool.jit_cache_stats()["misses"] == 0


# ---------------------------------------------------------------------------
# bf16 precision variants served over two replicas on one card
# ---------------------------------------------------------------------------
def _export_bf16_bert(card, tmp_path):
    from paddle_tpu_torch.models import transformer

    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 16
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        ids = tfluid.layers.data("src_ids", [16], dtype="int64")
        mask = tfluid.layers.data("input_mask", [16], dtype="float32")
        out = transformer.bert_encoder(ids, mask, **SMALL_BERT)
    exe, scope = tfluid.Executor(), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(16)
    tfluid.io.save_inference_model(
        str(tmp_path), FEEDS, [out], exe, main_program=main, scope=scope,
        precision_policy={"dtype": "bf16", "parity_feeds": [_bert_feed(rng, 4)]})
    return str(tmp_path)


def test_bf16_replicas_capture_at_warmup_and_match_eager(card, tmp_path):
    """A bf16 endpoint on two replicas: the warm-up captures one graph per
    (rung, dtype) on each replica's executor, traffic mixing bf16 and the
    fp32 opt-out captures nothing more, each dispatch launches the forward
    kernel twice in its dtype, and every answer equals the same request run
    eagerly (``use_program_cache=False``) at the bucket it was served in
    (a replayed graph runs the eager kernels: 1e-5 of the output scale)."""
    d = _export_bf16_bert(card, tmp_path)
    preds = [tfluid.inference.create_paddle_predictor(tfluid.inference.AnalysisConfig(d))
             for _ in range(2)]
    server = serving.InferenceServer(preds, max_batch_size=8, batch_timeout_ms=2,
                                     target_queue_wait_ms=60_000.0, name="card-bf16")
    kernels.reset_launch_counts()
    rng = np.random.RandomState(17)
    feeds = [_bert_feed(rng, r) for r in (1, 3, 8, 5, 2, 8, 4, 7)]
    precs = [None if i % 3 else "fp32" for i in range(len(feeds))]
    try:
        server.warmup()
        warm = [p.jit_cache_stats() for p in preds]
        assert all(w["graphs"] == 2 * len(server.bucket_ladder) for w in warm)
        answers = [None] * len(feeds)

        def go(i):
            answers[i] = serving.Client(server).infer(feeds[i], precision=precs[i])[0]

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(feeds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        m = server.metrics()
    finally:
        server.stop(drain=True, timeout=60)
    assert [p.jit_cache_stats()["graphs"] for p in preds] == [w["graphs"] for w in warm]
    assert m["recompiles"] == 0 and m["completed"] == len(feeds)
    by = kernels.launch_counts_by_dtype()[fa.KERNEL_NAME]
    each = m["warmup_runs"] // 2
    assert by == {"bfloat16": 2 * (m["precision_batches"].get("bf16", 0) + each),
                  "float32": 2 * (m["precision_batches"].get("fp32", 0) + each)}
    policy = serving.BucketPolicy(8)
    for f, prec, ans in zip(feeds, precs, answers):
        rows = f["src_ids"].shape[0]
        program, scope = preds[0]._select_variant(prec)
        best = np.inf
        for b in (x for x in policy.ladder if x >= rows):
            eager, = preds[0]._exe.run(program, feed=policy.pad_feed(f, b),
                                       fetch_list=preds[0]._fetch_names, scope=scope,
                                       use_program_cache=False)
            best = min(best, float(np.abs(eager[:rows] - ans).max()) / float(np.abs(ans).max()))
        assert best <= 1e-5, (prec, rows, best)


def test_bf16_endpoint_card_against_cpu(card, tmp_path):
    """The same bf16 variant on the card and on the CPU: within the
    policy's rtol of the output's scale (each is within it of fp32), and
    the fp32 opt-out within 1e-4."""
    d = _export_bf16_bert(card, tmp_path)
    gpu = tfluid.inference.create_paddle_predictor(tfluid.inference.AnalysisConfig(d))
    cfg = tfluid.inference.AnalysisConfig(d)
    cfg.disable_gpu()
    cpu = tfluid.inference.create_paddle_predictor(cfg)
    rtol = gpu.precision_policy["rtol"]
    f = _bert_feed(np.random.RandomState(18), 3)
    g16, c16 = gpu.run(f)[0], cpu.run(f)[0]
    assert np.abs(g16 - c16).max() / np.abs(c16).max() <= rtol
    np.testing.assert_allclose(gpu.run(f, precision="fp32")[0], cpu.run(f, precision="fp32")[0],
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the dense parameter server and the collectives on the card
# ---------------------------------------------------------------------------
def _dense_ps_mlp(opt="adam"):
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 5
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        x = tfluid.layers.data("x", [64])
        y = tfluid.layers.data("y", [1], dtype="int64")
        h = tfluid.layers.fc(x, 128, act="relu")
        loss = tfluid.layers.mean(tfluid.layers.softmax_with_cross_entropy(
            tfluid.layers.fc(h, 10), y))
        (tfluid.optimizer.AdamOptimizer(0.01) if opt == "adam"
         else tfluid.optimizer.SGDOptimizer(0.1)).minimize(loss)
    return main, startup, loss


def _dense_ps_trainer_run(card, init, feeds, cached):
    """One sync trainer on a pserver served from a thread of this process:
    each step pushes its gradients, the server applies Adam, the pull puts
    new tensors in the scope."""
    main, _, loss = _dense_ps_mlp()
    ep_sock = __import__("socket").socket()
    ep_sock.bind(("127.0.0.1", 0))
    ep = "127.0.0.1:%d" % ep_sock.getsockname()[1]
    ep_sock.close()
    t = tfluid.DistributeTranspiler()
    t.transpile(0, program=main, pservers=ep, trainers=1)
    tprog, pprog = t.get_trainer_program(), t.get_pserver_program(ep)
    threading.Thread(target=tfluid.Executor(tfluid.CPUPlace()).run, args=(pprog,),
                     daemon=True).start()
    try:
        exe, scope = tfluid.Executor(), _scope_from(init, card)
        out = [exe.run(tprog, feed=f, fetch_list=[loss], scope=scope,
                       use_program_cache=cached)[0] for f in feeds]
        return out, exe.jit_cache_stats(), _state(scope)
    finally:
        for _ in range(100):
            if getattr(pprog, "_pserver", None) is not None:
                break
            threading.Event().wait(0.05)
        pprog._pserver.stop()


def test_dense_ps_captured_steps_match_their_eager_twin(card):
    """A dense-PS trainer's captured steps read the parameters each pull
    put in the scope (the replay copies them into its buffers first): its
    losses and pulled parameters bit for bit those of the same steps run
    eagerly (``use_program_cache=False``) against a server of their own."""
    _, startup, _ = _dense_ps_mlp()
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(32, 64).astype("float32"),
            "y": rng.randint(0, 10, (32, 1)).astype("int64")}
    feeds = [feed] * 5  # one batch: each step's loss must fall from the last
    with _Deterministic():
        got, stats, got_state = _dense_ps_trainer_run(card, init, feeds, cached=True)
        ref, _, ref_state = _dense_ps_trainer_run(card, init, feeds, cached=False)
    assert stats["graphs"] == 1
    assert [g.tobytes() for g in got] == [r.tobytes() for r in ref]
    assert all(b < a for a, b in zip(got, got[1:])), got
    for n in got_state:
        assert got_state[n].tobytes() == ref_state[n].tobytes(), n


def test_one_rank_collective_plan_is_captured(card):
    """A GradAllReduce program at one rank (no process group bound): its
    collectives are identities, the plan is captured, and its losses are
    bit for bit those of the program without the rewrite."""
    main, startup, loss = _dense_ps_mlp("sgd")
    boot = tfluid.Scope()
    tfluid.Executor().run(startup, scope=boot)
    init = _state(boot)
    plain, _, plain_loss = _dense_ps_mlp("sgd")
    tfluid.parallel.GradAllReduce().transpile(startup, main, 0, ["r0"], "r0")
    rng = np.random.RandomState(6)
    feeds = [{"x": rng.randn(32, 64).astype("float32"),
              "y": rng.randint(0, 10, (32, 1)).astype("int64")} for _ in range(4)]
    exe, ref_exe = tfluid.Executor(), tfluid.Executor()
    scope, ref_scope = _scope_from(init, card), _scope_from(init, card)
    with _Deterministic():
        got = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0] for f in feeds]
        ref = [ref_exe.run(plain, feed=f, fetch_list=[plain_loss], scope=ref_scope)[0]
               for f in feeds]
    assert exe.jit_cache_stats()["graphs"] == 1
    assert [g.tobytes() for g in got] == [r.tobytes() for r in ref]


# Kernel B2, the ring step: B1's forward with the merge in its epilogue,
# against ring_step_plain (B1's plain forward with statistics, then
# ring_merge_plain).  fp32 at this file's B1 tolerance; bf16 at B1's plus one
# rounding of the output (rtol 2**-8): the plain route rounds the block's
# output to bf16 before it merges, the kernel rounds once, at the store.
STEP_TOL = {torch.float32: TOL[torch.float32],
            torch.bfloat16: dict(atol=2e-2, rtol=2.0 ** -7 + 2.0 ** -8)}


def _ring_acc(card, q, dtype, seed):
    """A running output and its statistics as a ring holds them after its
    first block (B1's forward of q against another K/V block), in q's
    layout, with row 1 (n 0, h 0, t 1) the masked fill."""
    from paddle_tpu_torch.kernels import ring_attention as kra

    g = torch.Generator(device=card).manual_seed(seed)
    k0, v0 = (torch.randn(q.shape, generator=g, device=card).to(dtype) for _ in range(2))
    acc, st = fa.fused_attention_fwd(q, k0, v0, None, False, 0.125, return_stats=True)
    st[0, 0, 0, 1], st[1, 0, 0, 1] = kra.MASKED_FILL
    return acc, st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape,head_split", [((2, 8, 1024, 64), True), ((1, 3, 17, 10), False)],
                         ids=["lm_block", "ragged"])
@pytest.mark.parametrize("causal", [True, False], ids=["diagonal", "full"])
def test_ring_step_kernel_against_plain(card, dtype, shape, head_split, causal):
    """Kernel B2 on a running output with a masked-fill row: against
    ring_step_plain (STEP_TOL; statistics within 1e-5), written into acc's
    own storage with its strides kept, the masked-fill row equal to the
    block's own output, one launch counted under B2 and none under B1, and
    bit for bit across two launches."""
    from paddle_tpu_torch.kernels import ring_attention as kra

    q, k, v, _ = _inputs(card, *shape, dtype, head_split, seed=11)
    scale = 1.0 / float(np.sqrt(shape[3]))
    acc, st = _ring_acc(card, q, dtype, seed=12)
    ref_acc, ref_st = acc.clone(), st.clone()
    runs = []
    for _ in range(2):
        a, s_ = acc.clone(), st.clone()
        kernels.reset_launch_counts()
        out, out_st = kra.ring_step(q, k, v, causal, scale, a, s_)
        assert kernels.launch_counts() == {kra.KERNEL_NAME: 1}
        assert out is a and out_st is s_ and out.stride() == acc.stride()
        runs.append((a, s_))
    ptr = acc.data_ptr()
    kra.ring_step(q, k, v, causal, scale, acc, st)
    assert acc.data_ptr() == ptr
    block, _ = kra.ring_step(q, k, v, causal, scale)
    kra.ring_step_plain(q, k, v, causal, scale, ref_acc, ref_st)
    torch.cuda.synchronize()
    (a, s_), (a2, s2) = runs
    assert torch.equal(a, a2) and torch.equal(s_, s2) and torch.equal(a, acc)
    assert torch.isfinite(a.float()).all()
    torch.testing.assert_close(a.float(), ref_acc.float(), **STEP_TOL[dtype])
    torch.testing.assert_close(s_, ref_st, rtol=1e-5, atol=1e-5)
    assert torch.equal(a[0, 0, 1], block[0, 0, 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_steps_on_card_are_full_attention(card, dtype, causal):
    """A ring of 4 windows of [2, 8, 256, 64] in one process: each window's
    queries through ring_step over the K/V windows in the ring's order (its
    own first, causal; the higher ones skipped under causal) against
    attention over the whole sequence in float64 (STEP_TOL)."""
    from paddle_tpu_torch.kernels import ring_attention as kra

    n, tl = 4, 256
    g = torch.Generator(device=card).manual_seed(13)
    q, k, v = (torch.randn(2, 8, n * tl, 64, generator=g, device=card).to(dtype)
               for _ in range(3))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) * 0.125
    if causal:
        s = s.masked_fill(~torch.ones(n * tl, n * tl, dtype=torch.bool, device=card).tril(),
                          float("-inf"))
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v.double())
    kernels.reset_launch_counts()
    for r in range(n):
        out = st = None
        for hop in range(n):
            src = (r - hop) % n
            if causal and src > r:
                continue
            win, kw = slice(r * tl, (r + 1) * tl), slice(src * tl, (src + 1) * tl)
            out, st = kra.ring_step(q[:, :, win], k[:, :, kw], v[:, :, kw], causal and hop == 0,
                                    0.125, out, st)
        torch.testing.assert_close(out.double(), want[:, :, win], **STEP_TOL[dtype])
    merges = sum(range(n)) if causal else n * (n - 1)
    assert kernels.launch_counts() == {fa.KERNEL_NAME: n, kra.KERNEL_NAME: merges}


# Ring attention's backward: each block's dQ, dK, dV by B1's dK/dV and dQ
# kernels from the ring's merged statistics (kernels/ring_attention.py
# ring_block_bwd), against ring_block_bwd_plain at the backward kernels'
# limits (fp32 1e-4 * max(1, max|ref|); bf16 atol 2e-2 plus rtol 2**-7).
def _within_bwd(got, ref, dtype):
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        return (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())
    return bool(((got - ref).abs() <= 2e-2 + 2.0 ** -7 * ref.abs()).all().item())


def _two_block_ring(card, dtype, seed):
    """The second rank's window of a two-block causal ring at the hybrid
    engine's block [2, 8, 1024, 64] in the head split's layout: its own
    block (causal) then the lower rank's merged by ring_step; returns the
    inputs, the blocks, the merged statistics and Di."""
    from paddle_tpu_torch.kernels import ring_attention as kra

    n, h, t, d = 2, 8, 1024, 64
    g = torch.Generator(device=card).manual_seed(seed)

    def heads(s):
        return torch.randn(n, s, h, d, generator=g, device=card).to(dtype).permute(0, 2, 1, 3)

    q, d_out, k, v = heads(t), heads(t), heads(2 * t), heads(2 * t)
    blocks = {"diagonal": (k[:, :, t:], v[:, :, t:], True), "full": (k[:, :, :t], v[:, :, :t], False)}
    out, st = kra.ring_step(q, *blocks["diagonal"][:2], True, 0.125)
    out, st = kra.ring_step(q, *blocks["full"][:2], False, 0.125, out, st)
    di = (out.float() * d_out.float()).sum(-1)
    return q, k, v, d_out, blocks, st, di


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("block", ["diagonal", "full"])
def test_ring_block_bwd_kernels_against_plain(card, dtype, block):
    """One dK/dV and one dQ launch a block, against the plain version, bit
    for bit across two launches."""
    from paddle_tpu_torch.kernels import ring_attention as kra

    q, _, _, d_out, blocks, st, di = _two_block_ring(card, dtype, seed=31)
    kb, vb, causal = blocks[block]
    kernels.reset_launch_counts()
    got = kra.ring_block_bwd(q, kb, vb, causal, 0.125, d_out, st, di)
    assert kernels.launch_counts() == {fa.BWD_DKV_NAME: 1, fa.BWD_DQ_NAME: 1}
    again = kra.ring_block_bwd(q, kb, vb, causal, 0.125, d_out, st, di)
    ref = kra.ring_block_bwd_plain(q, kb, vb, causal, 0.125, d_out, st, di)
    torch.cuda.synchronize()
    for name, g_, a_, r_ in zip(("dq", "dk", "dv"), got, again, ref):
        assert g_.dtype == dtype and torch.isfinite(g_.float()).all(), name
        assert torch.equal(g_, a_), name
        assert _within_bwd(g_, r_, dtype), name


def test_ring_backward_on_card_is_attention_gradient(card):
    """The two blocks' gradients of the window (dQ summed, dK and dV in
    their blocks) against float64 attention of the window's queries over
    both blocks, causal (fp32 at the backward kernels' limit)."""
    from paddle_tpu_torch.kernels import ring_attention as kra

    q, k, v, d_out, blocks, st, di = _two_block_ring(card, torch.float32, seed=32)
    got = {b: kra.ring_block_bwd(q, kb, vb, c, 0.125, d_out, st, di)
           for b, (kb, vb, c) in blocks.items()}
    t = q.shape[2]
    qd, kd, vd, dod = q.double(), k.double(), v.double(), d_out.double()
    keep = torch.arange(2 * t, device=card)[None, :] <= (t + torch.arange(t, device=card))[:, None]
    p = torch.softmax((torch.einsum("bhqd,bhkd->bhqk", qd, kd) * 0.125).masked_fill(
        ~keep, float("-inf")), -1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dod, vd)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    want = (torch.einsum("bhqk,bhkd->bhqd", ds, kd) * 0.125,
            torch.einsum("bhqk,bhqd->bhkd", ds, qd) * 0.125,
            torch.einsum("bhqk,bhqd->bhkd", p, dod))
    ring = (got["diagonal"][0] + got["full"][0],
            torch.cat([got["full"][1], got["diagonal"][1]], 2),
            torch.cat([got["full"][2], got["diagonal"][2]], 2))
    for name, g_, w_ in zip(("dq", "dk", "dv"), ring, want):
        assert _within_bwd(g_, w_, torch.float32), name


def test_differentiable_ring_of_one_rank_on_card(card):
    """parallel.ring_attention with a gradient asked for, in one process (no
    group): B1's forward once, its dK/dV and dQ once, and the gradient of
    attention in float64."""
    from paddle_tpu_torch.parallel.ring_attention import ring_attention

    g = torch.Generator(device=card).manual_seed(33)
    q, k, v, d_out = (torch.randn(2, 8, 512, 64, generator=g, device=card) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kernels.reset_launch_counts()
    out = ring_attention(*leaves, None, causal=True)
    got = torch.autograd.grad(out, leaves, d_out)
    assert kernels.launch_counts() == {fa.KERNEL_NAME: 1, fa.BWD_DKV_NAME: 1, fa.BWD_DQ_NAME: 1}
    qd, kd, vd = (x.double().requires_grad_(True) for x in (q, k, v))
    s = (torch.einsum("bhqd,bhkd->bhqk", qd, kd) * 0.125).masked_fill(
        ~torch.ones(512, 512, dtype=torch.bool, device=card).tril(), float("-inf"))
    want = torch.autograd.grad(torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), vd),
                               (qd, kd, vd), d_out.double())
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert _within_bwd(g_, w_, torch.float32), name
