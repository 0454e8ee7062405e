"""paddle_tpu_torch on an NVIDIA card: the attention kernels (forward,
its log-sum-exp, and the dK/dV and dQ backward kernels) against their
plain versions, the small encoder served on the card against the CPU,
and a small pretraining step on the card against the CPU.

Every test here needs a CUDA card and skips without one (marker
``cuda``).  The file imports neither jax nor paddle_tpu, so it also runs
where JAX is not installed; there, skip the repo's conftest (which
imports JAX):

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerances: fp32 1e-4 (summation order: the kernel's fp32 FMAs against
cuBLAS).  bf16 atol 2e-2 plus rtol 2**-7: one to two bf16 ulps at any
output scale.  The plain version rounds scores and weights to bf16
where the kernel keeps fp32, and outputs of rows that attend few keys
(early causal rows) reach magnitude 4 to 8, where one bf16 ulp is
0.03.  The backward kernels take the same limits: fp32 at
1e-4 * max(1, max|ref|) (the products sum over up to 200 keys or
queries), bf16 at atol 2e-2 plus rtol 2**-7.  The log-sum-exp is fp32 in
both dtypes, at 1e-4.  The encoder on the card against the CPU at 1e-4,
as the JAX/port run parity; a training step's loss and gradients at
1e-3 relative (fp32 sums in other orders through two layers forward and
back).
"""
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


def _inputs(card, n, h, s, d, dtype, head_split, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)

    def make():
        if head_split:  # the [N, S, H, D] view the model's head split makes
            return torch.randn(n, s, h, d, generator=g, device=card).to(dtype).permute(0, 2, 1, 3)
        return torch.randn(n, h, s, d, generator=g, device=card).to(dtype)

    q, k, v = make(), make(), make()
    lens = torch.randint(1, s + 1, (n,), generator=g, device=card)
    lens[0] = s
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
    out, lse = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_lse=True)
    assert kernels.launch_counts() == {fa.KERNEL_NAME: 1}
    ref_out = fa.fused_attention_plain(q, k, v, mask, causal, scale)
    # the kernel scores bf16 inputs in fp32: the reference log-sum-exp is
    # that of the fp32 scores of the same values
    _, ref_lse = fa.fused_attention_plain(q.float(), k.float(), v.float(), mask, causal, scale,
                                          return_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref_out.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape,head_split", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_backward_kernels_match_plain(card, dtype, causal, shape, head_split, with_mask):
    q, k, v, mask = _inputs(card, *shape, dtype, head_split, seed=2)
    mask = mask if with_mask else None
    scale = 1.0 / float(np.sqrt(shape[3]))
    d_out = torch.randn(q.shape, generator=torch.Generator(device=card).manual_seed(3),
                        device=card).to(dtype)
    out, lse = fa.fused_attention_fwd(q, k, v, mask, causal, scale, return_lse=True)
    kernels.reset_launch_counts()
    grads = fa.fused_attention_bwd(q, k, v, mask, causal, scale, out, d_out, lse)
    assert kernels.launch_counts() == {fa.BWD_DKV_NAME: 1, fa.BWD_DQ_NAME: 1}
    refs = fa.fused_attention_bwd_plain(q, k, v, mask, causal, scale, out, d_out, lse)
    torch.cuda.synchronize()
    for name, g, ref, t in zip("QKV", grads, refs, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape, name
        assert torch.isfinite(g.float()).all(), name
        if dtype == torch.float32:
            err = (g - ref).abs().max().item()
            assert err <= 1e-4 * max(1.0, ref.abs().max().item()), (name, err)
        else:
            torch.testing.assert_close(g.float(), ref.float(), **TOL[dtype])


def test_autograd_through_kernels(card):
    """The op's gradient on a CUDA tensor runs the forward kernel with the
    log-sum-exp, then the two backward kernels; nothing of the plain
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
