"""paddle_tpu_torch on an NVIDIA card: the attention kernel against its
plain version, and the small encoder served on the card against the CPU.

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
0.03.  The encoder on the card against the CPU at 1e-4, as the
JAX/port run parity.
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
