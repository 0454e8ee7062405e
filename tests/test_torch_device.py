"""paddle_tpu_torch device rules and package isolation.

* Default entry points (``Executor()``, a default ``AnalysisConfig``)
  run on ``cuda:0`` and raise where there is no CUDA device; the CPU
  is only ever asked for explicitly.
* The attention wrapper sends a CPU tensor to its plain version and a
  meta tensor to a shape-only result; it launches (and counts) nothing.
* The package imports neither jax nor paddle_tpu.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import fused_attention as fa
from test_torch_parity import save_jax_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("make", [lambda: tfluid.Executor(),
                                  lambda: tfluid.Executor(tfluid.CUDAPlace(0))],
                         ids=["default", "cuda_place"])
def test_executor_without_cuda_raises(no_cuda, make):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        make()


def test_executor_cpu_place_runs_on_cpu(no_cuda):
    assert tfluid.Executor(tfluid.CPUPlace()).device == torch.device("cpu")


def test_default_predictor_without_cuda_raises(no_cuda, tmp_path):
    save_jax_model(tmp_path)
    cfg = tfluid.inference.AnalysisConfig(str(tmp_path))
    assert cfg.use_gpu()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tfluid.inference.create_paddle_predictor(cfg)
    cfg.disable_gpu()
    assert tfluid.inference.create_paddle_predictor(cfg).device == torch.device("cpu")


def test_places_map_to_torch_devices():
    assert tfluid.CPUPlace().device() == torch.device("cpu")
    assert tfluid.CUDAPlace(1).device() == torch.device("cuda", 1)
    assert len(tfluid.cuda_places()) == torch.cuda.device_count()


def test_scope_never_mixes_devices():
    scope = tfluid.Scope()
    with pytest.raises(RuntimeError, match="no device yet"):
        scope.set("w", np.ones(2, "float32"))
    scope.bind_device("cpu")
    scope.set("w", np.ones(2, "float32"))
    assert scope.get("w").device.type == "cpu"
    with pytest.raises(ValueError, match="cannot run it on cuda"):
        scope.bind_device(torch.device("cuda", 0))


def _qkv(n=2, h=3, s=10, d=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, h, s, d, generator=g) for _ in range(3)]


def test_attention_wrapper_cpu_uses_plain_and_launches_nothing(monkeypatch):
    q, k, v = _qkv()
    mask = torch.ones(2, 10)
    mask[1, 6:] = 0
    calls = []
    plain = fa.fused_attention_plain

    def spy(*args):
        calls.append(args)
        return plain(*args)

    monkeypatch.setattr(fa, "fused_attention_plain", spy)
    kernels.reset_launch_counts()
    out = fa.fused_attention_fwd(q, k, v, mask, True, 0.5)
    assert len(calls) == 1
    assert torch.equal(out, plain(q, k, v, mask, True, 0.5))
    assert kernels.launch_counts().get(fa.KERNEL_NAME, 0) == 0


def test_attention_wrapper_meta_is_shape_only():
    q, k, v = (t.to("meta") for t in _qkv(s=7, d=5))
    out = fa.fused_attention_fwd(q, k, v, None, False, 1.0)
    assert out.device.type == "meta" and tuple(out.shape) == (2, 3, 7, 5)


def test_import_leaves_jax_and_paddle_tpu_out():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.models.transformer, paddle_tpu_torch.serving.wire, "
            "paddle_tpu_torch.serving.wire.launch, paddle_tpu_torch.serving.embedding_cache, "
            "paddle_tpu_torch.transpiler, paddle_tpu_torch.parallel, "
            "paddle_tpu_torch.ops.collective_ops, paddle_tpu_torch.distributed.launch\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_sources_name_no_jax_or_paddle_tpu():
    pattern = re.compile(r"import jax|from jax|paddle_tpu\b(?!_torch)")
    root = os.path.join(REPO, "paddle_tpu_torch")
    hits = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in ("_build", "__pycache__")]
        for fn in files:
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as f:
                for i, line in enumerate(f, 1):
                    if pattern.search(line):
                        hits.append("%s:%d: %s" % (os.path.relpath(path, REPO), i, line.strip()))
    assert not hits, "\n".join(hits)
