"""Inference engine: config + predictor.

Port of the JAX package's ``inference.py`` (reference:
paddle/fluid/inference/api/ — AnalysisConfig, AnalysisPredictor,
CreatePaddlePredictor).  The predictor loads a saved inference model
into its own scope on its device and runs it through an Executor; the
weights stay resident on the device between runs.  On a card each feed
signature (each serving bucket) becomes a captured CUDA graph at its
second run on one thread.  Precision variants and sharding come with
later slices of the port.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import framework, io
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.scope import Scope

__all__ = ["AnalysisConfig", "PaddlePredictor", "AnalysisPredictor", "create_paddle_predictor"]


class AnalysisConfig:
    """reference: api/paddle_analysis_config.h.  A config that neither
    enables nor disables the GPU runs on ``cuda:0`` (and the predictor
    raises where there is none); ``disable_gpu()`` runs on the CPU."""

    def __init__(self, model_dir: Optional[str] = None):
        self.model_dir = model_dir
        self.params_file: Optional[str] = None
        self._use_gpu = True
        self._device_id = 0

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def place(self) -> framework.Place:
        return framework.CUDAPlace(self._device_id) if self._use_gpu else framework.CPUPlace()

    def set_model(self, model_dir: str, params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.params_file = params_file

    def switch_use_feed_fetch_ops(self, flag: bool):
        pass  # feeds and fetches are the predictor's arguments and results

    def switch_ir_optim(self, flag: bool = True):
        pass  # the saved program runs as it is


class PaddlePredictor:
    """The predictors' base class (reference: api/paddle_api.h)."""


class AnalysisPredictor(PaddlePredictor):
    """reference: api/analysis_predictor.h:46."""

    def __init__(self, config: AnalysisConfig):
        self.config = config
        self._exe = Executor(config.place())
        self.device: torch.device = self._exe.device
        self._scope = Scope(device=self.device)
        self._program, self._feed_names, self._fetch_vars = io.load_inference_model(
            config.model_dir, self._exe, params_filename=config.params_file, scope=self._scope)
        self._fetch_names = [v.name for v in self._fetch_vars]

    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def run(self, feed: Dict[str, np.ndarray] | Sequence[np.ndarray], return_numpy: bool = True):
        """One predictor dispatch.  ``return_numpy=False`` returns the
        outputs as tensors on the device without waiting for them, so a
        caller can overlap their copy to the host with its next batch
        (the serving worker does)."""
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        return self._exe.run(self._program, feed=feed, fetch_list=self._fetch_names,
                             scope=self._scope, return_numpy=return_numpy)

    Run = run  # C++-style alias

    def run_padded(self, feed: Dict[str, np.ndarray], n_valid: Optional[int] = None,
                   return_numpy: bool = True):
        """Run one batch padded up to a bucket size and slice every output
        whose leading dim is the padded batch back to its first
        ``n_valid`` rows (the serving layer's entry)."""
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        dims = {name: np.shape(v)[0] if np.ndim(v) else None for name, v in feed.items()}
        batch_dims = {d for d in dims.values() if d is not None}
        if len(batch_dims) != 1:
            raise ValueError("run_padded needs one consistent padded leading dim; got %s" % dims)
        (padded,) = batch_dims
        if n_valid is None:
            n_valid = padded
        if not 0 < n_valid <= padded:
            raise ValueError("n_valid=%r out of range for padded batch %d" % (n_valid, padded))
        outs = self.run(feed, return_numpy=return_numpy)
        if n_valid == padded:
            return outs
        return [o[:n_valid] if o.ndim >= 1 and o.shape[0] == padded else o for o in outs]

    def jit_cache_stats(self) -> Dict[str, object]:
        """The wrapped executor's cache accounting (``Executor.
        jit_cache_stats``): ``misses`` is the number of entries built,
        one for each bucket the server's warm-up runs.  A bucket's CUDA
        graph is captured at its entry's second run on one thread: the
        warm-up runs on the caller's thread, so a served bucket is
        captured at its second batch on the server's worker."""
        return self._exe.jit_cache_stats()

    def input_specs(self):
        """Per-row (batch-free) shape/dtype for every feed var:
        ``{name: (shape_tuple, np.dtype)}``.  Unknown (-1) non-batch
        dims come back as 1."""
        specs = {}
        block = self._program.global_block()
        for name in self._feed_names:
            var = block.var(name)
            shape = tuple(1 if int(d) < 0 else int(d) for d in (var.shape or ())[1:])
            specs[name] = (shape, core_types.np_dtype(var.dtype))
        return specs


def create_paddle_predictor(config: AnalysisConfig) -> AnalysisPredictor:
    """reference: CreatePaddlePredictor<AnalysisConfig>."""
    return AnalysisPredictor(config)

