"""Inference engine: config + predictor.

Port of the JAX package's ``inference.py`` (reference:
paddle/fluid/inference/api/ — AnalysisConfig, AnalysisPredictor,
CreatePaddlePredictor).  The predictor loads a saved inference model
into its own scope on its device and runs it through an Executor; the
weights stay resident on the device between runs.  On a card each feed
signature (each serving bucket) becomes a captured CUDA graph at its
second run on one thread.  A model saved with a precision policy
(``save_inference_model(precision_policy={"dtype": "bf16"})``) is
served in that dtype by default, with ``precision="fp32"`` as the
per-request opt-out: the bf16 variant is the same rewrite the export
gated, its hoisted parameters cast once onto the device, run through
the same executor (one cache, one ``jit_cache_stats``; each bucket and
dtype its own entry and CUDA graph).

A model saved with a sharding manifest (``save_inference_model(
sharding_rules=, sharding_mesh=)``) loads sharded: every rank of a world
of the manifest's size builds the predictor, each keeps its shard of each
parameter the rules shard (``param_placements``, ``sharding_stats``), and
each run gathers the shards and returns the whole answer on every rank
(``CompiledProgram``).  A bf16 endpoint composes: the variant's hoisted
parameters are cast once a shard, at placement.  An ``sp`` export
(``canonical_rules("transformer_lm", "sp")``) keeps every parameter whole
and each rank's window of the sequence axis: its attention runs as ring
attention over the ranks (``parallel/ring_attention.py``), and the fetches
are gathered whole on every rank.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import framework, io
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.types import PRECISION_ALIASES as _DTYPE_ALIASES
from paddle_tpu_torch.executor import Executor
from paddle_tpu_torch.monitor import registry as _mon_registry
from paddle_tpu_torch.monitor import spans as _mon_spans
from paddle_tpu_torch.scope import Scope

__all__ = ["AnalysisConfig", "PaddlePredictor", "AnalysisPredictor", "create_paddle_predictor"]

# padding waste is the serving bucket ladder's rent: rows computed and
# sliced away.  A waste ratio creeping toward 0.5 means the ladder is too
# coarse for the traffic's size mix.
_MON_PRED_RUNS = _mon_registry.REGISTRY.counter(
    "predictor_runs_total", "AnalysisPredictor.run calls")
_MON_PRED_PADDED_ROWS = _mon_registry.REGISTRY.counter(
    "predictor_padded_rows_total", "total rows in padded batches (valid + padding)")
_MON_PRED_WASTE_ROWS = _mon_registry.REGISTRY.counter(
    "predictor_padding_waste_rows_total",
    "padding rows computed then sliced away (padded - valid)")


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
        # a saved precision manifest rebuilds the same low-precision
        # variant here: requests default to the policy dtype, and
        # precision="fp32" opts a request back onto the base program
        self._precision: Optional[Dict[str, Any]] = None
        self._default_dtype = "fp32"
        self._variants: Dict[str, Any] = {}  # dtype -> (program, scope)
        self._variant_cast_params: Dict[str, List[str]] = {}  # dtype -> bf16 params
        self._compiled = None  # the sharded program (with_sharding_rules)
        self._variant_compiled: Dict[str, Any] = {}
        pmanifest = getattr(self._program, "_precision_manifest", None)
        smanifest = getattr(self._program, "_sharding_manifest", None)
        from paddle_tpu_torch.sharding.rules import PartitionRules, ShardingRuleError

        # the two blocks are cross-linked at export: one without the other is
        # a doctored manifest, never a silently degraded endpoint
        if pmanifest and pmanifest.get("sharded") and not smanifest:
            raise ShardingRuleError(
                "precision manifest in %r says the endpoint is sharded but the model "
                "carries no sharding block — re-export the endpoint" % (config.model_dir,))
        if smanifest and smanifest.get("precision_dtype") and not pmanifest:
            raise ShardingRuleError(
                "sharding manifest in %r names precision_dtype=%r but the model carries "
                "no precision block — the manifest was doctored or truncated; re-export "
                "the endpoint" % (config.model_dir, smanifest.get("precision_dtype")))
        if pmanifest:
            self._init_precision(pmanifest, config, composed=bool(smanifest))
        if smanifest:
            rules_doc = smanifest.get("rules")
            if not rules_doc:
                raise ShardingRuleError(
                    "malformed sharding manifest in %r: missing 'rules' (%r)"
                    % (config.model_dir, smanifest))
            self.with_sharding_rules(PartitionRules.from_manifest(rules_doc),
                                     mesh_axes=smanifest.get("mesh_axes"))

    # --- precision variants (contrib/mixed_precision) ---
    def _init_precision(self, manifest: Dict[str, Any], config: AnalysisConfig,
                        composed: bool = False) -> None:
        """Rebuild the endpoint's low-precision variant from its manifest:
        the deterministic bf16 rewrite of the loaded program, its hoisted
        parameters cast once to bf16 on this predictor's device (the
        variant scope).  Both programs run through the same executor, so
        its caches and ``jit_cache_stats`` cover every variant.  int8
        comes with ROADMAP A11.  ``composed`` (the model is also sharded):
        the hoisted parameters stay fp32 on the host and each rank's shard
        is cast as it is placed."""
        from paddle_tpu_torch.contrib.mixed_precision import inference as mp_inf

        dtype = mp_inf.normalize_dtype(manifest.get("dtype", ""))
        if dtype == "int8":
            raise mp_inf.PrecisionPolicyError(mp_inf.INT8_PENDING)
        if dtype != "bf16":
            raise mp_inf.PrecisionPolicyError(
                "unsupported precision manifest dtype %r in %r"
                % (manifest.get("dtype"), config.model_dir))
        variant, info = mp_inf.build_bf16_variant(
            self._program, self._fetch_names,
            custom_white_list=manifest.get("custom_white_list"),
            custom_black_list=manifest.get("custom_black_list"))
        vscope = mp_inf.variant_scope(variant, self._scope, set(info["cast_params"]),
                                      host_cast=composed)
        self._variant_cast_params[dtype] = list(info["cast_params"])
        self._precision = dict(manifest)
        self._default_dtype = dtype
        self._variants[dtype] = (variant, vscope)

    @property
    def precision_policy(self) -> Optional[Dict[str, Any]]:
        """The endpoint's saved precision policy (dtype, rtol, measured
        ``max_rel_err``), or None for a plain fp32 endpoint."""
        return dict(self._precision) if self._precision else None

    def precision_dtypes(self) -> List[str]:
        """The dtypes this predictor serves, default first: ``["bf16",
        "fp32"]`` for a bf16 endpoint (fp32 stays the per-request opt-out),
        ``["fp32"]`` without a policy.  The server's warmup runs every
        bucket for each of them."""
        if self._precision is None:
            return ["fp32"]
        return [self._default_dtype, "fp32"]

    def _select_variant(self, precision: Optional[str]):
        """(program, scope) of one dispatch: ``None`` the policy default,
        ``"fp32"`` the base program."""
        d = self._default_dtype if precision is None else (
            _DTYPE_ALIASES.get(str(precision).lower()))
        if d is None:
            raise ValueError("unknown precision %r (endpoint serves %s)"
                             % (precision, self.precision_dtypes()))
        if d == "fp32":
            return (self._compiled if self._compiled is not None else self._program), self._scope
        entry = self._variants.get(d)
        if entry is None:
            raise ValueError("endpoint has no %r variant (it serves %s)"
                             % (d, self.precision_dtypes()))
        compiled = self._variant_compiled.get(d)
        if compiled is not None:
            return compiled, entry[1]
        return entry

    # --- sharding (paddle_tpu_torch/sharding) ---
    def with_sharding_rules(self, rules, mesh=None, mesh_axes=None) -> "AnalysisPredictor":
        """Span this predictor across a model-parallel group of ranks: the
        loaded program runs as a ``CompiledProgram`` whose partition rules
        place each parameter shard-wise (every rank of the world builds
        its predictor the same way).  Called on load when the saved model
        carries a sharding manifest.  Each bf16 variant gets its own
        compiled program over the same mesh and rules, with its hoisted
        parameters cast as they are placed."""
        from paddle_tpu_torch.parallel.compiled_program import CompiledProgram

        self._compiled = CompiledProgram(self._program).with_sharding_rules(
            rules, mesh=mesh, mesh_axes=mesh_axes)
        self._variant_compiled = {}
        for d, (vprog, _vscope) in self._variants.items():
            cast_params = self._variant_cast_params.get(d)
            if cast_params is None:
                continue
            vc = CompiledProgram(vprog).with_sharding_rules(rules, mesh=self._compiled.mesh)
            vc.with_cast_dtypes({n: "bfloat16" for n in cast_params})
            self._variant_compiled[d] = vc
        return self

    @property
    def sharded(self) -> bool:
        """True when this predictor spans a model-parallel mesh."""
        return self._compiled is not None

    def param_placements(self, precision: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
        """Each persistable of the selected variant (None: the policy
        default) as this rank stores it: its resolved spec, global shape,
        this rank's shard shape, stored dtype, device and bytes.  Read
        after the first run (before it, a sharded predictor's parameters
        are host-staged whole, ``placed=False``)."""
        target, scope = self._select_variant(precision)
        compiled = target if getattr(target, "_is_compiled_program", False) else None
        program = getattr(target, "_program", target)
        out: Dict[str, Dict[str, Any]] = {}
        for v in program.list_vars():
            if not v.persistable or v.is_data:
                continue
            val = scope.get(v.name)
            if val is None:
                continue
            spec = compiled._spec_for_state(v.name) if compiled is not None else None
            shape = (tuple(int(d) for d in v.shape)
                     if v.shape is not None and -1 not in tuple(v.shape) else tuple(val.shape))
            shard_shape = tuple(val.shape)
            out[v.name] = {"spec": list(tuple(spec)) if spec is not None else None,
                           "shape": shape,
                           "dtype": core_types.canonical_dtype(val.dtype),
                           "device": str(val.device), "shard_shape": shard_shape,
                           "bytes_per_device": int(val.numel() * val.element_size()),
                           "sharded": shard_shape != shape,
                           "placed": val.device == self.device}
        return out

    def sharding_stats(self, group: Optional[str] = None,
                       precision: Optional[str] = None) -> Dict[str, Any]:
        """Placement accounting of this predictor's group: parameter
        counts, this rank's device bytes against the replicated baseline,
        both in the selected variant's stored dtype.  ``group=<label>``
        also publishes the rank's bytes to ``sharding_group_hbm_bytes``.  An
        ``sp`` export also reports ``activation_bytes_unsharded``,
        ``activation_bytes_per_device`` and ``n_activations_constrained``
        (and publishes the rank's bytes to ``sharding_activation_bytes``)."""
        placements = self.param_placements(precision)
        hbm = sum(p["bytes_per_device"] for p in placements.values())
        total = 0  # every param whole, per rank
        for p in placements.values():
            n_shard = int(np.prod(p["shard_shape"])) if p["shard_shape"] else 1
            itemsize = p["bytes_per_device"] // max(1, n_shard)
            total += (int(np.prod(p["shape"])) if p["shape"] else 1) * itemsize
        stats = {
            "sharded": self.sharded,
            "mesh_axes": (dict(self._compiled._mesh_axes)
                          if self._compiled is not None and self._compiled._mesh_axes
                          else None),
            "n_params": len(placements),
            "n_sharded": sum(1 for p in placements.values() if p["sharded"]),
            "hbm_bytes_per_device": int(hbm),
            "replicated_bytes": int(total),
        }
        # an activation-sharded (sp) layout also reports its intermediates'
        # footprint from the last run: all zero before a run, or after one
        # that constrained nothing
        act = self._compiled.activation_stats() if self._compiled is not None else None
        if act is not None:
            stats["activation_bytes_unsharded"] = act["activation_bytes_unsharded"]
            stats["activation_bytes_per_device"] = act["activation_bytes_per_device"]
            stats["n_activations_constrained"] = act["n_constrained"]
        if group is not None:
            from paddle_tpu_torch.sharding.metrics import ACTIVATION_BYTES, GROUP_HBM_BYTES

            GROUP_HBM_BYTES.labels(group=str(group)).set(float(hbm))
            if act is not None:
                ACTIVATION_BYTES.labels(group=str(group)).set(
                    float(act["activation_bytes_per_device"]))
        return stats

    # --- reference surface ---
    def get_input_names(self) -> List[str]:
        return list(self._feed_names)

    def get_output_names(self) -> List[str]:
        return list(self._fetch_names)

    def run(self, feed: Dict[str, np.ndarray] | Sequence[np.ndarray], return_numpy: bool = True,
            precision: Optional[str] = None):
        """One predictor dispatch.  ``return_numpy=False`` returns the
        outputs as tensors on the device without waiting for them, so a
        caller can overlap their copy to the host with its next batch
        (the serving worker does).  ``precision``: the variant that serves
        this call (None the policy default, ``"fp32"`` the opt-out)."""
        if not isinstance(feed, dict):
            feed = dict(zip(self._feed_names, feed))
        _MON_PRED_RUNS.inc()
        # hot-path: begin predictor_dispatch (the variant is one dict
        # lookup; every rewrite and cast happened at load)
        program, scope = self._select_variant(precision)
        return self._exe.run(program, feed=feed, fetch_list=self._fetch_names,
                             scope=scope, return_numpy=return_numpy)
        # hot-path: end predictor_dispatch

    Run = run  # C++-style alias

    def run_padded(self, feed: Dict[str, np.ndarray], n_valid: Optional[int] = None,
                   return_numpy: bool = True, precision: Optional[str] = None):
        """Run one batch padded up to a bucket size and slice every output
        whose leading dim is the padded batch back to its first
        ``n_valid`` rows (the serving layer's entry).  ``precision``
        selects the variant (see :meth:`run`); one padded batch is always
        one variant."""
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
        _MON_PRED_PADDED_ROWS.inc(padded)
        _MON_PRED_WASTE_ROWS.inc(padded - n_valid)
        # the predictor's hop in a request's span chain, between the
        # serving batch and the executor's phases (one flag check when
        # nothing records); its id parents the executor's spans
        rec = _mon_spans.recording()
        if rec:
            t0 = time.perf_counter()
            sid = _mon_spans.push_parent()
        err = False
        try:
            outs = self.run(feed, return_numpy=return_numpy, precision=precision)
        except BaseException:
            err = True
            raise
        finally:
            if rec:
                _mon_spans.pop_parent()
                _mon_spans.record_span("predictor/run_padded", t0, time.perf_counter() - t0,
                                       cat="predictor", span_id=sid, error=err,
                                       padded=int(padded), n_valid=int(n_valid))
        if n_valid == padded:
            return outs
        return [o[:n_valid] if o.ndim >= 1 and o.shape[0] == padded else o for o in outs]

    def jit_cache_stats(self) -> Dict[str, object]:
        """The wrapped executor's cache accounting (``Executor.
        jit_cache_stats``): ``misses`` is the number of entries built, one
        for each bucket and dtype the server's warm-up runs; ``graphs``
        the CUDA graphs captured, one for each of them on the card (the
        warm-up captures them)."""
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

