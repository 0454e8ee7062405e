"""Checkpoints and inference models, in the JAX package's on-disk format.

Port of the JAX package's ``io.py``'s save/load path (reference:
python/paddle/fluid/io.py save_vars:109, save_persistables:477,
load_vars:529, load_persistables:718, save_inference_model:925,
load_inference_model:1116).  A checkpoint directory holds one ``.npy``
per var and ``__manifest__.json`` (or one ``.npz`` when a params file
name is given); a model directory adds ``__model__`` (JSON: the pruned
program, feed and fetch names).  ``save_params`` keeps the parameters
only; ``save_persistables`` keeps every persistable var, so a training
run resumes from it: the optimizer's accumulators (momentum velocities,
Adam moments and beta pows), the learning rate and batch_norm's running
statistics are persistables, not parameters.  The format is the JAX
package's, so a directory written by either package loads in the other.
``save_program`` writes the whole train program (backward and optimizer
ops, nothing pruned) with every persistable, and
``load_inference_model`` loads such a directory into a program that
trains on from the saved state.  ``PyReader`` and ``DataLoader`` are
``reader.py``'s, as in ``fluid.io``.  ``save_inference_model(
precision_policy={"dtype": "bf16"})`` builds the bf16 serving variant,
gates it on its parity with fp32 and writes the policy into
``__model__``; ``load_inference_model`` hands that manifest to the
predictor (``program._precision_manifest``).  An int8 policy (ROADMAP
A11) is refused rather than served without it.

``save_inference_model(sharding_rules=, sharding_mesh=)`` validates a
partition-rule set against the pruned program (every persistable covered,
each spec's rank, each sharded dim divisible by its axes; each a typed
``ShardingRuleError``) and writes it into ``__model__`` beside the mesh
shape, key for key the JAX package's manifest; ``load_inference_model``
hands it to the predictor (``program._sharding_manifest``), which then
spans a group of ranks, and stages the parameters on the host so a rank
moves only its shard to its card.  Saving from a scope that a compiled
run left as this rank's shards gathers each whole (every rank calls the
save; rank 0 writes).
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.framework import Parameter, Program, Variable
from paddle_tpu_torch.reader import DataLoader, PyReader
from paddle_tpu_torch.scope import Scope, global_scope, to_numpy

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "save_program",
    "load_inference_model",
    "PyReader",
    "DataLoader",
    "set_params_from_numpy",
]

_MANIFEST = "__manifest__.json"
_MODEL_FILE = "__model__"


def _is_persistable(var: Variable) -> bool:
    return bool(var.persistable) and not var.is_data


def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _collect(program: Program, predicate: Callable[[Variable], bool], vars=None) -> List[Variable]:
    if vars is not None:
        return [v if isinstance(v, Variable) else program.global_block().var(v) for v in vars]
    seen, out = set(), []
    for v in program.list_vars():
        if v.name not in seen and predicate(v):
            seen.add(v.name)
            out.append(v)
    return out


def _var_path(dirname: str, name: str) -> str:
    # var names may contain '/' from name_scope prefixes
    return os.path.join(dirname, name.replace("/", "%2F") + ".npy")


def set_params_from_numpy(scope: Scope, arrays: Dict[str, np.ndarray],
                          device, program: Optional[Program] = None) -> None:
    """Put host arrays into ``scope`` by name, on ``device``.

    This is how state crosses from the JAX package (its scope's values,
    as numpy arrays) into the port, and how ``load_inference_model``
    fills a predictor's scope.  It carries every persistable by name:
    parameters, and for training the optimizer's moments, beta pows and
    learning rate.  With ``program`` given, each array's shape is
    checked against the program's var of that name; a one-element var
    takes any one-element array (a training program declares the Adam
    beta pows [1] in startup and, after its update op, [] in main)."""
    scope.bind_device(torch.device(device))
    block = program.global_block() if program is not None else None
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        var = block._find_var_recursive(name) if block is not None else None
        if var is not None and var.shape is not None and -1 not in var.shape:
            one_element = arr.size == 1 and int(np.prod(var.shape)) == 1
            if tuple(arr.shape) != tuple(var.shape) and not one_element:
                raise ValueError(
                    "shape mismatch loading %r: array %s vs program %s"
                    % (name, arr.shape, tuple(var.shape)))
        scope.set(name, arr)


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None, filename=None,
              scope=None):
    """reference: io.py:109 — ``vars``, or the program's vars that
    ``predicate`` accepts (default: the persistables), from ``scope``
    (default: the current global scope).  ``filename`` packs everything
    into one .npz."""
    program = main_program or framework.default_main_program()
    scope = scope if scope is not None else global_scope()
    os.makedirs(dirname, exist_ok=True)
    manifest = {"format_version": 1, "vars": []}
    arrays = {}
    writer = _writer(scope)
    for v in _collect(program, predicate or _is_persistable, vars):
        val = _whole_value(scope, v.name)
        if val is None:
            raise RuntimeError("variable %r has no value in scope; run startup first" % v.name)
        if not writer:
            continue
        arr = to_numpy(val)
        arrays[v.name] = arr
        manifest["vars"].append({
            "name": v.name,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "is_parameter": isinstance(v, Parameter),
        })
    if not writer:
        return
    if filename is not None:
        np.savez(os.path.join(dirname, filename), **arrays)
        manifest["packed_file"] = filename
    else:
        for name, arr in arrays.items():
            np.save(_var_path(dirname, name), arr)
    with open(os.path.join(dirname, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def _committed(scope: Scope) -> Dict[str, tuple]:
    """The scope's names that hold this rank's shard, placed by a compiled
    run: ``{name: (compiled program, shard)}`` (the shard still in place)."""
    committed = scope.__dict__.get("_mesh_committed") or {}
    return {n: c for n, c in committed.items() if scope.vars.get(n) is c[1]}


def _whole_value(scope: Scope, name: str):
    """The var's whole value: a committed shard is gathered (a collective:
    every rank of the mesh calls it)."""
    val = scope.get(name)
    c = scope.__dict__.get("_mesh_committed", {}).get(name)
    if c is not None and val is c[1]:
        return c[0].gather_state(name, val)
    return val


def _writer(scope: Scope) -> bool:
    """Whether this process writes a save: all but rank 0 of a mesh skip
    the files of a save that gathers shards."""
    if not _committed(scope):
        return True
    from paddle_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.world()[0] == 0


def _read_arrays(dirname: str) -> Dict[str, np.ndarray]:
    with open(os.path.join(dirname, _MANIFEST)) as f:
        manifest = json.load(f)
    packed = manifest.get("packed_file")
    if packed:
        if not packed.endswith(".npz"):
            packed += ".npz"
        with np.load(os.path.join(dirname, packed)) as z:
            return {e["name"]: z[e["name"]] for e in manifest["vars"]}
    return {e["name"]: np.load(_var_path(dirname, e["name"])) for e in manifest["vars"]}


def save_params(executor, dirname, main_program=None, filename=None, scope=None):
    return save_vars(executor, dirname, main_program, predicate=_is_parameter,
                     filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None, scope=None):
    """reference: io.py:477 — parameters, optimizer state, learning rate
    and running statistics."""
    return save_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename, scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None, filename=None,
              scope=None):
    """reference: io.py:529 — the directory's vars into ``scope``
    (default: the current global scope), on the executor's device: every
    var of its manifest, or with ``vars`` or ``predicate`` those of the
    program's vars it holds.  The manifest names a packed file itself, so
    ``filename`` is not needed to read one."""
    program = main_program or framework.default_main_program()
    scope = scope if scope is not None else global_scope()
    arrays = _read_arrays(dirname)
    if vars is not None or predicate is not None:
        wanted = {v.name for v in _collect(program, predicate or _is_persistable, vars)}
        arrays = {n: a for n, a in arrays.items() if n in wanted}
    set_params_from_numpy(scope, arrays, executor.device, program)


def load_params(executor, dirname, main_program=None, filename=None, scope=None):
    return load_vars(executor, dirname, main_program, predicate=_is_parameter,
                     filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None, scope=None):
    return load_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename, scope=scope)


def _prune_program(program: Program, feed_names: Sequence[str], fetch_names: Sequence[str]) -> Program:
    """Backward slice of block-0 ops from the fetch targets (the
    reference's Prune, framework/prune.cc)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        if any(n in needed for n in op.output_arg_names):
            kept.append(op)
            needed.update(op.input_arg_names)
    kept.reverse()
    block.ops = kept
    used = set(feed_names) | set(fetch_names)
    for op in kept:
        used.update(op.input_arg_names)
        used.update(op.output_arg_names)
    block.vars = {n: v for n, v in block.vars.items() if n in used}
    return pruned


def _save_model(dirname, program, feed_names, fetch_names, executor, model_filename,
                params_filename, scope, precision=None, sharding=None):
    """Write ``program`` as ``__model__`` JSON with its feed and fetch
    names (and ``precision``, the precision-policy manifest a
    mixed-precision endpoint carries), and its persistable values beside
    it."""
    os.makedirs(dirname, exist_ok=True)
    model = {
        "format_version": 1,
        "program": json.loads(program.to_json()),
        "feed_names": list(feed_names),
        "fetch_names": list(fetch_names),
    }
    if sharding is not None:
        model["sharding"] = sharding
    if precision is not None:
        model["precision"] = precision
    if _writer(scope if scope is not None else global_scope()):
        with open(os.path.join(dirname, model_filename or _MODEL_FILE), "w") as f:
            json.dump(model, f)
    save_vars(executor, dirname, program, predicate=_is_persistable,
              filename=params_filename, scope=scope)
    return list(fetch_names)


def _export_precision_variant(dirname, pruned, feed_names, fetch_names, executor, policy,
                              scope=None):
    """Build and parity-gate a low-precision variant of ``pruned`` and
    return its manifest block (the ``precision`` entry of ``__model__``).

    ``policy``: ``{"dtype": "bf16", "rtol": float?,
    "custom_white_list"/"custom_black_list": [...]?, "parity_feeds":
    [feed dicts]?}``.  The gate runs the variant against the fp32 program
    on the parity feeds, eagerly on the executor's device, and refuses
    the export (``PrecisionParityError``) when the worst relative error
    exceeds the rtol; the measured value rides the manifest.  bf16 needs
    no extra weights on disk: the loader rebuilds the rewrite and casts
    the parameters as it places them.  ``"int8"`` (with its
    ``calibration`` key) rides ``contrib/quantize``, which comes with
    ROADMAP A11."""
    from paddle_tpu_torch.contrib.mixed_precision import inference as mp_inf

    scope = scope if scope is not None else global_scope()
    policy = dict(policy)
    dtype = mp_inf.normalize_dtype(policy.pop("dtype", None) or "")
    if dtype == "fp32":
        raise mp_inf.PrecisionPolicyError(
            "precision_policy dtype 'fp32' is the base model: pass no policy instead")
    rtol = float(policy.pop("rtol", mp_inf.DEFAULT_RTOL[dtype]))
    parity_feeds = policy.pop("parity_feeds", None) or (
        mp_inf.synthetic_parity_feeds(pruned, feed_names))
    # every known key pops before dispatching on dtype, so an unknown key
    # is refused for both dtypes, and a known key the dtype cannot honour
    # is refused rather than dropped
    wl = policy.pop("custom_white_list", None)
    bl = policy.pop("custom_black_list", None)
    calibration = policy.pop("calibration", None)
    if policy:
        raise mp_inf.PrecisionPolicyError("unknown precision_policy keys %s" % sorted(policy))
    if dtype == "int8":
        raise mp_inf.PrecisionPolicyError(mp_inf.INT8_PENDING)
    if calibration:
        raise mp_inf.PrecisionPolicyError(
            "'calibration' is an int8-only policy key: the bf16 rewrite needs no "
            "calibration data (drop the key)")
    manifest = {"dtype": dtype, "rtol": rtol}
    variant, info = mp_inf.build_bf16_variant(pruned, fetch_names, custom_white_list=wl,
                                              custom_black_list=bl)
    vscope = mp_inf.variant_scope(variant, scope, set(info["cast_params"]))
    if wl:
        manifest["custom_white_list"] = sorted(wl)
    if bl:
        manifest["custom_black_list"] = sorted(bl)
    manifest["cast_params"] = len(info["cast_params"])
    # the parity gate: fp32 against the variant on every parity feed
    worst = 0.0
    for feed in parity_feeds:
        ref = executor.run(pruned, feed=feed, fetch_list=list(fetch_names), scope=scope,
                           use_program_cache=False)
        outs = executor.run(variant, feed=feed, fetch_list=list(fetch_names), scope=vscope,
                            use_program_cache=False)
        worst = max(worst, mp_inf.max_rel_err(ref, outs))
    if worst > rtol:
        raise mp_inf.PrecisionParityError(
            "%s variant disagrees with fp32 beyond the policy bound: max_rel_err=%.4g > "
            "rtol=%.4g; loosen the policy rtol or blacklist the offending ops"
            % (dtype, worst, rtol))
    manifest["max_rel_err"] = float(worst)
    return manifest


def save_inference_model(dirname, feeded_var_names: Sequence[str], target_vars: Sequence,
                         executor, main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None, sharding_rules=None,
                         sharding_mesh=None, precision_policy=None, scope=None):
    """reference: io.py:925 — prune to the fetch targets, then save the
    program and its persistable values.

    ``precision_policy`` (``{"dtype": "bf16", "rtol": float, ...}``, see
    ``_export_precision_variant``): the endpoint's low-precision serving
    policy, written into the manifest once its variant passes the parity
    gate here, so every loader serves the same variant.
    ``sharding_rules`` (a ``paddle_tpu_torch.sharding.PartitionRules``,
    a ``TrainPartitionRules``, which unwraps to its serving rules, or a
    ``(regex, spec)`` list) is embedded in the ``__model__`` manifest with
    ``sharding_mesh`` (axis→size, e.g. ``{"tp": 2}``) so every loader
    reconstructs the same model-parallel layout.  The rules are validated
    against the pruned program's persistables HERE (coverage, rank and,
    with the mesh, divisibility), so a bad layout fails at export."""
    program = main_program or framework.default_main_program()
    fetch_names = [t.name if isinstance(t, Variable) else str(t) for t in target_vars]
    pruned = _prune_program(program, feeded_var_names, fetch_names)
    if precision_policy is not None and sharding_rules is not None:
        from paddle_tpu_torch.contrib.mixed_precision.inference import (
            PrecisionPolicyError,
            normalize_dtype,
        )

        # bf16 composes: hoisting keeps param names and shapes, so the rules
        # cover the variant's params verbatim and the loader casts each
        # shard as it places it; int8's frozen sub-model has its own params
        if normalize_dtype(precision_policy.get("dtype") or "") != "bf16":
            raise PrecisionPolicyError(
                "precision_policy dtype %r is not composable with "
                "sharding_rules on one endpoint — only the bf16 variant "
                "shares the base program's param set (hoisted casts); "
                "export the int8 model unsharded or drop one"
                % precision_policy.get("dtype"))
    precision = None
    if precision_policy is not None:
        precision = _export_precision_variant(dirname, pruned, list(feeded_var_names),
                                              fetch_names, executor, precision_policy, scope)
    sharding = None
    if sharding_rules is not None:
        sharding = _sharding_manifest(pruned, sharding_rules, sharding_mesh)
    if precision is not None and sharding is not None:
        # cross-link the two blocks, so a manifest that lost one is a typed
        # load error, not a silently degraded endpoint
        precision["sharded"] = True
        sharding["precision_dtype"] = precision["dtype"]
    return _save_model(dirname, pruned, feeded_var_names, fetch_names, executor,
                       model_filename, params_filename, scope, precision=precision,
                       sharding=sharding)


def _sharding_manifest(pruned: Program, sharding_rules, sharding_mesh) -> Dict:
    """The ``sharding`` block of ``__model__``, after the JAX package's
    fail-at-export checks: the mesh carries every axis the rules shard
    over, every persistable resolves, and every sharded dim divides."""
    from paddle_tpu_torch.sharding.rules import PartitionRules, ShardingRuleError

    if not isinstance(sharding_rules, PartitionRules):
        sharding_rules = PartitionRules(sharding_rules)
    # a training layout unwraps to its base serving rules: the pruned
    # inference program has no optimizer accumulators
    sharding_rules = getattr(sharding_rules, "serving_rules", sharding_rules)
    shapes = {v.name: tuple(v.shape or ()) for v in pruned.list_vars() if _is_persistable(v)}
    axes = sharding_rules.axes()
    if sharding_mesh is not None:
        mesh_axes = dict(sharding_mesh)
        missing = sorted(axes - set(mesh_axes))
        if missing:
            raise ShardingRuleError(
                "sharding_rules shard over axes %s which are not in "
                "sharding_mesh %s" % (missing, mesh_axes))
        sharding_rules.validate_shapes(shapes, mesh_axes)  # coverage + rank + divisibility
    else:
        if len(axes) > 1:
            raise ShardingRuleError(
                "sharding_rules span axes %s — pass sharding_mesh= "
                "to fix their sizes (a loader cannot infer a "
                "multi-axis mesh shape)" % sorted(axes))
        sharding_rules.match(shapes)  # coverage + rank
    return {
        "mesh_axes": ({str(a): int(n) for a, n in dict(sharding_mesh).items()}
                      if sharding_mesh else None),
        "rules": sharding_rules.to_manifest(),
    }


def save_program(dirname, feeded_var_names: Sequence[str], target_vars: Sequence, executor,
                 main_program: Optional[Program] = None, model_filename=None,
                 params_filename=None, scope=None):
    """The JAX package's ``io.save_program``: the FULL program, backward
    and optimizer ops included, and its persistable state (parameters,
    learning rate, accumulators) in ``save_inference_model``'s format.
    Nothing is pruned, so a program loaded from the directory trains on
    from the saved state."""
    program = main_program or framework.default_main_program()
    fetch_names = [t.name if isinstance(t, Variable) else str(t) for t in target_vars]
    return _save_model(dirname, program, feeded_var_names, fetch_names, executor,
                       model_filename, params_filename, scope)


def load_inference_model(dirname, executor, model_filename=None, params_filename=None, scope=None):
    """reference: io.py:1116 — returns (program, feed_names, fetch_vars),
    with the parameters in ``scope`` (default: the current global scope)
    on the executor's device.  A precision-policy manifest rides back on
    the program as ``program._precision_manifest`` (``AnalysisPredictor``
    builds the variant from it); an int8 one raises naming ROADMAP A11.
    A sharding manifest rides back as ``program._sharding_manifest``, and
    the parameters of such a model stay on the host (CPU tensors in the
    scope) until a compiled program places each rank's shard."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILE)) as f:
        model = json.load(f)
    precision = model.get("precision")
    if precision:
        from paddle_tpu_torch.contrib.mixed_precision import inference as mp_inf

        if mp_inf.normalize_dtype(precision.get("dtype", "")) == "int8":
            raise mp_inf.PrecisionPolicyError(
                "model in %r carries an int8 precision manifest: %s"
                % (dirname, mp_inf.INT8_PENDING))
    program = Program.from_json(json.dumps(model["program"]))
    if precision:
        program._precision_manifest = precision
    if model.get("sharding"):
        program._sharding_manifest = model["sharding"]
        scope = scope if scope is not None else global_scope()
        scope.bind_device(executor.device)
        for name, arr in _read_arrays(dirname).items():
            scope.vars[name] = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    else:
        load_vars(executor, dirname, program, scope=scope)
    fetch_vars = [program.global_block().var(n) for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_vars
