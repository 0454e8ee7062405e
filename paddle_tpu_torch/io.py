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
``reader.py``'s, as in ``fluid.io``.  Precision and
sharding manifests come with later slices of the port; a model that
carries one is refused here rather than served without it.
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
    for v in _collect(program, predicate or _is_persistable, vars):
        val = scope.get(v.name)
        if val is None:
            raise RuntimeError("variable %r has no value in scope; run startup first" % v.name)
        arr = to_numpy(val)
        arrays[v.name] = arr
        manifest["vars"].append({
            "name": v.name,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "is_parameter": isinstance(v, Parameter),
        })
    if filename is not None:
        np.savez(os.path.join(dirname, filename), **arrays)
        manifest["packed_file"] = filename
    else:
        for name, arr in arrays.items():
            np.save(_var_path(dirname, name), arr)
    with open(os.path.join(dirname, _MANIFEST), "w") as f:
        json.dump(manifest, f)


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
                params_filename, scope):
    """Write ``program`` as ``__model__`` JSON with its feed and fetch
    names, and its persistable values beside it."""
    os.makedirs(dirname, exist_ok=True)
    model = {
        "format_version": 1,
        "program": json.loads(program.to_json()),
        "feed_names": list(feed_names),
        "fetch_names": list(fetch_names),
    }
    with open(os.path.join(dirname, model_filename or _MODEL_FILE), "w") as f:
        json.dump(model, f)
    save_vars(executor, dirname, program, predicate=_is_persistable,
              filename=params_filename, scope=scope)
    return list(fetch_names)


def save_inference_model(dirname, feeded_var_names: Sequence[str], target_vars: Sequence,
                         executor, main_program: Optional[Program] = None,
                         model_filename=None, params_filename=None, scope=None):
    """reference: io.py:925 — prune to the fetch targets, then save the
    program and its persistable values."""
    program = main_program or framework.default_main_program()
    fetch_names = [t.name if isinstance(t, Variable) else str(t) for t in target_vars]
    pruned = _prune_program(program, feeded_var_names, fetch_names)
    return _save_model(dirname, pruned, feeded_var_names, fetch_names, executor,
                       model_filename, params_filename, scope)


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
    on the executor's device."""
    with open(os.path.join(dirname, model_filename or _MODEL_FILE)) as f:
        model = json.load(f)
    for key in ("sharding", "precision"):
        if model.get(key):
            raise NotImplementedError(
                "model in %r carries a %s manifest, which paddle_tpu_torch "
                "does not serve yet" % (dirname, key))
    program = Program.from_json(json.dumps(model["program"]))
    load_vars(executor, dirname, program, scope=scope)
    fetch_vars = [program.global_block().var(n) for n in model["fetch_names"]]
    return program, model["feed_names"], fetch_vars
