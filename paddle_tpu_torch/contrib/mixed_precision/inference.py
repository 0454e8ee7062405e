"""Inference-side mixed precision: low-precision predictor variants.

The port of the JAX package's ``contrib/mixed_precision/inference.py``.
The training-side rewrite (``decorator.rewrite_program``) points the
white/black/gray lists at train programs; this module points the same
rewrite at the serving path.  A pruned inference program becomes a bf16
variant in three passes, each a Program rewrite that gives the JAX
package's program desc, op for op:

1. ``rewrite_program``: the white/gray/black cast insertion (white ops
   run bf16, gray chains follow their inputs so activation traffic stays
   bf16 end to end, black ops get fp32 cast-ups);
2. ``hoist_param_casts``: every inserted fp32->bf16 cast whose source is
   a persistable parameter is deleted and the parameter itself becomes
   bf16.  The variant scope holds a bf16 copy of it on the predictor's
   device, cast once at load (``variant_scope``), so a serving step
   reads half the weight bytes and casts no weight;
3. ``cast_fetches_fp32``: fetch targets keep their fp32 dtype and names
   (one cast op per bf16 fetch), so clients and the parity gate never
   see bf16 leave the predictor.

``max_rel_err`` is the parity gate's metric: exporting a precision
policy runs the variant against the fp32 program on parity feeds and
refuses (``PrecisionParityError``) when the measured error exceeds the
policy's rtol; the measured value rides the manifest as the endpoint's
accuracy bound.

The int8 variant rides ``contrib/quantize`` in the JAX package, which
the port does not have yet: an int8 policy raises naming ROADMAP A11.
The sharded composition (``variant_scope(host_cast=True)``) shares the
host-staged fp32 parameters and leaves the cast to the placement: the
compiled program casts each rank's shard once as it moves it to the card
(``CompiledProgram.with_cast_dtypes``).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np
import torch

from paddle_tpu_torch.contrib.mixed_precision.decorator import (
    AutoMixedPrecisionLists,
    rewrite_program,
)
from paddle_tpu_torch.core.types import PRECISION_ALIASES as _DTYPE_ALIASES

__all__ = [
    "PrecisionPolicyError",
    "PrecisionParityError",
    "DEFAULT_RTOL",
    "normalize_dtype",
    "build_bf16_variant",
    "hoist_param_casts",
    "cast_fetches_fp32",
    "cast_counts",
    "variant_scope",
    "max_rel_err",
    "synthetic_parity_feeds",
]


class PrecisionPolicyError(ValueError):
    """A malformed or unsupported precision policy (bad dtype, unknown
    key, a dtype the port does not serve yet)."""


class PrecisionParityError(PrecisionPolicyError):
    """The low-precision variant disagreed with fp32 beyond the
    policy's rtol at export: the parity gate refuses to ship it."""


#: default parity bounds per variant dtype (relative error on the fetch
#: outputs; bf16 carries 2 to 3 significant digits, eps ~8e-3, so a few
#: percent of accumulated error is the honest expectation)
DEFAULT_RTOL = {"bf16": 5e-2, "int8": 0.35}

INT8_PENDING = ("the int8 precision variant rides contrib/quantize, which the port "
                "does not have yet (ROADMAP A11)")


def normalize_dtype(dtype: str) -> str:
    d = _DTYPE_ALIASES.get(str(dtype).lower())
    if d is None:
        raise PrecisionPolicyError(
            "unsupported precision dtype %r (supported: %s)"
            % (dtype, sorted(set(_DTYPE_ALIASES.values()))))
    return d


# ---------------------------------------------------------------------------
# bf16 variant passes
# ---------------------------------------------------------------------------
def hoist_param_casts(program) -> Set[str]:
    """Delete every fp32->bf16 cast of a persistable parameter and make
    the parameter itself bf16; returns the names made bf16.

    Only parameters whose every use goes through such a cast are hoisted:
    a parameter that also feeds an op expecting fp32 keeps its per-run
    cast, so hoisting never changes the numerics, only where the cast
    happens (at load, not at every dispatch)."""
    block = program.global_block()
    uses: Counter = Counter()
    for op in block.ops:
        for names in op.inputs.values():
            uses.update(names)
    casts = []  # (op, src, out)
    for op in block.ops:
        if op.type != "cast" or op.attrs.get("out_dtype") != "bfloat16":
            continue
        src = op.inputs["X"][0]
        v = block._find_var_recursive(src)
        if v is None or not v.persistable or v.is_data or v.dtype != "float32":
            continue
        casts.append((op, src, op.outputs["Out"][0]))
    cast_uses = Counter(src for _, src, _ in casts)
    eligible = {src for src, n in cast_uses.items() if n == uses[src]}
    if not eligible:
        return set()
    rename: Dict[str, str] = {}
    drop = set()
    for op, src, out in casts:
        if src in eligible:
            rename[out] = src
            drop.add(id(op))
    block.ops = [op for op in block.ops if id(op) not in drop]
    for op in block.ops:
        for slot, names in op.inputs.items():
            op.inputs[slot] = [rename.get(n, n) for n in names]
    for out in rename:
        block.vars.pop(out, None)
    for src in eligible:
        block._find_var_recursive(src).dtype = "bfloat16"
    program.version += 1
    return eligible


def cast_fetches_fp32(program, fetch_names: Sequence[str]) -> int:
    """Pin every fetch target back to fp32 (same name, one appended cast
    op per bf16 fetch); returns the number of casts added."""
    block = program.global_block()
    n = 0
    for name in fetch_names:
        v = block._find_var_recursive(name)
        if v is None or v.dtype != "bfloat16":
            continue
        raw = name + ".bf16_raw"
        block.create_var(name=raw, shape=v.shape, dtype="bfloat16",
                         stop_gradient=v.stop_gradient)
        for op in block.ops:
            for slot, names in op.outputs.items():
                op.outputs[slot] = [raw if x == name else x for x in names]
            for slot, names in op.inputs.items():
                op.inputs[slot] = [raw if x == name else x for x in names]
        v.dtype = "float32"
        block.append_op(
            type="cast",
            inputs={"X": [raw]},
            outputs={"Out": [name]},
            attrs={"in_dtype": "bfloat16", "out_dtype": "float32", "op_role": "forward"},
        )
        n += 1
    if n:
        program.version += 1
    return n


def cast_counts(program) -> Dict[str, int]:
    """Cast-op census of a rewritten program: ``to_low`` (fp32->bf16)
    and ``to_fp32`` (bf16->fp32 bounce and fetch casts)."""
    out = {"to_low": 0, "to_fp32": 0}
    for op in program.global_block().ops:
        if op.type != "cast":
            continue
        if op.attrs.get("out_dtype") in ("bfloat16", "float16"):
            out["to_low"] += 1
        else:
            out["to_fp32"] += 1
    return out


def build_bf16_variant(program, fetch_names: Sequence[str], custom_white_list=None,
                       custom_black_list=None) -> Tuple[object, Dict[str, object]]:
    """Clone ``program`` (a pruned inference program) into its bf16
    variant: rewrite, hoist the param casts, pin the fetches to fp32.
    Returns ``(variant_program, info)``; ``info['cast_params']`` names the
    parameters the variant stores as bf16."""
    variant = program.clone()
    lists = AutoMixedPrecisionLists(custom_white_list, custom_black_list)
    rewrite_program(variant, lists)
    cast_params = hoist_param_casts(variant)
    n_fetch_casts = cast_fetches_fp32(variant, fetch_names)
    info = {
        "cast_params": sorted(cast_params),
        "fetch_casts": n_fetch_casts,
        "cast_ops": cast_counts(variant),
    }
    return variant, info


def variant_scope(program, base_scope, cast_params: Set[str], host_cast: bool = False):
    """A scope for the variant program on the base scope's device: the
    hoisted parameters cast to bf16 once, there; every other value shared
    with the base scope (an inference program writes no persistable).

    ``host_cast=True`` (the sharded composition): every value is shared
    as it is, the hoisted parameters too; the variant's compiled program
    casts each rank's shard as it places it (``with_cast_dtypes``), so no
    full-width copy is cast on the card."""
    from paddle_tpu_torch.scope import Scope

    sc = Scope(device=base_scope.device)
    if host_cast:
        for v in program.list_vars():
            if v.persistable and not v.is_data and base_scope.get(v.name) is not None:
                sc.vars[v.name] = base_scope.get(v.name)
        return sc
    for v in program.list_vars():
        if not v.persistable or v.is_data:
            continue
        val = base_scope.get(v.name)
        if val is None:
            continue
        if v.name in cast_params:
            val = val.to(torch.bfloat16)
        sc.set(v.name, val)
    return sc


# ---------------------------------------------------------------------------
# parity gate helpers
# ---------------------------------------------------------------------------
def max_rel_err(ref_outs: Sequence, outs: Sequence) -> float:
    """Worst scale-relative error across fetch outputs: per array,
    ``max|a - b| / max(max|a|, 1e-6)`` in float64.  Relative to the
    array's magnitude, not per element: raw logits cross zero, and a
    per-element denominator would report an infinite error on an element
    that rounds through it."""
    worst = 0.0
    for a, b in zip(ref_outs, outs):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        if a.shape != b.shape:
            raise PrecisionParityError(
                "variant output shape %s != fp32 output shape %s" % (b.shape, a.shape))
        if not a.size:
            continue
        scale = max(float(np.max(np.abs(a))), 1e-6)
        worst = max(worst, float(np.max(np.abs(a - b))) / scale)
    return worst


def synthetic_parity_feeds(program, feed_names: Sequence[str], batch: int = 4,
                           n_feeds: int = 2, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """Deterministic parity feeds from the program's data vars: floats
    uniform in [-1, 1), integer feeds zeros (always in range for id and
    embedding inputs)."""
    from paddle_tpu_torch.core import types as core_types

    block = program.global_block()
    rng = np.random.RandomState(seed)
    feeds = []
    for _ in range(max(1, n_feeds)):
        feed = {}
        for name in feed_names:
            var = block.var(name)
            shape = (batch,) + tuple(1 if int(d) < 0 else int(d) for d in (var.shape or ())[1:])
            dt = core_types.np_dtype(var.dtype)
            if np.issubdtype(dt, np.floating):
                feed[name] = rng.uniform(-1, 1, shape).astype(dt)
            else:
                feed[name] = np.zeros(shape, dt)
        feeds.append(feed)
    return feeds
