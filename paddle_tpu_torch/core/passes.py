"""Program pass framework (reference: paddle/fluid/framework/ir/pass.h:38
PassRegistry + ir/graph_pattern_detector.h).

A copy of the JAX package's ``core/passes.py``: program-level rewrites
share one registry, one ``apply_pass`` entry point, and a pattern
matcher for op-chain rewrites.  The port's rewriters (AMP bf16,
feed/fetch pruning) are registered below so tools can discover and
compose them like the reference's pass pipeline.  The JAX package's
``qat_quantize`` pass waits for the port of ``contrib/slim``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

__all__ = [
    "ProgramPass", "register_pass", "get_pass", "apply_pass", "list_passes",
    "PassManager", "match_chain",
]

_PASS_REGISTRY: Dict[str, "ProgramPass"] = {}


class ProgramPass:
    """A named program rewrite: ``apply(program, **kwargs) -> program``
    (in-place mutation, program returned for chaining)."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self._fn = fn

    def apply(self, program, **kwargs):
        out = self._fn(program, **kwargs)
        if out is None or out is program:
            # in-place rewrite: invalidate compiled-executable caches.
            # Passes returning a NEW program (e.g. a pruned clone) leave
            # the original untouched — no spurious recompiles.
            program.version += 1
            return program
        return out


def register_pass(name: str):
    """Decorator: ``@register_pass("amp_bf16")`` over
    ``fn(program, **kwargs)`` (REGISTER_PASS analog)."""

    def deco(fn):
        _PASS_REGISTRY[name] = ProgramPass(name, fn)
        return fn

    return deco


def get_pass(name: str) -> ProgramPass:
    if name not in _PASS_REGISTRY:
        raise KeyError(
            "pass %r is not registered (have: %s)" % (name, sorted(_PASS_REGISTRY))
        )
    return _PASS_REGISTRY[name]


def list_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


def apply_pass(name: str, program, **kwargs):
    return get_pass(name).apply(program, **kwargs)


class PassManager:
    """Ordered pipeline of passes (BuildStrategy pass-pipeline analog,
    details/build_strategy.cc:52-186)."""

    def __init__(self, names: Sequence[str] = ()):
        self._names = list(names)

    def add(self, name: str):
        get_pass(name)  # validate eagerly
        self._names.append(name)
        return self

    def apply(self, program, **kwargs):
        for n in self._names:
            apply_pass(n, program, **kwargs.get(n, {}) if isinstance(kwargs.get(n), dict) else {})
        return program


# ---------------------------------------------------------------------------
# pattern matcher (GraphPatternDetector-lite): find op chains linked
# through their tensors
# ---------------------------------------------------------------------------
def match_chain(block, op_types: Sequence[str], link_slots: Optional[Sequence[tuple]] = None):
    """Find occurrences of ``op_types`` where each op's output feeds the
    next op's input.  ``link_slots``: optional [(out_slot, in_slot), ...]
    per link; defaults to any-output -> any-input.  Returns a list of op
    lists (one per match)."""
    def feeds(prev, nxt, link):
        if link is None:
            outs = set(prev.output_arg_names)
            ins = set(nxt.input_arg_names)
            return bool(outs & ins)
        out_slot, in_slot = link
        outs = set(prev.outputs.get(out_slot, ()))
        ins = set(nxt.inputs.get(in_slot, ()))
        return bool(outs & ins)

    def extend(chain, depth):
        """Backtracking search: a mid-chain op may have several
        consumers of the right type — try each."""
        if depth == len(op_types):
            return chain
        link = link_slots[depth - 1] if link_slots else None
        for cand in block.ops:
            if cand.type != op_types[depth] or cand in chain:
                continue
            if feeds(chain[-1], cand, link):
                full = extend(chain + [cand], depth + 1)
                if full is not None:
                    return full
        return None

    matches = []
    for op in block.ops:
        if op.type != op_types[0]:
            continue
        full = extend([op], 1)
        if full is not None:
            matches.append(full)
    return matches


# ---------------------------------------------------------------------------
# built-in passes: the port's rewriters, discoverable
# ---------------------------------------------------------------------------
@register_pass("amp_bf16")
def _amp_pass(program, amp_lists=None):
    """bf16 mixed-precision rewrite (contrib/mixed_precision)."""
    from paddle_tpu_torch.contrib.mixed_precision import decorator as amp

    # rewrite_program works on the default main program's block structure
    amp.rewrite_program(program, amp_lists)
    return program


@register_pass("prune_to_targets")
def _prune_pass(program, feeds=(), targets=()):
    """Backward-slice the program to the target vars (prune.cc analog —
    io.py's inference-model pruning as a reusable pass).  Returns the
    PRUNED CLONE (the original is untouched)."""
    from paddle_tpu_torch import io as _io

    return _io._prune_program(program, list(feeds), list(targets))
