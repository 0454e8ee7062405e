"""Op registry: each op type maps to a torch kernel + metadata.

PyTorch port of the JAX package's ``core/registry.py`` (reference:
paddle/fluid/framework/op_registry.h:66).  A kernel is a plain function
``kernel(inputs, attrs, device) -> outputs`` over ``torch.Tensor``s:
``inputs`` maps slot -> list of tensors, ``device`` is the torch.device
that ops creating a tensor from nothing (fill_constant, range, the
random initialisers) put it on.

Shape inference runs the kernel itself over ``device="meta"`` tensors
— shapes and dtypes without data — the counterpart of the JAX
package's ``jax.eval_shape`` over its kernels.  Grad makers come with
the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set

import torch

from paddle_tpu_torch.core import types as core_types

__all__ = ["OpDef", "register_op", "get_op", "has_op", "infer_shape", "get_kernel"]

# inputs: Dict[slot, List[Tensor]]; returns Dict[slot, List[Tensor]] or
# Dict[slot, Tensor] (normalized to lists by the interpreter).
KernelFn = Callable[[Dict[str, List[Any]], Dict[str, Any], torch.device], Dict[str, Any]]

# output name used by grad makers for inputs that need no gradient
EMPTY_VAR_NAME = "@EMPTY@"

META = torch.device("meta")

_REGISTRY: Dict[str, "OpDef"] = {}


class OpDef:
    def __init__(
        self,
        type: str,
        kernel: Optional[KernelFn],
        infer_shape: Optional[Callable] = None,
        no_grad_set: Optional[Set[str]] = None,
        differentiable: bool = True,
    ):
        self.type = type
        self.kernel = kernel
        self.custom_infer_shape = infer_shape
        # input slots that never receive a gradient (e.g. integer Ids)
        self.no_grad_set = set(no_grad_set or ())
        self.differentiable = differentiable


def register_op(
    type: str,
    infer_shape: Optional[Callable] = None,
    no_grad_set: Optional[Set[str]] = None,
    differentiable: bool = True,
):
    """Decorator: ``@register_op("gelu")`` over the kernel function."""

    def deco(kernel: KernelFn):
        _REGISTRY[type] = OpDef(
            type,
            kernel,
            infer_shape=infer_shape,
            no_grad_set=no_grad_set,
            differentiable=differentiable,
        )
        return kernel

    return deco


def has_op(type: str) -> bool:
    _ensure_ops_loaded()
    return type in _REGISTRY


def get_op(type: str) -> OpDef:
    _ensure_ops_loaded()
    if type in _REGISTRY:
        return _REGISTRY[type]
    raise KeyError("op %r is not registered in paddle_tpu_torch" % type)


def get_kernel(type: str) -> KernelFn:
    k = get_op(type).kernel
    if k is None:
        raise KeyError("op %r has no kernel (structural op?)" % type)
    return k


_ops_loaded = False


def _ensure_ops_loaded():
    global _ops_loaded
    if not _ops_loaded:
        _ops_loaded = True
        import paddle_tpu_torch.ops  # noqa: F401  (registers all builtin ops)


# ---------------------------------------------------------------------------
# Compile-time shape inference over meta tensors
# ---------------------------------------------------------------------------
_DUMMY_BATCH = 117  # stand-in for -1 dims on meta tensors; mapped back after


def _needs_values(exc: BaseException) -> bool:
    """The kernel asked for tensor values, which a meta tensor has none
    of (the counterpart of jax's concretization errors)."""
    if isinstance(exc, NotImplementedError):
        return True
    return isinstance(exc, RuntimeError) and "meta tensor" in str(exc)


def infer_shape(op, block) -> None:
    """Set output var shapes/dtypes by running the kernel on meta tensors.

    Ops may override via ``infer_shape=`` at registration.  A kernel
    that needs tensor values leaves the shapes unset.  Any other failure
    is a real shape/dtype incompatibility when every input shape is
    static, and raises here like the reference's compile-time
    InferShape; with -1 dims (stood in for by ``_DUMMY_BATCH``) a
    failure may be an artifact of the stand-in, so it stays silent.
    """
    try:
        opdef = get_op(op.type)
    except KeyError:
        return
    if opdef.custom_infer_shape is not None:
        opdef.custom_infer_shape(op, block)
        return
    if opdef.kernel is None:
        return
    specs: Dict[str, List[Any]] = {}
    all_static = True
    for slot, names in op.inputs.items():
        lst = []
        for n in names:
            if n == EMPTY_VAR_NAME:
                continue
            v = block.var(n)
            if v.shape is None:
                return  # cannot infer
            if any(s == -1 for s in v.shape):
                all_static = False
            shape = tuple(_DUMMY_BATCH if s == -1 else s for s in v.shape)
            lst.append(torch.empty(shape, dtype=core_types.torch_dtype(v.dtype), device=META))
        specs[slot] = lst
    try:
        out = opdef.kernel(specs, op.attrs, META)
    except Exception as e:  # noqa: BLE001 — classified below
        if _needs_values(e) or not all_static:
            return
        raise ValueError(
            "shape inference failed for op %r (inputs %s): %s"
            % (
                op.type,
                {s: [(n, tuple(block.var(n).shape or ())) for n in ns if n != EMPTY_VAR_NAME]
                 for s, ns in op.inputs.items()},
                e,
            )
        ) from e
    for slot, names in op.outputs.items():
        vals = out.get(slot)
        if vals is None:
            continue
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for n, t in zip(names, vals):
            if n == EMPTY_VAR_NAME or t is None:
                continue
            v = block._find_var_recursive(n)
            if v is None:
                continue
            v.shape = tuple(-1 if s == _DUMMY_BATCH else int(s) for s in t.shape)
            v.dtype = core_types.canonical_dtype(t.dtype)
