"""Static autodiff: append_backward.

Port of the JAX package's ``backward.py`` (reference:
python/paddle/fluid/backward.py:558).  It walks the forward ops in
reverse and appends one generic ``<type>_grad`` op per differentiable
op, whose kernel re-runs the forward kernel and differentiates it
(``core/registry.py`` ``make_vjp_grad_kernel``).  Several gradient
contributions to one var are summed by a ``sum`` op
(``_addup_repetitive_outputs_``, reference backward.py:135).  The module
is host-only, so the grad-op descs it writes are the JAX package's,
name for name.  No op of the port registers a grad maker of its own.
``gradients()`` (calc_gradient, reference backward.py:939) runs on the
same core with the requested inputs as extra leaves.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.framework import Operator, Parameter, Variable, grad_var_name

__all__ = ["append_backward", "gradients"]


def _is_float_var(v: Variable) -> bool:
    return core_types.is_float_dtype(v.dtype)


def _requires_grad_vars(block, extra_no_grad: Set[str], extra_leaves: Set[str] = frozenset()) -> Set[str]:
    """Forward sweep: which vars can carry gradient back to a trainable leaf.

    ``extra_leaves``: var names treated as grad-carrying leaves regardless of
    their stop_gradient flag (gradients()' ``inputs``, reference
    backward.py:939 calc_gradient marks them the same way).
    """
    req: Set[str] = set(extra_leaves)
    for v in block.vars.values():
        if v.name in extra_no_grad:
            continue
        if isinstance(v, Parameter) and v.trainable:
            req.add(v.name)
        elif not v.stop_gradient and v.op is None and _is_float_var(v):
            # explicitly created leaf (incl. data vars with stop_gradient=False)
            req.add(v.name)
    for op in block.ops:
        try:
            opdef = registry.get_op(op.type)
        except KeyError:
            continue
        if not opdef.differentiable:
            continue
        feeds_grad = False
        for slot, names in op.inputs.items():
            if slot in opdef.no_grad_set:
                continue
            if any(n in req for n in names):
                feeds_grad = True
                break
        if feeds_grad:
            for names in op.outputs.values():
                for n in names:
                    v = block._find_var_recursive(n)
                    if v is not None and _is_float_var(v) and n not in extra_no_grad:
                        req.add(n)
    return req


def _make_grad_op_descs(op: Operator, opdef, out_grad_names: Dict[str, str], req: Set[str]):
    """Build the generic vjp grad-op desc for ``op``.

    ``out_grad_names``: forward output var name -> its (aggregated) grad var.
    Returns (inputs, outputs, attrs, grad_in_to_fwd_in) for one grad op.
    """
    g_inputs: Dict[str, List[str]] = {}
    for slot, names in op.inputs.items():
        g_inputs[slot] = list(names)
    grad_out_slots = []
    empty_mask = {}
    for slot, names in op.outputs.items():
        gnames = [out_grad_names.get(n) for n in names]
        if any(g is not None for g in gnames):
            g_inputs[slot + "@GRAD"] = [g if g is not None else registry.EMPTY_VAR_NAME for g in gnames]
            grad_out_slots.append(slot)
            if any(g is None for g in gnames):
                empty_mask[slot] = [g is None for g in gnames]
    g_outputs: Dict[str, List[str]] = {}
    want_slots = []
    for slot, names in op.inputs.items():
        if slot in opdef.no_grad_set:
            continue
        outs = []
        any_real = False
        for n in names:
            v = op.block._find_var_recursive(n)
            if v is not None and n in req and _is_float_var(v):
                outs.append(n)  # placeholder; caller renames to grad var
                any_real = True
            else:
                outs.append(None)
        if any_real:
            g_outputs[slot + "@GRAD"] = outs
            want_slots.append(slot)
    attrs = dict(op.attrs)
    attrs["__fwd_output_slots__"] = tuple(op.outputs.keys())
    attrs["__grad_input_slots__"] = tuple(want_slots)
    if empty_mask:
        # positions whose upstream grad is absent (EMPTY_VAR_NAME inputs
        # are dropped at trace time; the vjp kernel re-inserts zeros here)
        attrs["__empty_out_grad_mask__"] = empty_mask
    attrs["op_role"] = "backward"
    return g_inputs, g_outputs, attrs


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
):
    """Append grad ops for ``loss`` to its program; return [(param, grad)].

    Matches the reference contract (backward.py:558): loss must be a scalar
    (or shape-[1]) var in the main program's global block.
    """
    result, _ = _append_backward_impl([loss], [None], parameter_list, no_grad_set)
    return result


def _append_backward_impl(
    targets: Sequence[Variable],
    target_gradients: Sequence[Optional[Variable]],
    parameter_list: Optional[Sequence],
    no_grad_set: Optional[Set[str]],
    extra_leaves: Set[str] = frozenset(),
):
    """Shared core of append_backward (single scalar loss) and gradients()
    (multi-target calc_gradient, reference backward.py:821,939): seed each
    target's output-grad (ones, or the caller's target_gradients var), walk
    the block's ops once in reverse accumulating contributions, and return
    [(param, grad)] for the trainable parameters.
    """
    block = targets[0].block
    program = block.program
    for t in targets[1:]:
        if t.block is not block:
            raise ValueError("all gradient targets must live in one block")
    target_names = {t.name for t in targets}
    extra_no_grad = set(no_grad_set or ())
    for v in program.list_vars():
        if v.stop_gradient and not isinstance(v, Parameter):
            extra_no_grad.add(v.name)
        if isinstance(v, Parameter) and not v.trainable:
            extra_no_grad.add(v.name)
    extra_no_grad -= target_names
    extra_no_grad -= set(extra_leaves)

    req = _requires_grad_vars(block, extra_no_grad - target_names, extra_leaves)
    for t in targets:
        if t.name not in req:
            raise ValueError(
                "target %r does not depend on any trainable parameter or "
                "requested input" % t.name
            )

    # locate the last op producing any target
    loss_op_idx = None
    for i in reversed(range(len(block.ops))):
        if target_names & set(block.ops[i].output_arg_names):
            loss_op_idx = i
            break
    if loss_op_idx is None:
        raise ValueError("no gradient target is produced by any op")

    # seed d(target)/d(target): ones, or the caller-provided grad var
    contributions: Dict[str, List[str]] = {}
    for t, tg in zip(targets, target_gradients):
        if tg is not None:
            if tuple(tg.shape or ()) != tuple(t.shape or ()):
                raise ValueError(
                    "target_gradient %r shape %s != target %r shape %s"
                    % (tg.name, tg.shape, t.name, t.shape)
                )
            contributions.setdefault(t.name, []).append(tg.name)
            continue
        loss_grad = grad_var_name(t.name)
        block.create_var(
            name=loss_grad, shape=t.shape or (1,), dtype=t.dtype, stop_gradient=True
        )
        block.append_op(
            type="fill_constant",
            outputs={"Out": [loss_grad]},
            attrs={
                "shape": list(t.shape or (1,)),
                "value": 1.0,
                "dtype": t.dtype,
                "op_role": "backward",
            },
        )
        contributions.setdefault(t.name, []).append(loss_grad)

    # reverse walk, accumulating grad contributions per forward var
    finalized: Dict[str, str] = {}

    def aggregate(name: str) -> Optional[str]:
        """Sum multiple grad contributions (reference backward.py:135)."""
        if name in finalized:
            return finalized[name]
        contribs = contributions.get(name)
        if not contribs:
            return None
        if len(contribs) == 1:
            finalized[name] = contribs[0]
            return contribs[0]
        gname = grad_var_name(name)
        if gname in (c for c in contribs):
            gname = gname + "@SUM"
        fv = block._find_var_recursive(name)
        block.create_var(name=gname, shape=fv.shape if fv else None, dtype=fv.dtype if fv else "float32", stop_gradient=True)
        block.append_op(
            type="sum",
            inputs={"X": contribs},
            outputs={"Out": [gname]},
            attrs={"op_role": "backward"},
        )
        finalized[name] = gname
        return gname

    def add_contribution(fwd_name: str, grad_name: str):
        contributions.setdefault(fwd_name, []).append(grad_name)

    fwd_ops = list(block.ops[: loss_op_idx + 1])
    for op in reversed(fwd_ops):
        try:
            opdef = registry.get_op(op.type)
        except KeyError:
            continue
        if not opdef.differentiable:
            continue
        # does any output carry grad?
        out_has_grad = any(n in contributions for n in op.output_arg_names)
        if not out_has_grad:
            continue
        in_needs_grad = any(
            n in req and n not in extra_no_grad
            for slot, names in op.inputs.items()
            if slot not in opdef.no_grad_set
            for n in names
        )
        if not in_needs_grad:
            continue

        out_grad_names = {}
        for n in op.output_arg_names:
            g = aggregate(n)
            if g is not None:
                out_grad_names[n] = g

        g_inputs, g_outputs, g_attrs = _make_grad_op_descs(op, opdef, out_grad_names, req - extra_no_grad)
        if not g_outputs:
            continue
        # name grad outputs uniquely, register contributions
        final_outputs: Dict[str, List[str]] = {}
        for slot, names in g_outputs.items():
            outs = []
            for fwd_name in names:
                if fwd_name is None:
                    outs.append(registry.EMPTY_VAR_NAME)
                    continue
                base = grad_var_name(fwd_name)
                k = len(contributions.get(fwd_name, []))
                gname = base if k == 0 else "%s@RENAME@%d" % (base, k)
                fv = block._find_var_recursive(fwd_name)
                block.create_var(
                    name=gname,
                    shape=fv.shape if fv else None,
                    dtype=fv.dtype if fv else "float32",
                    stop_gradient=True,
                )
                add_contribution(fwd_name, gname)
                outs.append(gname)
            final_outputs[slot] = outs
        block.append_op(type=op.type + "_grad", inputs=g_inputs, outputs=final_outputs, attrs=g_attrs)

    # collect (param, grad) pairs
    if parameter_list is not None:
        params = [
            block._find_var_recursive(p) if isinstance(p, str) else p
            for p in parameter_list
        ]
    else:
        params = [p for p in program.global_block().all_parameters() if p.trainable]
    result = []
    for p in params:
        if p is None or p.name in extra_no_grad:
            continue
        g = aggregate(p.name)
        if g is None:
            continue
        gvar = block._find_var_recursive(g)
        result.append((p, gvar))
    # aggregate the requested input leaves (gradients()' inputs): multiple
    # targets contribute separately-named grads; the summed var is what the
    # caller must read, so hand its name back explicitly
    leaf_grads: Dict[str, Optional[str]] = {
        name: aggregate(name) for name in extra_leaves
    }
    program.version += 1
    return result, leaf_grads


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """reference: backward.py:939 calc_gradient: d(sum of targets)/d(inputs).

    Each target's output-grad is seeded (ones, or the matching
    ``target_gradients`` entry) and the contributions of all targets sum
    into each input's grad (backward.py:821).  Returns one grad var per
    input, None where an input gets no gradient.
    """
    targets = list(targets) if isinstance(targets, (list, tuple)) else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError("target_gradients length %d != targets length %d"
                         % (len(target_gradients), len(targets)))
    _, leaf_grads = _append_backward_impl(
        targets, list(target_gradients), parameter_list=None, no_grad_set=no_grad_set,
        extra_leaves={iv.name for iv in inputs})
    block = targets[0].block
    return [block._find_var_recursive(leaf_grads[iv.name]) if leaf_grads.get(iv.name) else None
            for iv in inputs]
