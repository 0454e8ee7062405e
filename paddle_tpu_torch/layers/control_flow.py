"""Control-flow layers: While, StaticRNN, DynamicRNN, cond, IfElse,
Switch, the tensor arrays, increment and the rank table.

The JAX package's ``layers/control_flow.py``, layer call for layer call,
so both give the same Program JSON (reference:
python/paddle/fluid/layers/control_flow.py — While:630, StaticRNN:280,
ConditionalBlock:1352, IfElse:1564).  The reference runs sub-blocks
through a nested Executor over scope chains; here the layer classes
compute the *loop-carried variable set* at build time and emit a single
structural op ("while" / "bounded_while" / "static_rnn" / "dynamic_rnn"
/ "select_branch", ops/control_flow_ops.py) whose kernel runs the
sub-block once a step.
"""
from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["While", "StaticRNN", "DynamicRNN", "IfElse", "Switch", "cond",
           "increment", "create_array", "array_write", "array_read",
           "array_length", "lod_rank_table", "reorder_lod_tensor_by_rank"]


def increment(x, value=1.0, in_place=True):
    """reference: layers/control_flow.py increment."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": 1.0, "bias": float(value)},
    )
    return out


def _analyze_sub_block(sub_block, exclude_locals=()):
    """Return (carried, externals): names written by sub-block ops that
    live in an outer block (mutated loop state), and outer names read
    but never locally produced."""
    produced = set(exclude_locals)
    carried: List[str] = []
    externals: List[str] = []
    parent = sub_block.parent_block
    for op in sub_block.ops:
        for n in op.input_arg_names:
            if n in produced or n in carried or n in externals:
                continue
            if parent is not None and parent.has_var(n):
                externals.append(n)
        for n in op.output_arg_names:
            if parent is not None and parent.has_var(n) and n not in sub_block.vars:
                if n not in carried:
                    carried.append(n)
            produced.add(n)
    # a var both carried and external is loop state, not a constant input
    externals = [n for n in externals if n not in carried]
    return carried, externals


class While:
    """reference: layers/control_flow.py:630.

    ::

        i = layers.fill_constant(shape=[1], dtype='int64', value=0)
        cond = layers.less_than(i, limit)
        loop = layers.While(cond)
        with loop.block():
            ...  # ops mutating outer vars
            layers.less_than(i, limit, cond=cond)
    """

    def __init__(self, cond: Variable, is_test: bool = False, name: Optional[str] = None,
                 max_trip_count: Optional[int] = None):
        """``max_trip_count``: static trip bound; when given, the loop
        is the op ``bounded_while``: that many masked steps, no host read
        (so its plan is captured), and ``append_backward`` can
        differentiate through it (reference: controlflow/while_op.cc
        grad)."""
        self.cond_var = cond
        self.max_trip_count = max_trip_count
        self.helper = LayerHelper("while", name=name)

    class _BlockGuard:
        def __init__(self, w):
            self.w = w

        def __enter__(self):
            prog = framework.default_main_program()
            self.w.sub_block = prog._create_block()
            return self.w.sub_block

        def __exit__(self, exc_type, *a):
            if exc_type is not None:
                return False
            prog = framework.default_main_program()
            prog._rollback()
            w = self.w
            carried, externals = _analyze_sub_block(w.sub_block)
            if w.cond_var.name not in carried:
                carried.insert(0, w.cond_var.name)
            parent = prog.current_block()
            attrs = {
                "sub_block": w.sub_block,
                "carry_names": list(carried),
                "external_names": list(externals),
                "cond_name": w.cond_var.name,
            }
            op_type = "while"
            x_in = carried + externals
            if w.max_trip_count is not None:
                op_type = "bounded_while"
                attrs["max_trip_count"] = int(w.max_trip_count)
                # The loop writes its outputs over its own input names
                # (reference in-place Scope mutation).  The grad op later
                # re-reads X to recompute the forward, so it must see the
                # PRE-loop values — snapshot each carry into a fresh var
                # (the SSA-ification SURVEY.md §7 hard-part #3 calls for,
                # applied just where reverse-mode needs it).
                snap = []
                for n in carried:
                    v = parent._find_var_recursive(n)
                    sn = parent.create_var(
                        name=unique_name.generate(n + ".while_init"),
                        shape=v.shape,
                        dtype=v.dtype,
                        stop_gradient=v.stop_gradient,
                    )
                    parent.append_op(
                        type="assign",
                        inputs={"X": [n]},
                        outputs={"Out": [sn.name]},
                        attrs={},
                    )
                    snap.append(sn.name)
                x_in = snap + externals
            parent.append_op(
                type=op_type,
                inputs={"X": x_in},
                outputs={"Out": list(carried)},
                attrs=attrs,
            )
            return False

    def block(self):
        return While._BlockGuard(self)


def cond(pred: Variable, true_fn, false_fn):
    """Functional two-armed conditional (modern fluid layers.cond API;
    subsumes IfElse/ConditionalBlock for the common case)."""
    prog = framework.default_main_program()
    parent = prog.current_block()

    def build(fn):
        blk = prog._create_block()
        outs = fn()
        prog._rollback()
        if outs is None:
            outs = ()
        if isinstance(outs, Variable):
            outs = (outs,)
        return blk, [o.name for o in outs], list(outs)

    tblk, tnames, touts = build(true_fn)
    fblk, fnames, fouts = build(false_fn)
    if len(tnames) != len(fnames):
        raise ValueError("cond branches must return the same number of outputs")

    # externals = union of both branches' outer reads
    _, text = _analyze_sub_block(tblk)
    _, fext = _analyze_sub_block(fblk)
    externals = list(dict.fromkeys(text + fext))

    # false branch vars are renamed into the true branch's output names
    # so both arms bind the same out_names
    rename = dict(zip(fnames, tnames))
    for op in fblk.ops:
        for old, new in rename.items():
            op._rename_output(old, new)
            op._rename_input(old, new)

    out_vars = []
    for tv in touts:
        ov = parent.create_var(
            name=unique_name.generate(tv.name + ".cond_out"),
            shape=tv.shape,
            dtype=tv.dtype,
        )
        out_vars.append(ov)
    parent.append_op(
        type="select_branch",
        inputs={"Cond": [pred], "X": externals},
        outputs={"Out": [v.name for v in out_vars]},
        attrs={
            "true_block": tblk,
            "false_block": fblk,
            "out_names": tnames,
            "external_names": externals,
        },
    )
    return out_vars[0] if len(out_vars) == 1 else out_vars


class StaticRNN:
    """reference: layers/control_flow.py:280 — time-major recurrence.

    Inputs are [T, B, ...]; ``step_input`` slices one step, ``memory``
    declares loop state, ``step_output`` stacks per-step values.
    One op (static_rnn), a step of the sub-block per time step; BPTT
    through the generic vjp.
    """

    def __init__(self, name: Optional[str] = None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._x_pairs = []        # (outer var, placeholder)
        self._mem = []            # (placeholder, init outer var, updated name)
        self._outputs = []        # sub-block vars to stack
        self._built = False

    class _StepGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            prog = framework.default_main_program()
            self.rnn.sub_block = prog._create_block()
            return self.rnn

        def __exit__(self, exc_type, *a):
            if exc_type is not None:
                return False
            framework.default_main_program()._rollback()
            self.rnn._complete()
            return False

    def step(self):
        return StaticRNN._StepGuard(self)

    # --- in-step API ---
    def step_input(self, x: Variable) -> Variable:
        ph = self.sub_block.create_var(
            name=unique_name.generate("rnn_step_in"),
            shape=x.shape[1:],
            dtype=x.dtype,
        )
        self._x_pairs.append((x, ph))
        return ph

    def memory(self, init: Optional[Variable] = None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=0) -> Variable:
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory needs init= or (shape=, batch_ref=)")
            # the init must live in the parent block (it is a loop input);
            # a step-input placeholder batch_ref maps back to its outer
            # time-major var (+1 on the batch dim index)
            parent = self.sub_block.parent_block
            ref_outer, dim_idx = None, ref_batch_dim_idx
            for outer, ph in self._x_pairs:
                if ph is batch_ref or ph.name == batch_ref.name:
                    ref_outer, dim_idx = outer, ref_batch_dim_idx + 1
                    break
            if ref_outer is None:
                ref_outer = batch_ref
            tail = list(shape[1:]) if shape and shape[0] in (-1, None) else list(shape)
            init = parent.create_var(
                name=unique_name.generate("rnn_mem_init"),
                shape=[-1] + tail,
                dtype="float32",
            )
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref_outer]},
                outputs={"Out": [init]},
                attrs={
                    "shape": [-1] + tail,
                    "value": float(init_value),
                    "dtype": "float32",
                    "input_dim_idx": dim_idx,
                    "output_dim_idx": init_batch_dim_idx,
                },
            )
        ph = self.sub_block.create_var(
            name=unique_name.generate("rnn_mem"),
            shape=init.shape,
            dtype=init.dtype,
        )
        self._mem.append([ph, init, None])
        return ph

    def update_memory(self, mem: Variable, new: Variable):
        for rec in self._mem:
            if rec[0] is mem or rec[0].name == mem.name:
                rec[2] = new.name
                return
        raise ValueError("update_memory: %r is not a declared memory" % mem.name)

    def step_output(self, o: Variable):
        self._outputs.append(o)

    def output(self, *outs):
        for o in outs:
            self.step_output(o)

    # --- completion ---
    def _complete(self):
        prog = framework.default_main_program()
        parent = prog.current_block()
        if any(rec[2] is None for rec in self._mem):
            raise ValueError("every memory needs update_memory before the step ends")

        locals_ = {ph.name for _, ph in self._x_pairs} | {rec[0].name for rec in self._mem}
        _, externals = _analyze_sub_block(self.sub_block, exclude_locals=locals_)
        externals = [n for n in externals if n not in locals_]

        x_outer = [x for x, _ in self._x_pairs]
        seq_len = x_outer[0].shape[0] if x_outer and x_outer[0].shape else None
        out_vars = []
        for o in self._outputs:
            ov = parent.create_var(
                name=unique_name.generate(o.name + ".rnn_out"),
                shape=(seq_len,) + tuple(o.shape or ()),
                dtype=o.dtype,
            )
            out_vars.append(ov)
        final_mems = []
        for ph, init, _ in self._mem:
            fv = parent.create_var(
                name=unique_name.generate(ph.name + ".final"),
                shape=init.shape,
                dtype=init.dtype,
            )
            final_mems.append(fv)

        parent.append_op(
            type="static_rnn",
            inputs={"X": [x.name for x in x_outer]
                    + [rec[1].name for rec in self._mem]
                    + externals},
            outputs={"Out": [v.name for v in out_vars] + [v.name for v in final_mems]},
            attrs={
                "sub_block": self.sub_block,
                "x_names": [ph.name for _, ph in self._x_pairs],
                "mem_names": [rec[0].name for rec in self._mem],
                "mem_out_names": [rec[2] for rec in self._mem],
                "out_names": [o.name for o in self._outputs],
                "external_names": externals,
            },
        )
        self._out_vars = out_vars
        self._built = True

    def __call__(self):
        if not self._built:
            raise RuntimeError("StaticRNN used before its step block completed")
        return self._out_vars[0] if len(self._out_vars) == 1 else self._out_vars


class DynamicRNN:
    """Variable-length recurrence (reference: layers/control_flow.py:1700).

    The reference walks LoD ragged batches with a shrinking batch; the
    TPU-native encoding is padded ``[B, T, ...]`` sequences plus a
    ``SeqLen`` vector (the framework's LoD shim, ops/sequence_ops.py), so
    DynamicRNN is ONE op over the time axis with per-example masking
    (op ``dynamic_rnn``) — fully differentiable, fixed shapes.

    ::

        drnn = layers.DynamicRNN()
        with drnn.block():
            word = drnn.step_input(x, seq_len=lens)   # x: [B, T, D]
            prev = drnn.memory(shape=[H], value=0.0)
            hidden = layers.fc(layers.concat([word, prev], axis=1), H, act='tanh')
            drnn.update_memory(prev, hidden)
            drnn.output(hidden)
        out = drnn()    # [B, T, H]; padding steps are zero
    """

    def __init__(self, keep_memory: bool = False, name: Optional[str] = None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._x_pairs = []      # (outer seq var [B,T,...], placeholder [B,...])
        self._statics = []      # (outer var, placeholder)
        self._mem = []          # [placeholder, init outer var, updated name]
        self._outputs = []
        self._seq_len = None
        self._built = False

    class _BlockGuard:
        def __init__(self, rnn):
            self.rnn = rnn

        def __enter__(self):
            prog = framework.default_main_program()
            self.rnn.sub_block = prog._create_block()
            return self.rnn

        def __exit__(self, exc_type, *a):
            if exc_type is not None:
                return False
            framework.default_main_program()._rollback()
            self.rnn._complete()
            return False

    def block(self):
        return DynamicRNN._BlockGuard(self)

    # --- in-step API ---
    def step_input(self, x: Variable, level: int = 0, seq_len: Optional[Variable] = None) -> Variable:
        """x: [B, T, ...] padded; ``seq_len``: [B] lengths (required on
        the first step_input — the reference reads lengths from the LoD)."""
        if seq_len is not None:
            self._seq_len = seq_len
        if self._seq_len is None:
            raise ValueError(
                "DynamicRNN.step_input needs seq_len= on its first call "
                "(padded+mask LoD encoding)"
            )
        ph = self.sub_block.create_var(
            name=unique_name.generate("drnn_step_in"),
            shape=(x.shape[0],) + tuple(x.shape[2:]),
            dtype=x.dtype,
        )
        self._x_pairs.append((x, ph))
        return ph

    def static_input(self, x: Variable) -> Variable:
        """Whole-sequence input visible unchanged at every step."""
        ph = self.sub_block.create_var(
            name=unique_name.generate("drnn_static_in"),
            shape=x.shape,
            dtype=x.dtype,
        )
        self._statics.append((x, ph))
        return ph

    def memory(self, init: Optional[Variable] = None, shape=None, value=0.0,
               need_reorder: bool = False, dtype: str = "float32") -> Variable:
        if init is None:
            if shape is None:
                raise ValueError("memory needs init= or shape=")
            if not self._x_pairs:
                raise ValueError("declare step_input before value-initialized memory")
            parent = self.sub_block.parent_block
            ref = self._x_pairs[0][0]
            tail = [int(s) for s in shape]
            init = parent.create_var(
                name=unique_name.generate("drnn_mem_init"),
                shape=[-1] + tail,
                dtype=dtype,
            )
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref]},
                outputs={"Out": [init]},
                attrs={"shape": [-1] + tail, "value": float(value),
                       "dtype": dtype, "input_dim_idx": 0, "output_dim_idx": 0},
            )
        ph = self.sub_block.create_var(
            name=unique_name.generate("drnn_mem"),
            shape=init.shape,
            dtype=init.dtype,
        )
        self._mem.append([ph, init, None])
        return ph

    def update_memory(self, mem: Variable, new: Variable):
        for rec in self._mem:
            if rec[0] is mem or rec[0].name == mem.name:
                rec[2] = new.name
                return
        raise ValueError("update_memory: %r is not a declared memory" % mem.name)

    def output(self, *outs):
        self._outputs.extend(outs)

    # --- completion ---
    def _complete(self):
        prog = framework.default_main_program()
        parent = prog.current_block()
        if any(rec[2] is None for rec in self._mem):
            raise ValueError("every memory needs update_memory before the block ends")
        if not self._x_pairs:
            raise ValueError("DynamicRNN needs at least one step_input")

        locals_ = (
            {ph.name for _, ph in self._x_pairs}
            | {ph.name for _, ph in self._statics}
            | {rec[0].name for rec in self._mem}
        )
        _, externals = _analyze_sub_block(self.sub_block, exclude_locals=locals_)
        externals = [n for n in externals if n not in locals_]

        x_outer = [x for x, _ in self._x_pairs]
        static_outer = [x for x, _ in self._statics]
        T = x_outer[0].shape[1] if len(x_outer[0].shape or ()) > 1 else None
        out_vars = []
        for o in self._outputs:
            shp = tuple(o.shape or ())
            ov = parent.create_var(
                name=unique_name.generate(o.name + ".drnn_out"),
                shape=(shp[0] if shp else -1, T) + tuple(shp[1:]),
                dtype=o.dtype,
            )
            out_vars.append(ov)
        final_mems = []
        for ph, init, _ in self._mem:
            fv = parent.create_var(
                name=unique_name.generate(ph.name + ".final"),
                shape=init.shape,
                dtype=init.dtype,
            )
            final_mems.append(fv)

        parent.append_op(
            type="dynamic_rnn",
            inputs={"X": [x.name for x in x_outer]
                    + [rec[1].name for rec in self._mem]
                    + [x.name for x in static_outer]
                    + externals,
                    "SeqLen": [self._seq_len.name]},
            outputs={"Out": [v.name for v in out_vars] + [v.name for v in final_mems]},
            attrs={
                "sub_block": self.sub_block,
                "x_names": [ph.name for _, ph in self._x_pairs],
                "mem_names": [rec[0].name for rec in self._mem],
                "mem_out_names": [rec[2] for rec in self._mem],
                "out_names": [o.name for o in self._outputs],
                "static_names": [ph.name for _, ph in self._statics] + externals,
            },
        )
        self._out_vars = out_vars
        self._final_mems = final_mems
        self._built = True

    def __call__(self):
        if not self._built:
            raise RuntimeError("DynamicRNN used before its block completed")
        return self._out_vars[0] if len(self._out_vars) == 1 else self._out_vars


def create_array(size, shape, dtype="float32", name=None):
    """LoDTensorArray analog: a pre-sized stacked tensor [size, *shape]
    (reference: layers/control_flow.py create_array over
    LOD_TENSOR_ARRAY; a static bound keeps the shapes fixed)."""
    from paddle_tpu_torch.layers import tensor as ltensor

    return ltensor.fill_constant([int(size)] + list(shape), dtype, 0.0)


def array_write(x, i, array):
    """reference: layers/control_flow.py array_write.

    Writes OVER the array var (Out == Array), matching the reference's
    in-place LoDTensorArray mutation — critical inside a While sub-block,
    where only vars the sub-block *writes* become loop-carried state
    (``_analyze_sub_block``); an SSA fresh-var output would silently drop
    every write on the next iteration."""
    helper = LayerHelper("array_write")
    helper.append_op(
        type="write_to_array",
        inputs={"Array": [array], "I": [i], "X": [x]},
        outputs={"Out": [array]},
        attrs={},
    )
    return array


def array_read(array, i):
    """reference: layers/control_flow.py array_read."""
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(array.dtype)
    helper.append_op(
        type="read_from_array",
        inputs={"X": [array], "I": [i]},
        outputs={"Out": [out]},
        attrs={},
    )
    return out


def array_length(array):
    """Length of the array: the STATIC allocated capacity (create_array
    size), not a written-element count — the padded-static shim's
    divergence from the reference's growing LoDTensorArray.  Track a
    separate counter var if the loop writes fewer slots."""
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]}, attrs={})
    return out


class IfElse:
    """reference: layers/control_flow.py:1564 — per-example two-way
    branch: true_block/false_block see the rows selected by the
    condition; outputs merge back in original order.

    Static-shape form: both blocks run on the FULL batch (no dynamic
    shapes) and ``where`` merges per row — semantically the
    reference's split+merge for elementwise-batch computations.

    GRADIENT CAVEAT (the classic where-grad gotcha): because the
    unselected branch still executes on every row, a branch whose vjp is
    non-finite on unselected rows (sqrt/log/div of invalid inputs)
    poisons the gradient (0 * NaN = NaN).  Guard the branch INPUT, not
    just its output: ``safe = layers.where(cond, x, ones_like(x))``
    inside the branch.
    """

    def __init__(self, cond: Variable, name: Optional[str] = None):
        self._cond = cond
        self._true_outs: List[Variable] = []
        self._false_outs: List[Variable] = []
        self._in_true = None

    class _Branch:
        def __init__(self, parent, is_true):
            self.parent, self.is_true = parent, is_true

        def __enter__(self):
            self.parent._in_true = self.is_true
            return self

        def __exit__(self, *exc):
            self.parent._in_true = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def input(self, x: Variable) -> Variable:
        # full-batch pass-through (the reference slices selected rows;
        # here masking happens at merge)
        return x

    def output(self, *outs):
        if self._in_true is None:
            raise RuntimeError("IfElse.output called outside a branch block")
        (self._true_outs if self._in_true else self._false_outs).extend(outs)

    def __call__(self):
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError("IfElse branches produced different output counts")
        from paddle_tpu_torch.layers import tensor as ltensor

        merged = [
            ltensor.where(self._cond, t, f)
            for t, f in zip(self._true_outs, self._false_outs)
        ]
        return merged[0] if len(merged) == 1 else merged


class Switch:
    """reference: layers/control_flow.py Switch — sequential
    case/default assignment, lowered to nested where-selects."""

    def __init__(self, name: Optional[str] = None):
        self._cases = []  # (cond_var or None, fn-scope marker)
        self._pending = None

    class _Case:
        def __init__(self, sw, cond):
            self.sw, self.cond = sw, cond

        def __enter__(self):
            self.sw._pending = (self.cond, [])
            return self

        def __exit__(self, *exc):
            self.sw._cases.append(self.sw._pending)
            self.sw._pending = None
            return False

    def case(self, cond: Variable):
        return Switch._Case(self, cond)

    def default(self):
        return Switch._Case(self, None)

    def assign(self, var: Variable):
        """Record this branch's value (call inside a case block)."""
        if self._pending is None:
            raise RuntimeError("Switch.assign outside a case block")
        self._pending[1].append(var)

    def merge(self):
        """Fold cases: first true condition wins, else default."""
        from paddle_tpu_torch.layers import tensor as ltensor

        default = None
        conds = []
        for cond, vals in self._cases:
            if len(vals) != 1:
                raise ValueError(
                    "each Switch case needs exactly one assign (got %d)" % len(vals)
                )
            if cond is None:
                default = vals[0]
            else:
                conds.append((cond, vals[0]))
        if default is None:
            raise ValueError("Switch needs a default case")
        out = default
        for cond, val in reversed(conds):
            out = ltensor.where(cond, val, out)
        return out


def lod_rank_table(x, level=0, seq_len=None):
    """Rank table sorted by sequence length descending (reference:
    layers/control_flow.py lod_rank_table + lod_rank_table.cc).

    On the padded encoding the table is built from the companion length
    vector: for a ``data(lod_level>=1)`` var the ``<name>_seq_len``
    (level 0) or ``<name>_inner_len`` (level 1) var is found
    automatically; pass ``seq_len`` explicitly otherwise.  Returns the
    index var (sorted original positions); its ``.lengths`` attribute
    holds the sorted-lengths var."""
    helper = LayerHelper("lod_rank_table")
    if seq_len is None:
        suffix = "_seq_len" if level == 0 else "_inner_len"
        block = helper.main_program.current_block()
        name = getattr(x, "name", str(x)) + suffix
        seq_len = block._find_var_recursive(name)
        if seq_len is None:
            raise ValueError(
                "lod_rank_table: no companion %r length var; pass seq_len" % name
            )
    index = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    lengths = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        type="lod_rank_table", inputs={"X": [seq_len]},
        outputs={"Index": [index], "Length": [lengths]},
        attrs={"level": int(level)},
    )
    index.lengths = lengths
    return index


def reorder_lod_tensor_by_rank(x, rank_table):
    """Gather x's batch rows into rank-table order (reference:
    layers/control_flow.py reorder_lod_tensor_by_rank +
    reorder_lod_tensor_by_rank_op.cc)."""
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x], "RankTable": [rank_table]},
        outputs={"Out": [out]}, attrs={},
    )
    return out
