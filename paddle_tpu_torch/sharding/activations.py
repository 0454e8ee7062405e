"""Activation sharding: each rank keeps its window of the sequence axis.

The port's counterpart of the JAX package's ``sharding/activations.py``.
There, an :class:`ActivationConstrainer` built by the CompiledProgram from
its rule set and mesh is installed around the block trace, and every op
output the trace writes passes through it: a matched intermediate gets
``with_sharding_constraint`` and GSPMD places the rest.  The port has no
GSPMD: it is SPMD across processes, every rank running every op.  So here
"constrain" means that the rank keeps its slice (its *window*) of the
dim the rule shards, and the ops that follow run on windows:

* ``constrain(name, value)``: a value whose name an activation rule
  matches, with a sharded dim the mesh divides, is cut to this rank's
  window of that dim (a window it already is stays); a value no rule
  matches is left as it is, whole or a window ("reshape and transpose
  temporaries follow their producer").  The rules resolve by regex over
  the intermediate's name, memoized per (name, global shape), with the
  JAX package's divisibility skip (``_shard_factor``), and each trace's
  constrained names go into the report ``stats()`` reads;
* ``prepare_inputs(op, ins)``, before each op: which inputs are windows
  is read from their shapes against the program's var shapes (a window
  is 1/n of its var's dim).  An op that works position by position
  (lookups, the elementwise ops, ``mul`` and ``layer_norm`` over the
  feature dims, reshapes that copy the leading dims, transposes, the unary
  activations) runs on windows as they are; where a whole operand of an
  elementwise op meets a window along that dim, the whole one is cut to
  the window (the position embeddings of a ``range`` over the sequence).
  Any other op gets its windows gathered whole first, so its result is
  the unsharded program's;
* ``fused_attention`` reads ``input_window`` and dispatches to the ring
  (``ring``, ``parallel/ring_attention.py``) where the JAX op does
  (``ops/nn_ops.py``), else gathers its windows (``whole``).

The executor installs a constrainer with ``tracing`` around a compiled
program's step of more than one rank, and ``core.lowering.trace_ops``
consults ``current()`` for every op.  The fetches are gathered whole, so
every rank returns the whole answer.  On meta tensors (shape inference,
``tools.check_partition_rules``) windows are cut and "gathered" by shape
alone, and the ring returns a shape-only result.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, Optional

import torch

__all__ = ["ActivationConstrainer", "tracing", "current"]

_TLS = threading.local()
_MISS = object()

# op types that work position by position along any leading dim, given
# the conditions ``_runs_on_windows`` checks for some of them
_UNARY = frozenset((
    "relu", "gelu", "tanh", "sigmoid", "scale", "cast", "assign", "exp", "sqrt", "square",
    "abs", "leaky_relu", "swish"))
_ELEMENTWISE = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow"))


def current() -> Optional["ActivationConstrainer"]:
    """The ActivationConstrainer installed on this thread, or None."""
    return getattr(_TLS, "ctx", None)


@contextmanager
def tracing(ctx: Optional["ActivationConstrainer"]):
    """Install ``ctx`` for the duration of a block's run."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


class ActivationConstrainer:
    """Applies a rule set's activation specs to a rank's run.

    ``rules``: a PartitionRules carrying activation rules; ``mesh``: the
    ``parallel.mesh.Mesh`` of the ranks (None: shapes only, on the meta
    device); ``axis_sizes``: {axis: size} for the divisibility guard;
    ``coords``: this rank's coordinate on each axis (default: the mesh's).
    ``block``: the program block whose var shapes tell windows from whole
    values."""

    def __init__(self, rules, mesh, axis_sizes: Dict[str, int], coords=None, block=None):
        self.rules = rules
        self.mesh = mesh
        self.block = block
        self.axis_sizes = {str(a): int(n) for a, n in dict(axis_sizes).items()}
        self.coords = dict(coords if coords is not None else (mesh.coords if mesh else {}))
        self._memo: Dict[Any, Any] = {}
        self._win_memo: Dict[Any, Optional[int]] = {}
        # name -> (full_nbytes, per_device_nbytes) of every constrained
        # intermediate of the LAST trace (last-trace-wins, as the JAX package)
        self.report: Dict[str, tuple] = {}
        self._trace_report: Dict[str, tuple] = {}
        # the axes the activation rules shard over (those of more than one
        # rank): a window is one of ``self.n`` equal slices along them
        axes = []
        for _, spec in tuple(rules.activations) + (
                (("", rules.activation_default),) if rules.activation_default is not None else ()):
            for entry in spec:
                for a in ((entry,) if isinstance(entry, str) else tuple(entry or ())):
                    if self.axis_sizes.get(a, 1) > 1 and a not in axes:
                        axes.append(a)
        self.axes = tuple(axes)
        self.n = 1
        self.index = 0  # this rank's window, the axes' coordinates (first outermost)
        for a in self.axes:
            self.n *= self.axis_sizes[a]
            self.index = self.index * self.axis_sizes[a] + int(self.coords.get(a, 0))
        self._op_windows: Dict[str, list] = {}

    @property
    def sp_axis(self) -> Optional[str]:
        """"sp" where the mesh has an sp axis of more than one rank — what
        the fused attention op asks for to pick the ring."""
        from paddle_tpu_torch.sharding.layouts import AXIS_SP

        if self.axis_sizes.get(AXIS_SP, 1) > 1:
            return AXIS_SP
        return None

    def begin_trace(self) -> None:
        self._trace_report = {}

    def end_trace(self) -> None:
        if self._trace_report:
            self.report = dict(self._trace_report)

    def _shard_factor(self, spec, shape) -> int:
        """Total device count the spec splits ``shape`` over, or 0 when
        a sharded dim is not divisible (skip the constraint)."""
        k = 1
        for dim, entry in zip(shape, tuple(spec)):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            f = 1
            for a in axes:
                f *= self.axis_sizes.get(a, 1)
            if f > 1:
                if int(dim) % f:
                    return 0
                k *= f
        return k

    # ------------------------------------------------------------------
    # windows
    # ------------------------------------------------------------------
    def window_dim(self, name: str, shape) -> Optional[int]:
        """The dim along which a value of ``name`` with ``shape`` is this
        rank's window (1/n of its var's dim, every other known dim equal),
        or None for a whole value."""
        key = (name, tuple(shape))
        hit = self._win_memo.get(key, _MISS)
        if hit is _MISS:
            hit = None
            var = self.block._find_var_recursive(name) if self.block is not None else None
            desc = tuple(var.shape) if var is not None and var.shape is not None else None
            if self.n > 1 and desc is not None and len(desc) == len(shape):
                diff = [d for d, (a, b) in enumerate(zip(shape, desc)) if int(b) >= 0 and a != b]
                if len(diff) == 1 and int(shape[diff[0]]) * self.n == int(desc[diff[0]]):
                    hit = diff[0]
            self._win_memo[key] = hit
        return hit

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's window of a whole ``t`` along ``dim``."""
        chunk = t.shape[dim] // self.n
        return t.narrow(dim, self.index * chunk, chunk).contiguous()

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole value of the windows ``t`` of every rank along ``dim``."""
        if t.device.type == "meta" or self.mesh is None:
            return torch.cat([t] * self.n, dim)
        from paddle_tpu_torch.parallel import mesh as mesh_lib

        group, _ = self.mesh.group(self.axes)
        full = mesh_lib.all_gather_cat(t.movedim(dim, 0), group)
        return full.movedim(0, dim).contiguous()

    def input_window(self, slot: str, i: int = 0) -> Optional[int]:
        """The window dim of the current op's input ``slot`` [``i``], or None."""
        dims = self._op_windows.get(slot)
        return dims[i] if dims and i < len(dims) else None

    def whole(self, t, slot: str, i: int = 0):
        """The current op's input ``slot`` [``i``] (``t``) gathered whole."""
        d = self.input_window(slot, i)
        return t if t is None or d is None else self.gather(t, d)

    def ring(self, q, k, v, causal: bool, scale: float):
        """Ring attention of this rank's windows over the sequence axes' group."""
        from paddle_tpu_torch.parallel.ring_attention import ring_attention

        group = None if self.mesh is None else self.mesh.group(self.axes)[0]
        return ring_attention(q, k, v, group, causal=causal, scale=scale)

    # ------------------------------------------------------------------
    # the hooks of core.lowering.trace_ops
    # ------------------------------------------------------------------
    def prepare_inputs(self, op, ins: Dict[str, list]) -> Dict[str, list]:
        """The inputs ``op`` runs on: windows as they are where the op works
        position by position (an elementwise op's whole operand cut to the
        window), gathered whole otherwise."""
        from paddle_tpu_torch.core.registry import EMPTY_VAR_NAME

        wins: Dict[str, list] = {}
        for slot, vals in ins.items():
            names = [n for n in op.inputs.get(slot, ()) if n != EMPTY_VAR_NAME]
            wins[slot] = [self.window_dim(n, v.shape) if isinstance(v, torch.Tensor) else None
                          for n, v in zip(names, vals)]
        self._op_windows = wins
        if not any(d is not None for dims in wins.values() for d in dims):
            return ins
        if op.type == "fused_attention":  # the op picks the ring or gathers
            return ins
        if self._runs_on_windows(op, ins, wins):
            if op.type in _ELEMENTWISE:
                return self._cut_operand(op, ins, wins)
            return ins
        self._op_windows = {}
        return {slot: [self.gather(v, d) if d is not None else v for v, d in zip(vals, wins[slot])]
                for slot, vals in ins.items()}

    def _runs_on_windows(self, op, ins, wins) -> bool:
        t, a = op.type, op.attrs
        only_x = all(d is None for s, dims in wins.items() if s not in ("X", "Ids") for d in dims)
        d = (wins.get("X") or wins.get("Ids") or [None])[0]
        if t in ("lookup_table", "lookup_table_v2"):
            return only_x
        if t in _ELEMENTWISE:
            return True
        if d is None or not only_x:
            return False
        if t in _UNARY or t in ("transpose", "transpose2"):
            return True
        if t == "dropout":
            return bool(a.get("is_test", False))
        if t == "mul":
            return d < int(a.get("x_num_col_dims", 1))
        if t == "layer_norm":
            return d < int(a.get("begin_norm_axis", 1))
        if t == "softmax":
            return d != int(a.get("axis", -1)) % ins["X"][0].dim()
        if t in ("reshape", "reshape2"):
            shape = list(a.get("shape") or ())
            return (not op.inputs.get("Shape") and not op.inputs.get("ShapeTensor")
                    and len(shape) > d and all(int(s) == 0 for s in shape[:d + 1]))
        return False

    def _cut_operand(self, op, ins, wins):
        """An elementwise op: a whole X or Y whose dim, aligned as the op
        broadcasts, spans the window's whole length is cut to the window."""
        x, y = ins["X"][0], ins["Y"][0]
        dx, dy = wins["X"][0], wins["Y"][0]
        axis = int(op.attrs.get("axis", -1))
        off = x.dim() - y.dim() if axis == -1 else axis  # y's dim j is x's dim j + off
        if dx is not None and dy is None:
            j = dx - off
            if 0 <= j < y.dim() and y.shape[j] == x.shape[dx] * self.n:
                ins = dict(ins, Y=[self.cut(y, j)] + ins["Y"][1:])
        elif dy is not None and dx is None:
            j = dy + off
            if 0 <= j < x.dim() and x.shape[j] == y.shape[dy] * self.n:
                ins = dict(ins, X=[self.cut(x, j)] + ins["X"][1:])
        return ins

    # hot-path: begin activation_constrain (runs for every op output of a
    # sequence-parallel step: pure spec resolution and a slice)
    def constrain(self, name: str, value):
        """``value`` as this rank keeps it: its window of the dim the rule
        set shards for ``name``, or untouched."""
        shape = getattr(value, "shape", None)
        if shape is None or not isinstance(value, torch.Tensor):
            return value
        wd = self.window_dim(name, shape)
        gshape = tuple(int(s) * (self.n if d == wd else 1) for d, s in enumerate(shape))
        key = (name, gshape)
        hit = self._memo.get(key, _MISS)
        if hit is _MISS:
            hit = None
            spec = self.rules.activation_spec_for(name, shape=gshape)
            if spec is not None:
                k = self._shard_factor(spec, gshape)
                dims = [d for d, e in enumerate(tuple(spec))
                        if e is not None and any(self.axis_sizes.get(a, 1) > 1 for a in (
                            (e,) if isinstance(e, str) else tuple(e)))]
                if k > 1:
                    if len(dims) != 1 or k != self.n:
                        raise NotImplementedError(
                            "activation rule for %r shards %s over %d ranks; the port keeps "
                            "a window of one dim over the rules' %d" % (name, spec, k, self.n))
                    hit = (dims[0], k)
            self._memo[key] = hit
        if hit is None:
            return value
        d, k = hit
        full = 1
        for s in gshape:
            full *= s
        full *= value.element_size()
        self._trace_report[name] = (full, full // k)
        if wd == d:
            return value
        if wd is not None:
            value = self.gather(value, wd)
        return self.cut(value, d)
    # hot-path: end activation_constrain

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Aggregate bytes of the last traced program's constrained
        intermediates: {'activation_bytes_unsharded', 'activation_bytes
        _per_device', 'n_constrained'}."""
        full = sum(f for f, _ in self.report.values())
        per_dev = sum(p for _, p in self.report.values())
        return {
            "activation_bytes_unsharded": int(full),
            "activation_bytes_per_device": int(per_dev),
            "n_constrained": len(self.report),
        }
