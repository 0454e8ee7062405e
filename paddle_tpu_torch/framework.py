"""Graph IR: Program / Block / Operator / Variable, and the places.

PyTorch port of the JAX package's ``framework.py`` (reference:
python/paddle/fluid/framework.py:383,992,1443,2782).  The IR is the
same lightweight Python structure and serializes to the same JSON
(``Program.to_json``/``from_json``), so a model saved by either package
loads in the other.  What differs is what a Place means: here it names
a ``torch.device``, and the executor interprets the block op by op over
torch kernels on that device (``core/lowering.py``).
"""
from __future__ import annotations

import collections
import contextlib
import copy
import itertools
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.core.types import VarType

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "name_scope",
    "grad_var_name",
    "cpu_places",
    "cuda_places",
    "cuda_pinned_places",
    "op_role_guard",
    "CPUPlace",
    "CUDAPlace",
    "device_of",
]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    """reference: paddle/fluid/framework/grad_op_desc_maker.h (GradVarName)."""
    return name + GRAD_SUFFIX


# ---------------------------------------------------------------------------
# Places (reference: paddle/fluid/platform/place.h:79).  A Place names the
# torch.device the executor runs on.
# ---------------------------------------------------------------------------
class Place:
    def device(self) -> torch.device:
        raise NotImplementedError

    def __repr__(self):
        return type(self).__name__ + "()"


class CPUPlace(Place):
    def device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """One CUDA card (reference: place.h:58)."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def device(self) -> torch.device:
        return torch.device("cuda", self.device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


def default_cuda_place() -> "CUDAPlace":
    """The card an entry point takes when given no place: ``cuda:0``, or
    in a ``torch.distributed`` world rank ``r``'s ``cuda:(r % cards)``
    (ranks of one card share it)."""
    import torch.distributed as dist

    if (dist.is_available() and dist.is_initialized() and torch.cuda.is_available()
            and torch.cuda.device_count() > 0):
        return CUDAPlace(dist.get_rank() % torch.cuda.device_count())
    return CUDAPlace(0)


def device_of(place: Optional[Place]) -> torch.device:
    """The torch.device an entry point runs on.  No place means
    ``default_cuda_place()``; a CUDA place with no such card raises — there
    is no silent fall back to the CPU (pass ``CPUPlace()`` for that)."""
    if place is None:
        place = default_cuda_place()
    dev = place.device()
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "%r needs a CUDA device and none is available; pass "
                "CPUPlace() to run on the CPU" % (place,))
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                "%r: only %d CUDA device(s) visible"
                % (place, torch.cuda.device_count()))
    return dev


def cpu_places(device_count=None):
    return [CPUPlace() for _ in range(device_count or 1)]


def cuda_places(device_ids=None):
    """reference: framework.py cuda_places — one CUDAPlace per visible
    card (or per requested id)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [CUDAPlace(int(i)) for i in device_ids]


def cuda_pinned_places(device_count=None):
    """Pinned host staging memory (reference: framework.py
    cuda_pinned_places): host places, one per device."""
    return [CPUPlace() for _ in range(device_count or 1)]


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------
class Variable:
    """A named tensor in a Block (reference: framework.py:383).

    ``shape`` may contain -1 (unknown/batch dims); concrete shapes are
    bound when the executor runs the block.
    """

    def __init__(
        self,
        block: "Block",
        name: str,
        shape: Optional[Sequence[int]] = None,
        dtype: str = "float32",
        type: int = VarType.LOD_TENSOR,
        persistable: bool = False,
        stop_gradient: bool = False,
        lod_level: int = 0,
        is_data: bool = False,
        **kwargs,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = core_types.canonical_dtype(dtype)
        self.type = type
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.lod_level = lod_level
        self.is_data = is_data
        # op that most recently produced this var (set by append_op)
        self.op: Optional["Operator"] = None

    # persistable decides which vars the executor's cached run plan reads
    # from and writes back to the scope, and the plan key holds the
    # program's version: so a toggle after a run (the mark-before-save
    # pattern) bumps the version, and the next run analyses a new plan
    @property
    def persistable(self) -> bool:
        return self._persistable

    @persistable.setter
    def persistable(self, value) -> None:
        value = bool(value)
        if value == getattr(self, "_persistable", None):
            return  # the same value again: the plan stands
        self._persistable = value
        prog = getattr(getattr(self, "block", None), "program", None)
        if prog is not None:
            prog.version += 1

    def astype(self, dtype):
        """This var cast to ``dtype`` (a ``cast`` op)."""
        from paddle_tpu_torch.layers import tensor as ltensor

        return ltensor.cast(self, dtype)

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s)" % (
            self.name,
            self.shape,
            self.dtype,
            ", persistable" if self.persistable else "",
        )

    __str__ = __repr__

    def _binary(self, other, op, reverse=False):
        from paddle_tpu_torch.layers import math_helper

        return math_helper.binary_op(self, other, op, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __neg__(self):
        from paddle_tpu_torch.layers import tensor as ltensor

        return ltensor.scale(self, scale=-1.0)

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "type": int(self.type),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "lod_level": self.lod_level,
            "is_data": self.is_data,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", True),
        }


class Parameter(Variable):
    """A persistable, trainable Variable (reference: framework.py:3597)."""

    def __init__(self, block, name, shape, dtype, **kwargs):
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, name, shape=shape, dtype=dtype, **kwargs)
        self.stop_gradient = not self.trainable


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------
class Operator:
    """An op node: type + named input/output var lists + attrs
    (reference: framework.py:992, framework.proto:105).  The kernel is
    looked up in the Python op registry (``core/registry.py``)."""

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, List[str]]] = None,
        outputs: Optional[Dict[str, List[str]]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: list(_names(v)) for k, v in (inputs or {}).items() if v is not None}
        self.outputs = {k: list(_names(v)) for k, v in (outputs or {}).items() if v is not None}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def _rename_input(self, old, new):
        for ns in self.inputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def _rename_output(self, old, new):
        for ns in self.outputs.values():
            for i, n in enumerate(ns):
                if n == old:
                    ns[i] = new

    def to_dict(self):
        return {
            "type": self.type,
            "inputs": self.inputs,
            "outputs": self.outputs,
            "attrs": _jsonable_attrs(self.attrs),
        }

    def __repr__(self):
        return "{%s} <- %s(%s)" % (
            ", ".join("%s=%s" % kv for kv in self.outputs.items()),
            self.type,
            ", ".join("%s=%s" % kv for kv in self.inputs.items()),
        )


def _names(v):
    if isinstance(v, (Variable, str)):
        v = [v]
    return [x.name if isinstance(x, Variable) else x for x in v]


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, Block):
            out[k] = {"__block__": v.idx}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
class Block:
    """An ordered op list + var symbol table, possibly nested
    (reference: framework.py:1443, framework.proto:165)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = collections.OrderedDict()
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # --- var management ---
    def create_var(self, name=None, **kwargs) -> Variable:
        if name is None:
            name = unique_name.generate("_generated_var")
        if name in self.vars:
            return self.vars[name]
        var = Variable(self, name, **kwargs)
        self.vars[name] = var
        return var

    def create_parameter(self, name, shape, dtype, **kwargs) -> Parameter:
        param = Parameter(self, name, shape, dtype, **kwargs)
        # parameters live in the outermost (global) block, like the reference
        self.program.global_block().vars[name] = param
        if self is not self.program.global_block():
            self.vars[name] = param
        return param

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("Variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def has_var_local(self, name: str) -> bool:
        return name in self.vars

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # --- op management ---
    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        from paddle_tpu_torch.core import registry

        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for ns in op.outputs.values():
            for n in ns:
                if n in self.vars:
                    self.vars[n].op = op
        registry.infer_shape(op, self)
        return op

    def _insert_op(self, index, type, inputs=None, outputs=None, attrs=None) -> Operator:
        """Insert an op before position ``index`` (the AMP rewrite's casts)."""
        from paddle_tpu_torch.core import registry

        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(index, op)
        registry.infer_shape(op, self)
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        return self._insert_op(0, type, inputs, outputs, attrs)

    def _remove_op(self, index):
        del self.ops[index]

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
class Program:
    """A list of Blocks; block 0 is global (reference: framework.py:2782)."""

    _uid_counter = itertools.count(1)

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.version = 0
        self._op_role = "forward"
        self.random_seed = 0
        self._seed_counter = 0
        self._uid = next(Program._uid_counter)

    # --- block management ---
    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def block(self, idx) -> Block:
        return self.blocks[idx]

    def _create_block(self, parent_idx=None) -> Block:
        """A new block nested in the current one (or in ``parent_idx``),
        made current: the sub-block of a control-flow layer."""
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        return blk

    def _rollback(self):
        """Make the current block's parent current again."""
        self.current_block_idx = self.current_block().parent_idx

    @property
    def num_blocks(self):
        return len(self.blocks)

    def all_parameters(self):
        return self.global_block().all_parameters()

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()

    def next_seed(self) -> int:
        """Deterministic per-op RNG seed derived from program.random_seed
        (the same sequence as the JAX package's ``Program.next_seed``)."""
        self._seed_counter += 1
        return (self.random_seed * 1000003 + self._seed_counter) & 0x7FFFFFFF

    def clone(self, for_test: bool = False) -> "Program":
        """reference: framework.py Program.clone — for_test drops
        backward/optimize ops and switches is_test attrs."""
        p = copy.deepcopy(self)
        if for_test:
            for blk in p.blocks:
                kept = []
                for op in blk.ops:
                    if op.attrs.get("op_role", "forward") in ("backward", "optimize"):
                        continue
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    kept.append(op)
                blk.ops = kept
        p.version += 1
        p._uid = next(Program._uid_counter)
        return p

    # --- serialization (the reference's ProgramDesc protobuf round-trip,
    # framework.proto:184; here the JSON encoding the JAX package writes) ---
    def to_json(self) -> str:
        payload = {
            "version": 1,
            "random_seed": self.random_seed,
            "blocks": [b.to_dict() for b in self.blocks],
        }
        # distributed lookup-table metadata (layers.embedding
        # is_distributed=True) survives serde, as in the JAX package: a
        # loaded program can still prefetch and push
        dist = getattr(self, "_distributed_tables", None)
        if dist:
            payload["distributed_tables"] = dist
        return json.dumps(payload)

    @staticmethod
    def from_json(text: str) -> "Program":
        data = json.loads(text)
        prog = Program()
        prog.random_seed = data.get("random_seed", 0)
        if data.get("distributed_tables"):
            prog._distributed_tables = data["distributed_tables"]
        prog.blocks = []
        for bd in data["blocks"]:
            prog.blocks.append(Block(prog, bd["idx"], bd["parent_idx"]))
        for bd, blk in zip(data["blocks"], prog.blocks):
            for vd in bd["vars"]:
                vd = dict(vd)
                cls = Parameter if vd.pop("is_parameter", False) else Variable
                trainable = vd.pop("trainable", True)
                name = vd.pop("name")
                shape = vd.pop("shape")
                if cls is Parameter:
                    v = Parameter(blk, name, shape, vd.pop("dtype"), trainable=trainable, **vd)
                else:
                    v = Variable(blk, name, shape=shape, **vd)
                blk.vars[name] = v
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    elif isinstance(v, dict) and "__block__" in v:
                        attrs[k] = prog.blocks[v["__block__"]]
                    else:
                        attrs[k] = v
                blk.ops.append(Operator(blk, od["type"], od["inputs"], od["outputs"], attrs))
        return prog

    def __repr__(self):
        lines = []
        for blk in self.blocks:
            lines.append("-- block %d (parent %d) --" % (blk.idx, blk.parent_idx))
            for v in blk.vars.values():
                lines.append("  " + repr(v))
            for op in blk.ops:
                lines.append("  " + repr(op))
        return "\n".join(lines)

    __str__ = __repr__


# ---------------------------------------------------------------------------
# Default program singletons & guards (reference: framework.py:3692-3725)
# ---------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(program: Program) -> Program:
    global _main_program_
    prev, _main_program_ = _main_program_, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program_
    prev, _startup_program_ = _startup_program_, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)


@contextlib.contextmanager
def name_scope(prefix: str):
    with unique_name.guard_prefix(prefix):
        yield


@contextlib.contextmanager
def op_role_guard(program: Program, role: str):
    """``program._op_role`` set to ``role`` inside the block."""
    prev = program._op_role
    program._op_role = role
    try:
        yield
    finally:
        program._op_role = prev
