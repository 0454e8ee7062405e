"""LayerHelper: shared param-creation/op-append machinery for layers.

Port of the JAX package's ``layer_helper.py`` (reference:
python/paddle/fluid/layer_helper.py:42).  Creates Parameters in the
startup+main programs (with initializer ops in startup) and appends
compute ops to the main program.
"""
from __future__ import annotations

import copy

from paddle_tpu_torch import framework, initializer, unique_name
from paddle_tpu_torch.core import types as core_types
from paddle_tpu_torch.param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self) -> framework.Program:
        return framework.default_main_program()

    @property
    def startup_program(self) -> framework.Program:
        return framework.default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=core_types.canonical_dtype(dtype),
            stop_gradient=stop_gradient,
        )

    def create_parameter(self, attr, shape, dtype, is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        attr = copy.deepcopy(attr)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "b" if is_bias else "w"]))
        if attr.initializer is None:
            if default_initializer is not None:
                attr.initializer = default_initializer
            elif is_bias:
                attr.initializer = initializer.Constant(0.0)
            else:
                attr.initializer = initializer.Xavier()
        shape = [int(s) for s in shape]
        dtype = core_types.canonical_dtype(dtype)
        kwargs = {k: v for k, v in attr._to_kwargs().items() if k != "name"}
        param = self.main_program.global_block().create_parameter(attr.name, shape, dtype, **kwargs)
        # mirror in the startup program with its initializer op
        startup_block = self.startup_program.global_block()
        sparam = startup_block.create_parameter(attr.name, shape, dtype, **kwargs)
        attr.initializer(sparam, startup_block)
        return param

    def set_variable_initializer(self, var, init):
        """Create ``var`` in the startup program and initialize it there."""
        startup_block = self.startup_program.global_block()
        svar = startup_block.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
        )
        init(svar, startup_block)
        return var

    @property
    def bias_attr(self):
        return self.kwargs.get("bias_attr")

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act_type, inputs={"X": [input_var]}, outputs={"Out": [tmp]}, attrs=act)
        return tmp
