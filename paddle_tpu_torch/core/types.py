"""Var/data type enums and the dtype bridge to ``torch``
(reference: paddle/fluid/framework/framework.proto:105-160).

Dtypes are carried through the Program as canonical numpy-style names
(``"float32"``, ``"int64"``, ``"bfloat16"``...).  The port keeps
``int64`` and ``bfloat16`` as they are.  A model saved by the JAX
package may say ``int32`` where the port says ``int64`` (that package
runs with 64-bit types off); both names load, and each maps to its own
torch dtype.
"""
from __future__ import annotations

import numpy as np
import torch


class VarType:
    LOD_TENSOR = 7
    SELECTED_ROWS = 8
    FEED_MINIBATCH = 9
    FETCH_LIST = 10
    STEP_SCOPES = 11
    LOD_RANK_TABLE = 12
    LOD_TENSOR_ARRAY = 13
    READER = 15
    RAW = 17


_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float": "float32",
    "float64": "float64",
    "fp64": "float64",
    "double": "float64",
    "float16": "float16",
    "fp16": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int": "int32",
    "int64": "int64",
    "bool": "bool",
}

# serving precision-variant labels (the bf16 / int8 variants and the fp32
# base program): one alias map shared by AnalysisPredictor's dispatch,
# InferenceServer.submit's validation and the mixed-precision export, so
# a dtype that submit admits is one the predictor serves.  These
# canonicalize to the short variant labels ("bf16"), not dtype names.
PRECISION_ALIASES = {
    "bf16": "bf16", "bfloat16": "bf16",
    "int8": "int8",
    "fp32": "fp32", "float32": "fp32",
}

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def canonical_dtype(dtype) -> str:
    """Canonical dtype name for a string alias, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return _NAMES[dtype]
    if isinstance(dtype, str):
        key = dtype.lower()
        if key in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[key]
    return str(np.dtype(dtype))


def torch_dtype(dtype) -> torch.dtype:
    return _TORCH_DTYPES[canonical_dtype(dtype)]


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype a host array of this var has.  numpy has no
    bfloat16, so bfloat16 vars cross the host boundary as float32."""
    d = canonical_dtype(dtype)
    return np.dtype("float32" if d == "bfloat16" else d)


def is_float_dtype(dtype) -> bool:
    return canonical_dtype(dtype) in ("float16", "bfloat16", "float32", "float64")
