"""Runtime flag registry (reference: the gflags tier,
paddle/fluid/platform/init.cc InitGflags and python/paddle/fluid/
__init__.py __bootstrap__'s read_env_flags list).

The port's own copy of the JAX package's ``flags.py``: the same flags,
defaults and resolution order (a ``set_flags`` override, then a
``FLAGS_*`` environment variable, then the default).  ``set_flags``
mirrors each value into ``os.environ``, as the JAX package does, so a
process that reads the environment agrees.  Only
``FLAGS_check_nan_inf`` changes what the port does (``executor.py``
``Executor.run``); the others are accepted so that a program which sets
them runs, and their documentation says what they map to here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["DEFINE_flag", "get_flags", "set_flags", "flag_doc"]

_REGISTRY: Dict[str, dict] = {}
_OVERRIDES: Dict[str, Any] = {}


def DEFINE_flag(name: str, default, doc: str, mapping: str = ""):
    """Register a flag (the gflags DEFINE_* analog)."""
    _REGISTRY[name] = {"default": default, "doc": doc, "mapping": mapping,
                       "type": type(default)}


def _key(name: str) -> str:
    return name if name.startswith("FLAGS_") else "FLAGS_" + name


def _coerce(value, ty):
    if ty is bool:
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes")
        return bool(value)
    return ty(value)


def get_flags(names):
    """Resolve flags: set_flags() override > FLAGS_* env > default.
    Accepts one name or a list; returns {name: value}."""
    single = isinstance(names, str)
    out = {}
    for name in [names] if single else names:
        key = _key(name)
        if key not in _REGISTRY:
            raise KeyError("unknown flag %r (known: %s)" % (key, sorted(_REGISTRY)))
        spec = _REGISTRY[key]
        if key in _OVERRIDES:
            out[key] = _OVERRIDES[key]
        elif key in os.environ:
            out[key] = _coerce(os.environ[key], spec["type"])
        else:
            out[key] = spec["default"]
    return out


def set_flags(flags: Dict[str, Any]):
    """Programmatic override (reference: fluid.set_flags).  Also mirrors
    into the environment so point-of-use os.environ reads agree."""
    for name, value in flags.items():
        key = _key(name)
        if key not in _REGISTRY:
            raise KeyError("unknown flag %r" % key)
        spec = _REGISTRY[key]
        _OVERRIDES[key] = _coerce(value, spec["type"])
        if spec["type"] is bool:
            os.environ[key] = "1" if _OVERRIDES[key] else "0"
        else:
            os.environ[key] = str(_OVERRIDES[key])


def flag_doc(name: str) -> str:
    spec = _REGISTRY[_key(name)]
    extra = (" [maps to: %s]" % spec["mapping"]) if spec["mapping"] else ""
    return "%s (default %r)%s" % (spec["doc"], spec["default"], extra)


# ---------------------------------------------------------------------------
# the registry (reference list: python/paddle/fluid/__init__.py
# __bootstrap__ read_env_flags + gpu-only tail)
# ---------------------------------------------------------------------------
DEFINE_flag("FLAGS_check_nan_inf", False,
            "check every fetched and written floating tensor for nan/inf "
            "after the step, outside the captured graph, and raise naming "
            "them (one host sync a run)",
            "executor.py Executor.run")
DEFINE_flag("FLAGS_allow_place_fallback", False,
            "fall back to the CPU when the requested device is "
            "unavailable; the port never falls back (accepted, inert)",
            "framework.py device_of raises")
DEFINE_flag("FLAGS_fraction_of_gpu_memory_to_use", 0.9,
            "fraction of device memory the process may claim; PyTorch's "
            "caching allocator grows on demand (accepted, inert)")
DEFINE_flag("FLAGS_eager_delete_tensor_gb", 0.0,
            "reference GC threshold; the interpreter drops each value "
            "after its last reader (accepted, inert)",
            "core/lowering.py _dead_after")
DEFINE_flag("FLAGS_allocator_strategy", "auto_growth",
            "reference allocator choice; PyTorch's caching allocator is "
            "the only allocator here (accepted, inert)")
DEFINE_flag("FLAGS_cudnn_deterministic", True,
            "deterministic kernels (accepted, inert: the caller sets "
            "torch.backends.cudnn.deterministic)")
DEFINE_flag("FLAGS_benchmark", False,
            "reference per-op benchmark mode; use torch.profiler "
            "(accepted, inert)")
DEFINE_flag("FLAGS_use_mkldnn", False,
            "reference CPU fastpath (accepted, inert)")
DEFINE_flag("FLAGS_paddle_num_threads", 1,
            "reference CPU op threads (accepted, inert)")
DEFINE_flag("FLAGS_init_allocated_mem", False,
            "poison fresh allocations (accepted, inert)")
DEFINE_flag("FLAGS_limit_of_tmp_allocation", -1,
            "reference temp-allocator cap (accepted, inert)")
DEFINE_flag("FLAGS_rpc_deadline", 180000,
            "PS RPC deadline in ms; the port has no parameter server yet "
            "(accepted, inert)")
DEFINE_flag("FLAGS_rpc_retry_times", 3,
            "PS send retries; the port has no parameter server yet "
            "(accepted, inert)")
