"""Device-memory observability (reference: paddle/fluid/memory/ —
AllocatorFacade stats, allocation/allocator_facade.h:32, and the
FLAGS_fraction_of_gpu_memory_to_use family, platform/gpu_info.cc).

Port of the JAX package's ``memory.py``.  On the card, allocation
belongs to PyTorch's caching allocator, so the framework surface is
OBSERVABILITY plus the pre-allocation knob it exposes:

* ``device_memory_stats()`` — the caching allocator's per-device stats
  (bytes in use, peak, limit, live allocations), under the JAX
  package's keys — the ``memory::StatGetCurrentValue`` analog.  On the
  CPU the values are None, as the JAX package reports there.
* ``FLAGS_fraction_of_gpu_memory_to_use`` (or ``FLAGS_tpu_memory_fraction``)
  in the environment caps each card's share of its memory
  (``torch.cuda.set_per_process_memory_fraction``) when an executor is
  built on the card, or the stats are first read there.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

__all__ = ["device_memory_stats", "memory_summary", "apply_memory_fraction"]

_fraction_applied = set()


def _fraction() -> Optional[float]:
    frac = (os.environ.get("FLAGS_fraction_of_gpu_memory_to_use")
            or os.environ.get("FLAGS_tpu_memory_fraction"))
    return float(frac) if frac else None


def apply_memory_fraction(device=None) -> Optional[float]:
    """Cap ``device``'s (default: every card's) share of its memory at the
    environment's fraction, once per card; returns the fraction applied
    (None when the variable is unset or there is no card)."""
    import torch

    frac = _fraction()
    if frac is None or not torch.cuda.is_available():
        return None
    indices = ([torch.device(device).index or 0] if device is not None
               else range(torch.cuda.device_count()))
    for i in indices:
        if i not in _fraction_applied:
            torch.cuda.set_per_process_memory_fraction(frac, i)
            _fraction_applied.add(i)
    return frac


def device_memory_stats(device=None) -> List[Dict[str, Optional[int]]]:
    """Per-device memory stats from the caching allocator.  Returns a
    list of dicts with ``device``, ``platform``, ``bytes_in_use``
    (``memory_allocated``), ``peak_bytes_in_use``
    (``max_memory_allocated``), ``bytes_limit`` (the card's total memory)
    and ``num_allocs`` (live allocations); None where the platform
    doesn't report — the CPU."""
    import torch

    if device is not None:
        devices = [torch.device(device)]
    elif torch.cuda.is_available():
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    out = []
    for d in devices:
        row = {"device": str(d), "platform": "gpu" if d.type == "cuda" else d.type,
               "bytes_in_use": None, "peak_bytes_in_use": None, "bytes_limit": None,
               "num_allocs": None}
        if d.type == "cuda":
            apply_memory_fraction(d)
            stats = torch.cuda.memory_stats(d)
            row.update(bytes_in_use=int(torch.cuda.memory_allocated(d)),
                       peak_bytes_in_use=int(torch.cuda.max_memory_allocated(d)),
                       bytes_limit=int(torch.cuda.get_device_properties(d).total_memory),
                       num_allocs=int(stats.get("allocation.all.current", 0)))
        out.append(row)
    return out


def memory_summary(device=None) -> str:
    """Human-readable per-device memory table (lodtensor_printer-style
    debug aid)."""
    rows = device_memory_stats(device)
    lines = ["%-28s %14s %14s %14s" % ("device", "in_use", "peak", "limit")]

    def fmt(v):
        if v is None:
            return "-"
        return "%.1fMB" % (v / (1 << 20))

    for r in rows:
        lines.append(
            "%-28s %14s %14s %14s"
            % (r["device"], fmt(r["bytes_in_use"]), fmt(r["peak_bytes_in_use"]), fmt(r["bytes_limit"]))
        )
    return "\n".join(lines)
