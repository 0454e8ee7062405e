"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel's wrapper lives in a module here, beside the plain PyTorch
version of the same function.  A wrapper sends a CPU tensor to the plain
version, gives a meta tensor a shape-only result, and on a CUDA tensor
launches its kernel or raises.  It adds one to its launch count where
it launches, and nowhere else, so a run can show that it went through
the kernel: ``reset_launch_counts()`` before it, ``launch_counts()``
after it.  Counts are kept by kernel and by the type the kernel ran in
(``launch_counts_by_dtype()``).

Under a CUDA graph the launches happen at replay, not where the wrapper
ran.  So while the executor captures a step on its capture stream
(``recording(stream)``), a wrapper's launch on that stream is recorded
in the capture's own tally and not counted; each replay of the graph
then adds that tally (``add_launches``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

__all__ = ["add_launches", "count_launch", "launch_counts", "launch_counts_by_dtype",
           "recording", "reset_launch_counts"]

_lock = threading.Lock()
_counts: Dict[Tuple[str, str], int] = {}  # (kernel, dtype) -> launches
_recorders: Dict[int, Dict[Tuple[str, str], int]] = {}  # capture stream handle -> tally


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def count_launch(name: str, dtype=None, stream: Optional[int] = None) -> None:
    """One launch of kernel ``name`` in ``dtype`` on the CUDA stream whose
    handle is ``stream``; recorded instead when that stream is capturing
    for the executor."""
    key = (name, _dtype_name(dtype))
    with _lock:
        tally = _recorders.get(stream) if stream is not None else None
        if tally is None:
            tally = _counts
        tally[key] = tally.get(key, 0) + 1


@contextlib.contextmanager
def recording(stream: int):
    """Record, in the dict this yields, the launches made on the stream
    with handle ``stream`` (a graph capture's) instead of counting them."""
    tally: Dict[Tuple[str, str], int] = {}
    with _lock:
        if stream in _recorders:
            raise RuntimeError("stream %#x is already recording launches" % stream)
        _recorders[stream] = tally
    try:
        yield tally
    finally:
        with _lock:
            del _recorders[stream]


def add_launches(tally: Dict[Tuple[str, str], int], times: int = 1) -> None:
    """Count the launches of ``times`` replays of a captured ``tally``."""
    with _lock:
        for key, n in tally.items():
            _counts[key] = _counts.get(key, 0) + n * times


def launch_counts() -> Dict[str, int]:
    """{kernel: launches} since the last reset."""
    out: Dict[str, int] = {}
    with _lock:
        for (name, _), n in _counts.items():
            out[name] = out.get(name, 0) + n
    return out


def launch_counts_by_dtype() -> Dict[str, Dict[str, int]]:
    """{kernel: {dtype: launches}} since the last reset."""
    out: Dict[str, Dict[str, int]] = {}
    with _lock:
        for (name, dtype), n in _counts.items():
            out.setdefault(name, {})[dtype] = n
    return out


def reset_launch_counts() -> None:
    with _lock:
        _counts.clear()
