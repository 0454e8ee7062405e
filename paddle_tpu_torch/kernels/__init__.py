"""Hand-written CUDA kernels of the port and their launch counts.

Each kernel's wrapper lives in a module here, beside the plain PyTorch
version of the same function.  A wrapper sends a CPU tensor to the plain
version, gives a meta tensor a shape-only result, and on a CUDA tensor
launches its kernel or raises.  It adds one to its launch count where
it launches, and nowhere else, so a run can show that it went through
the kernel: ``reset_launch_counts()`` before it, ``launch_counts()``
after it.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["count_launch", "launch_counts", "reset_launch_counts"]

_lock = threading.Lock()
_counts: Dict[str, int] = {}


def count_launch(name: str) -> None:
    with _lock:
        _counts[name] = _counts.get(name, 0) + 1


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _lock:
        _counts.clear()
