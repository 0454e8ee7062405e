"""Build the CUDA sources under ``paddle_tpu_torch/csrc/`` and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, ``paddle_tpu_torch/_build/lib<name>-<hash>.so``
(``<hash>`` is taken over the source and the headers beside it, so an
edited source builds anew), which the kernel's wrapper loads with
``ctypes``.  The build happens at first use, from the sources in the
package only; ``build()`` compiles several sources at once, one ``nvcc``
process each, all started together.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

__all__ = ["NVCC_FLAGS", "build", "load", "sources"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, str]:
    """{kernel library name: source path} for every ``csrc/*.cu``."""
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu")))
    }


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of paddle_tpu_torch build only where the CUDA toolkit is")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [sources()[name]] + sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, h.hexdigest()[:12]))


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, object]]:
    """Compile the named sources (default: all), one ``nvcc`` each, all
    started together.  Returns ``{name: {"path", "seconds", "log"}}``;
    ``log`` is nvcc's output, which carries ptxas' register and
    shared-memory report.  Raises if any compile fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            procs[name] = (out, None, None, time.perf_counter())
            continue
        tmp = "%s.%d.tmp" % (out, os.getpid())
        cmd = [nvcc] + NVCC_FLAGS + ["-o", tmp, srcs[name]]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (out, tmp, p, time.perf_counter())
    result = {}
    failed = []
    for name, (out, tmp, p, t0) in procs.items():
        if p is None:
            result[name] = {"path": out, "seconds": 0.0, "log": "(cached)"}
            continue
        log, _ = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (name, p.returncode, log[-4000:]))
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        result[name] = {"path": out, "seconds": secs, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = _libs[name] = ctypes.CDLL(path)
        return lib
