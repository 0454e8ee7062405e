"""Native (C++) runtime components, loaded via ctypes.

The port's own copy of the JAX package's ``native/`` RecordIO and
MultiSlot half (reference: paddle/fluid/recordio/, chunked CRC'd record
files, and the MultiSlot parsing hot path of
paddle/fluid/framework/data_feed.cc).  ``recordio.cc`` is the same
source; it builds on first use with ``g++`` into
``paddle_tpu_torch/_build/`` (the file name carries a hash of the source,
so an edited source builds anew), never into a directory another package
shares.  Where ``g++`` or zlib is missing a Python fallback keeps the API
working: the same MultiSlot results (a test holds the two parsers equal),
and RecordIO files in a framed format of its own that only the fallback
reads.  ``native_available()`` says which one runs.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["RecordIOWriter", "RecordIOScanner", "parse_multislot", "native_available"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recordio.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, "libpaddle_tpu_torch_native-%s.so" % h.hexdigest()[:12])


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so_path = _so_path()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = "%s.%d.tmp" % (so_path, os.getpid())
            try:
                subprocess.run(["g++"] + _CXX_FLAGS + [_SRC, "-o", tmp, "-lz"],
                               check=True, capture_output=True)
            except (OSError, subprocess.CalledProcessError) as e:
                sys.stderr.write(
                    "paddle_tpu_torch.native: build failed (%s); using the Python fallback\n" % e)
                return None
            os.replace(tmp, so_path)  # atomic: a concurrent loader sees all or nothing
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            return None
        lib.recordio_writer_create.restype = ctypes.c_void_p
        lib.recordio_writer_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.recordio_writer_write.restype = ctypes.c_int
        lib.recordio_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.recordio_writer_close.restype = ctypes.c_int
        lib.recordio_writer_close.argtypes = [ctypes.c_void_p]
        lib.recordio_scanner_create.restype = ctypes.c_void_p
        lib.recordio_scanner_create.argtypes = [ctypes.c_char_p]
        lib.recordio_scanner_next.restype = ctypes.POINTER(ctypes.c_char)
        lib.recordio_scanner_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.recordio_scanner_close.restype = None
        lib.recordio_scanner_close.argtypes = [ctypes.c_void_p]
        lib.multislot_parse.restype = ctypes.c_void_p
        lib.multislot_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.multislot_slot_size.restype = ctypes.c_long
        lib.multislot_slot_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.multislot_copy_slot.restype = None
        lib.multislot_copy_slot.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.multislot_free.restype = None
        lib.multislot_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the C++ library built and loaded (else the Python fallback runs)."""
    return _build_and_load() is not None


class RecordIOWriter:
    """reference: recordio/writer.cc."""

    def __init__(self, path: str, compress: bool = True, max_chunk_bytes: int = 1 << 20):
        self._lib = _build_and_load()
        self._path = path
        if self._lib is not None:
            self._h = self._lib.recordio_writer_create(
                path.encode(), int(compress), max_chunk_bytes
            )
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:  # python fallback: naive framed file
            self._f = open(path, "wb")
            self._f.write(b"PYRIO\x00")

    def write(self, record: bytes) -> None:
        if self._lib is not None:
            rc = self._lib.recordio_writer_write(self._h, record, len(record))
            if rc != 0:
                raise IOError("recordio write failed")
        else:
            self._f.write(len(record).to_bytes(4, "little") + record)

    def close(self) -> None:
        if self._lib is not None:
            if self._lib.recordio_writer_close(self._h) != 0:
                raise IOError("recordio flush failed")
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class RecordIOScanner:
    """reference: recordio/scanner.cc."""

    def __init__(self, path: str):
        self._lib = _build_and_load()
        self._path = path
        if self._lib is not None:
            self._h = self._lib.recordio_scanner_create(path.encode())
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:
            self._f = open(path, "rb")
            magic = self._f.read(6)
            if magic != b"PYRIO\x00":
                self._f.close()
                raise IOError("bad recordio file (python-fallback format)")

    def __iter__(self) -> Iterator[bytes]:
        if self._lib is not None:
            n = ctypes.c_int(0)
            while True:
                ptr = self._lib.recordio_scanner_next(self._h, ctypes.byref(n))
                if not ptr:
                    if n.value == -1:
                        raise IOError("corrupt recordio chunk (CRC mismatch)")
                    return
                yield ctypes.string_at(ptr, n.value)
        else:
            while True:
                hdr = self._f.read(4)
                if len(hdr) < 4:
                    return
                ln = int.from_bytes(hdr, "little")
                yield self._f.read(ln)

    def close(self):
        if self._lib is not None:
            self._lib.recordio_scanner_close(self._h)
        else:
            self._f.close()


def parse_multislot(text: bytes, n_slots: int) -> Tuple[int, List[Tuple[np.ndarray, np.ndarray]]]:
    """Parse MultiSlot text (reference data_feed.cc format: per line, per
    slot ``<count> <v0> <v1> ...``).  Returns (n_lines, [(values, counts)]
    per slot)."""
    if isinstance(text, str):
        text = text.encode()
    lib = _build_and_load()
    if lib is not None:
        n_lines = ctypes.c_int(0)
        h = lib.multislot_parse(text, len(text), n_slots, ctypes.byref(n_lines))
        out = []
        try:
            for s in range(n_slots):
                nv = lib.multislot_slot_size(h, s)
                values = np.empty(nv, np.float32)
                counts = np.empty(n_lines.value, np.int32)
                if n_lines.value:
                    lib.multislot_copy_slot(
                        h, s,
                        values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    )
                out.append((values, counts))
        finally:
            lib.multislot_free(h)
        return n_lines.value, out
    return _parse_multislot_py(text, n_slots)


def _parse_multislot_py(text: bytes, n_slots: int):
    """Pure-Python fallback; malformed lines are skipped whole (matching
    the native parser's per-line rollback)."""
    if isinstance(text, str):
        text = text.encode()
    values = [[] for _ in range(n_slots)]
    counts = [[] for _ in range(n_slots)]
    n_lines = 0
    for line in text.decode().splitlines():
        toks = line.split()
        if not toks:
            continue
        pos = 0
        row = []
        ok = True
        for s in range(n_slots):
            if pos >= len(toks):
                ok = False
                break
            try:
                n = int(toks[pos])
                pos += 1
                if n < 0:
                    ok = False
                    break
                vals = [float(t) for t in toks[pos : pos + n]]
            except ValueError:
                ok = False
                break
            if len(vals) != n:
                ok = False
                break
            pos += n
            row.append((n, vals))
        if not ok:
            continue
        n_lines += 1
        for s, (n, vals) in enumerate(row):
            counts[s].append(n)
            values[s].extend(vals)
    return n_lines, [
        (np.asarray(values[s], np.float32), np.asarray(counts[s], np.int32))
        for s in range(n_slots)
    ]
