"""Unique name generator (reference: python/paddle/fluid/unique_name.py).

The port's own copy of the JAX package's ``unique_name.py``: the same key
scheme, so the same layer calls in both packages name their variables
and parameters alike (the desc-parity tests rely on it).
"""
from __future__ import annotations

import collections
import contextlib

__all__ = ["generate", "guard", "guard_prefix", "switch"]


class UniqueNameGenerator:
    def __init__(self):
        self.ids = collections.defaultdict(int)
        self.prefix = ""

    def __call__(self, key: str) -> str:
        key = self.prefix + key
        i = self.ids[key]
        self.ids[key] += 1
        return "%s_%d" % (key, i)


_generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return _generator(key)


def switch(new_generator=None):
    global _generator
    prev = _generator
    _generator = new_generator or UniqueNameGenerator()
    return prev


@contextlib.contextmanager
def guard(new_generator=None):
    prev = switch(new_generator)
    try:
        yield
    finally:
        switch(prev)


@contextlib.contextmanager
def guard_prefix(prefix: str):
    old = _generator.prefix
    _generator.prefix = _generator.prefix + prefix + "/"
    try:
        yield
    finally:
        _generator.prefix = old
