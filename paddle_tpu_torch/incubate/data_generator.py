"""User-side MultiSlot record emitters (reference:
python/paddle/fluid/incubate/data_generator/__init__.py — generators
that serialize training samples into the Dataset pipeline's slot text /
proto format consumed by data_feed.cc; here by native/recordio.cc's
multislot parser and fluid_dataset.py).

Usage (reference contract)::

    class MyGen(MultiSlotDataGenerator):
        def generate_sample(self, line):
            def reader():
                ids, label = parse(line)
                yield [("ids", ids), ("label", [label])]
            return reader

    gen = MyGen()
    gen.set_batch(16)
    gen.run_from_stdin()          # or run_from_memory() / lines
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional, Tuple

__all__ = ["DataGenerator", "MultiSlotDataGenerator", "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._batch = 1
        self._proto_info = None

    def set_batch(self, batch: int):
        self._batch = int(batch)

    # --- user hooks ---
    def generate_sample(self, line):
        """Return a callable yielding [(slot_name, [values...]), ...]."""
        raise NotImplementedError

    def generate_batch(self, samples):
        """Optional batch-level hook; default passes samples through."""

        def reader():
            for s in samples:
                yield s

        return reader

    # --- runners ---
    def _emit(self, sample, out) -> None:
        raise NotImplementedError

    def run_from_stdin(self):
        self._run(sys.stdin, sys.stdout)

    def run_from_memory(self, lines: Iterable[str], out=None):
        out = out or sys.stdout
        self._run(lines, out)
        return out

    def _run(self, lines, out):
        batch: List = []
        for line in lines:
            gen = self.generate_sample(line)
            for sample in gen():
                batch.append(sample)
                if len(batch) >= self._batch:
                    for s in self.generate_batch(batch)():
                        self._emit(s, out)
                    batch = []
        if batch:
            for s in self.generate_batch(batch)():
                self._emit(s, out)


class MultiSlotDataGenerator(DataGenerator):
    """Emits ``<count> <v0> <v1> ...`` per slot per line — the exact text
    format native/recordio.cc multislot_parse and the reference's
    MultiSlotDataFeed consume."""

    def _emit(self, sample: List[Tuple[str, List]], out) -> None:
        parts = []
        for _name, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        out.write(" ".join(parts) + "\n")


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """Same wire format; values passed through as raw strings."""
