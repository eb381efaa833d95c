"""What a run compares, and the benchmark's own spans.

A `Check` is one number compared with its limit: the run is correct when no
number passes its limit. `Spans` times the benchmark's calls into the program
on the host clock (each span's seconds summed by name); under the profiler
each span is also a marked range of the trace.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

from .trace import MARK


@dataclass
class Check:
    name: str
    value: float
    limit: float
    note: str = ""
    attempted: int | None = None

    @property
    def holds(self) -> bool:
        return self.value <= self.limit


class Spans:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self.marked = False

    def reset(self) -> None:
        self.seconds.clear()
        self.calls.clear()

    @contextlib.contextmanager
    def span(self, name: str):
        mark = (torch.profiler.record_function(MARK + name) if self.marked
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
