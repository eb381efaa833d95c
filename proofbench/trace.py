"""One step under torch.profiler, read in memory (no trace file is written).

While the step runs, the program's `profiling.stage` names (`prove_batch/*`,
`kzg/commit`, ...) and the benchmark's own spans are marked in the trace as
`record_function` ranges, and the lanes of every launch of the five
batch-affine kernels are noted. The reading gives the device's operations
(kernels, copies, fills) with their times, the union of the intervals in
which the device was busy, and the idle gaps between them with the innermost
range the host was in when each began.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

from . import roofline

MARK = "pb:"


@dataclass
class Trace:
    window_s: float = 0.0
    kernels: List[Tuple[str, int, int]] = field(default_factory=list)    # name, start, end (ns)
    device_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    ranges: List[Tuple[str, int, int]] = field(default_factory=list)
    lanes: Dict[str, List[int]] = field(default_factory=lambda: defaultdict(list))

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device's operations as disjoint intervals."""
        out: List[List[int]] = []
        for _, s, e in sorted(self.device_ops, key=lambda t: t[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.kernels:
            out[name] += (e - s) / 1e9
        return dict(out)

    def idle_by_range(self) -> Dict[str, float]:
        """Seconds between device operations, by the innermost marked range
        that was open when each gap began ("outside" where none was)."""
        spans = self.busy()
        out: Dict[str, float] = defaultdict(float)
        ranges = sorted(self.ranges, key=lambda r: r[1])
        ri, open_ = 0, []          # the ranges nest: the last opened is innermost
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            while ri < len(ranges) and ranges[ri][1] <= e0:
                while open_ and open_[-1][2] < ranges[ri][1]:
                    open_.pop()
                open_.append(ranges[ri])
                ri += 1
            while open_ and open_[-1][2] < e0:
                open_.pop()
            out[open_[-1][0] if open_ else "outside"] += (s1 - e0) / 1e9
        return dict(out)


def short_name(name: str) -> str:
    """A kernel's function name without its argument list or template."""
    return name.split("(")[0].split("<")[0].removeprefix("void ").strip()


@contextlib.contextmanager
def _marked_stages():
    """profiling.stage also opens a marked range (the stage keeps its own
    behaviour: nothing synchronises while profiling is off)."""
    from aleo_tpu_torch.utils import profiling

    original = profiling.stage

    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(MARK + name), original(name):
            yield

    profiling.stage = stage
    try:
        yield
    finally:
        profiling.stage = original


@contextlib.contextmanager
def _noted_lanes(lanes: Dict[str, List[int]]):
    """Note the lanes of each launch of the five batch-affine kernels."""
    from aleo_tpu_torch.curves import g1_affine as ga

    saved = {name: getattr(ga, name) for name in roofline.KERNELS}

    def noting(name, fn):
        def call(first, *rest):
            lanes[name].append(int(first.shape[1]))
            return fn(first, *rest)
        return call

    for name, fn in saved.items():
        setattr(ga, name, noting(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ga, name, fn)


def capture(step) -> Trace:
    """Run `step()` once under the profiler (the CPU's activity, and the
    card's where there is one)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    tr = Trace()
    with _marked_stages(), _noted_lanes(tr.lanes), profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        tr.window_s = time.perf_counter() - t0
    for ev in prof.profiler.kineto_results.events():
        s, e = ev.start_ns(), ev.end_ns()
        if ev.name().startswith(MARK):
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                tr.ranges.append((ev.name()[len(MARK):], s, e))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            name = ev.name()
            tr.device_ops.append((name, s, e))
            if not name.startswith(("Memcpy", "Memset")):
                tr.kernels.append((short_name(name), s, e))
    return tr
