"""Stage timers and throughput counters.

  * `stage(name)`: context manager accumulating wall-clock per named stage
    (the prover annotates its rounds, the MSM pipeline its phases). When a
    CUDA device is in use the stage synchronises before it starts and
    before it stops the clock, so the time is the device's work and not the
    enqueue. While a torch profiler is recording (`trace()`, or any other)
    the stage is also a range of that name on the host's timeline, timers
    on or off, so a trace shows the stages beside the kernels they launch.
  * `counter(name, n)`: accumulate a count (the MSM's lane rounds and
    adds).
  * `report()` / `reset()`: snapshot and clear.
  * `trace(log_dir)`: a `torch.profiler` trace of the block (Chrome /
    TensorBoard JSON) written into `log_dir` or ALEO_TORCH_TRACE_DIR; does
    nothing when neither is set.

Enabled when ALEO_TORCH_PROFILE=1 or after `enable()`; near-zero overhead
when disabled and no profiler records (the context manager short-circuits
after one flag check, and nothing synchronises). Callers reach `stage` and
`counter` through the module at call time (`prof.stage(...)`), so a
wrapper set on the module sees every stage.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict

import torch

_enabled = os.environ.get("ALEO_TORCH_PROFILE", "") not in ("", "0")
_lock = threading.Lock()
_times: Dict[str, float] = defaultdict(float)
_calls: Dict[str, int] = defaultdict(int)
_counts: Dict[str, float] = defaultdict(float)


def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def stage(name: str):
    marked = torch.autograd._profiler_enabled()
    if not (_enabled or marked):
        yield
        return
    # an operator-kind range (`cpu_op`), not `record_function`'s user
    # annotation: the profiler mirrors each user annotation onto the device's
    # timeline as a span over its kernels, which readers of the trace would
    # take for device work
    with torch._C._profiler._RecordFunctionFast(name) if marked else contextlib.nullcontext():
        if not _enabled:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            with _lock:
                _times[name] += dt
                _calls[name] += 1


def counter(name: str, n: float) -> None:
    if not _enabled:
        return
    with _lock:
        _counts[name] += n


def report() -> Dict[str, dict]:
    with _lock:
        out = {}
        for name, t in sorted(_times.items(), key=lambda kv: -kv[1]):
            out[name] = {"seconds": round(t, 4), "calls": _calls[name]}
        for name, n in _counts.items():
            out[f"count/{name}"] = {"total": n}
        return out


def reset() -> None:
    with _lock:
        _times.clear()
        _calls.clear()
        _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profiler trace of the block, every activity this build of torch can
    record (the CPU's, and the card's where there is one), written on exit
    as `<worker>.<time>.pt.trace.json` into `log_dir` or
    ALEO_TORCH_TRACE_DIR."""
    log_dir = log_dir or os.environ.get("ALEO_TORCH_TRACE_DIR")
    if not log_dir:
        yield
        return
    from torch import profiler

    with profiler.profile(activities=profiler.supported_activities(),
                          on_trace_ready=profiler.tensorboard_trace_handler(log_dir)):
        yield
