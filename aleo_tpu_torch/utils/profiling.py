"""Stage timers and throughput counters.

  * `stage(name)`: context manager accumulating wall-clock per named stage
    (the prover annotates its rounds). When a CUDA device is in use the
    stage synchronises before it starts and before it stops the clock, so
    the time is the device's work and not the enqueue.
  * `counter(name, n)`: accumulate a throughput numerator (points,
    constraints).
  * `report()` / `reset()`: snapshot and clear.
  * `trace(log_dir)`: a `torch.profiler` trace of the block (Chrome /
    TensorBoard JSON) written into `log_dir` or ALEO_TORCH_TRACE_DIR; does
    nothing when neither is set.

Enabled when ALEO_TORCH_PROFILE=1 or after `enable()`; near-zero overhead
when disabled (the context manager short-circuits, and nothing
synchronises).
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
