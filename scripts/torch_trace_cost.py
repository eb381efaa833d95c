"""The cost of the port's tracing on steps of a benchmark cell, three ways.

    python3 scripts/torch_trace_cost.py --workload credits.transfer_private_b8 --steps 2

Sets the cell up as `python3 -m proofbench.run` does (the cell's set-up,
one warm step), then runs `--steps` rounds of three steps, one each way, in
turns: untraced; with the stage timers and counters on (`profiling.enable()`,
what ALEO_TORCH_PROFILE=1 sets); and under `profiling.trace()`, which writes
a torch.profiler trace file into ALEO_TORCH_TRACE_DIR (a temporary directory,
removed at the end, where the variable is unset). Prints one JSON line: each
way's step seconds, the card, and the ranges of the first trace file by
name (calls and seconds) among the program's stages, as an operator reading
that file would find them. Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ranges(path: str) -> dict:
    """The trace file's named ranges on the host (the program's stages are
    `cpu_op` events, the benchmark's marks `user_annotation` ones): calls
    and seconds by name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = defaultdict(lambda: {"calls": 0, "seconds": 0.0})
    for ev in events:
        if ev.get("cat") in ("cpu_op", "user_annotation") and ev.get("ph") == "X":
            out[ev["name"]]["calls"] += 1
            out[ev["name"]]["seconds"] += ev.get("dur", 0) / 1e6
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=3900000001)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch

    from proofbench import checks, run

    if not torch.cuda.is_available():
        sys.stderr.write("torch_trace_cost: runs on a CUDA card only\n")
        return 1
    from aleo_tpu_torch import _build
    from aleo_tpu_torch.utils import profiling

    run._pin_caches()
    device = torch.device("cuda")
    r = run.resolve(run.load_bench(), args.workload)
    drv = r["driver"].Driver(r["config"], r["traffic"], args.seed, device, checks.Spans())
    _build.library()
    drv.setup()
    drv.step(-1)
    torch.cuda.synchronize()

    own_dir = "ALEO_TORCH_TRACE_DIR" not in os.environ
    trace_dir = os.environ.get("ALEO_TORCH_TRACE_DIR") or tempfile.mkdtemp()
    os.environ["ALEO_TORCH_TRACE_DIR"] = trace_dir

    def untraced(i):
        drv.step(i)

    def timers(i):
        profiling.enable(True)
        try:
            drv.step(i)
        finally:
            profiling.enable(False)

    def traced(i):
        with profiling.trace():
            drv.step(i)

    ways = {"untraced": untraced, "timers": timers, "trace_file": traced}
    seconds = {name: [] for name in ways}
    index = 0
    try:
        for _ in range(args.steps):
            for name, way in ways.items():
                t0 = time.perf_counter()
                way(index)
                torch.cuda.synchronize()
                seconds[name].append(time.perf_counter() - t0)
                index += 1
        files = sorted(glob.glob(os.path.join(trace_dir, "*.pt.trace.json")),
                       key=os.path.getmtime)
        ranges = _ranges(files[0]) if files else {}
        size = os.path.getsize(files[0]) if files else 0
    finally:
        if own_dir:
            shutil.rmtree(trace_dir, ignore_errors=True)
    stages = {k: v for k, v in ranges.items() if "/" in k and not k.startswith("pb:")}
    print(json.dumps({"workload": args.workload, "card": run.card_line(), "seconds": seconds,
                      "trace_files": len(files), "trace_file_bytes": size,
                      "trace_stages": stages, "k": r["traffic"].get("k", 1)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
