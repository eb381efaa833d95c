"""The readings behind the limits: a cell's sound runs, its control and the
planted faults, on several seeds, at the cell's own size, in one process.

    python3 -m proofbench.control --workload <cell> --seeds 1 2 3 [--steps 2]
        [--modes sound,control,stale,half,altered]

For each seed and mode it sets the driver up, warms it with one step, runs
`--steps` steps as a window does and compares every output with the plain
reference; each reading is one JSON line. The benchmark's own runs never run
this. It needs the card; `device="cpu"` is for the tests.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import faults, run
from .checks import Spans


def reading(bench, cell: str, seed: int, mode: str, steps: int, device) -> dict:
    import contextlib

    r = run.resolve(bench, cell)
    unit = r["driver"].UNIT
    drv = r["driver"].Driver(r["config"], r["traffic"], seed, device, Spans())
    if mode == "control":
        drv.fault = faults.CONTROLS[unit]
    plant = (faults.planted(mode, unit) if mode in faults.WRAPS[unit]
             else contextlib.nullcontext())
    t0 = time.perf_counter()
    drv.setup()
    with plant:
        for i in range(-1, steps):
            drv.step(i)
    drv.free()
    checks = drv.judge()
    return {"workload": cell, "seed": seed, "mode": mode, "steps": steps,
            "seconds": time.perf_counter() - t0,
            "correct": all(c.holds for c in checks),
            "checks": {c.name: {"value": c.value, "limit": c.limit, "note": c.note}
                       for c in checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--modes", default="sound,control")
    args = ap.parse_args(argv)
    run._pin_caches()
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("proofbench.control: runs on a CUDA card only\n")
        return 1
    bench = run.load_bench()
    for seed in args.seeds:
        for mode in args.modes.split(","):
            print(json.dumps(reading(bench, args.workload, seed, mode, args.steps,
                                     torch.device("cuda"))), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
