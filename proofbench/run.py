"""The benchmark of `aleo_tpu_torch` on CUDA cards.

    python3 -m proofbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in the root `BENCHMARK.json`; its
configuration is `proofbench/configs/<config>.json`, its traffic
`proofbench/traffic/<traffic>.json`, which names the driver
(`proofbench/drivers/<driver>.py`) that sets it up and runs one step, and the
end-to-end rate the cell reports (`rate`: the driver's units over the
window); each per-layer metric is read by `proofbench/metrics/<metric>.py`,
or by `<part before the first dot>.py` where one reader serves several cells'
copies of a metric. A run: set-up (the program's kernels built on a cold
checkout, the SRS, the driver's set-up, one step to warm the cell's shapes),
then steps back to back for `--seconds` (the last step that starts in time
runs to its end, and the rate is over all steps and all their time), then
with `--trace 1` one step with the program's stage timers on and one under
torch.profiler; then, with the program's state freed, the comparison with the
plain reference. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "aleo_tpu")


def _process_age() -> float:
    """Seconds since this process started, from the kernel's record (or
    since this module was imported where /proc is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


def _pin_caches() -> None:
    """Every compiler cache inside the checkout, at fixed paths."""
    cache = os.path.join(HERE, "_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def load_bench(path: str | None = None) -> Dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(rel: str) -> Dict:
    with open(rel if os.path.isabs(rel) else os.path.join(ROOT, rel)) as f:
        return json.load(f)


def resolve(bench: Dict, cell: str) -> Dict:
    """The cell's entry, configuration, traffic, driver module and metrics."""
    work = {w["name"]: w for w in bench["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    w = work[cell]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    traffic = _json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    driver = importlib.import_module(f"proofbench.drivers.{traffic['driver']}")

    def applies(m):
        return cell in m.get("workloads", [cell])

    return {
        "cell": w, "config": _json(cfg["file"]), "traffic": traffic, "driver": driver,
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def metric_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location(f"proofbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def run_cell(bench: Dict, cell: str, seed: int, seconds: float, trace: bool, device) -> Dict:
    """Everything after the look for a card: returns the result's fields and
    the checks."""
    import torch

    from aleo_tpu_torch.msm import msm
    from aleo_tpu_torch.snark import batch
    from aleo_tpu_torch.utils import profiling

    from .checks import Spans

    r = resolve(bench, cell)
    spans = Spans()
    drv = r["driver"].Driver(r["config"], r["traffic"], seed, device, spans)
    t_build = time.perf_counter()
    if device.type == "cuda":
        from aleo_tpu_torch import _build

        _build.library()
    info = {"kernels_loaded_s": time.perf_counter() - t_build}
    info.update(drv.setup())
    drv.step(-1)                               # warms every shape of the cell
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # the SRS is the benchmark's input, generated once a checkout and cached:
    # its generation is reported apart; the program's build stays in set-up
    setup_s = _process_age() - info["srs_generated_s"]

    spans.reset()
    rounds0 = msm.ROUNDS["rounds"]
    steps, units, step_s = 0, 0, []
    cpu0, t0 = time.process_time(), time.perf_counter()
    while steps == 0 or time.perf_counter() - t0 < seconds:
        ts = time.perf_counter()
        units += drv.step(steps)
        steps += 1
        step_s.append(time.perf_counter() - ts)
    window_s = time.perf_counter() - t0
    info["window_cpu_s"] = time.process_time() - cpu0
    info["step_s"] = step_s
    ctx = {
        "steps": steps, "units": units, "window_s": window_s, "spans": dict(spans.seconds),
        "span_calls": dict(spans.calls), "k": r["traffic"].get("k", 1),
        "rounds": msm.ROUNDS["rounds"] - rounds0, "untraced_step_s": step_s[-1],
    }
    if trace:
        profiling.reset()
        profiling.enable(True)
        batch.reset_ntt_calls()
        try:
            drv.step(steps)
        finally:
            profiling.enable(False)
        ctx["stages"] = profiling.report()
        ctx["ntt_calls"] = dict(batch.NTT_CALLS)
        from . import trace as tracing

        spans.marked = True
        ctx["trace"] = tracing.capture(lambda: drv.step(steps + 1))
        spans.marked = False
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    drv.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = drv.judge()
    info["reference_s"] = time.perf_counter() - t_ref

    metrics = {}
    if trace:
        for m in r["per_layer"]:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, r["traffic"]["rate"]: units / window_s}
        for m in r["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    counted = next(c for c in checks if c.attempted is not None)
    return {
        "correct": all(c.holds for c in checks), "attempted": counted.attempted,
        "failed": counted.value, "metrics": metrics, "peak": peak, "ctx": ctx, "info": info,
        "checks": checks,
    }


def _forbidden_modules() -> List[str]:
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches()

    import torch

    bench = load_bench()
    cell = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if cell is None:
        sys.stderr.write(f"proofbench: no workload {args.workload!r}\n")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        sys.stderr.write("proofbench: this benchmark runs on CUDA cards only; found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}\n")
        return 1
    device = torch.device("cuda")
    print(f"proofbench: {args.workload} seed {args.seed} on {card_line()}", flush=True)
    res = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), device)
    ctx, info = res["ctx"], res["info"]
    sys.stderr.write(json.dumps({
        "steps": ctx["steps"], "units": ctx["units"], "window_s": ctx["window_s"],
        "spans": ctx["spans"], **info}) + "\n")
    if args.trace:
        tr = ctx["trace"]
        sys.stderr.write(json.dumps({"stages": ctx.get("stages"),
                                     "ntt_calls": ctx.get("ntt_calls")}) + "\n")
    result = {
        "correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
        "metrics": res["metrics"],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell["chips"], "memory_peak_bytes": res["peak"]},
        "setup_apart_s": {k: info[k] for k in ("kernels_loaded_s", "srs_generated_s")},
    }
    if args.trace:
        kernels = sorted(tr.kernel_seconds().items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr.idle_by_range().items(), key=lambda kv: -kv[1])[:10]
        result["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": [list(kv) for kv in kernels],
                               "idle_gaps": [list(kv) for kv in gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in res["checks"]}
    bad = _forbidden_modules()
    if bad:
        sys.stderr.write("proofbench: modules of JAX or the JAX package are loaded: "
                         + ", ".join(bad) + "\n")
        return 1
    for c in res["checks"]:
        sys.stderr.write(f"check {c.name} {c.value} limit {c.limit}"
                         f" ({'holds' if c.holds else 'FAILS'}; {c.note})\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
