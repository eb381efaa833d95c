#!/usr/bin/env python3
"""Roles, lanes a block and register budget of g1_add and g1_add_sel, tried out.

    python3 scripts/torch_g1_variants.py [--baseline DIR] [out.json]

g1_add and g1_add_sel (`aleo_tpu_torch/csrc/g1_fused.cu`) spread a lane over
G1S_ROLES threads, G1S_LANES lanes a block, and ask for G1S_MIN_BLOCKS blocks
an SM (the second argument of __launch_bounds__, which caps a thread's
registers at 65536 / (roles * lanes * blocks)). This script builds the source
once for each variant below, all builds at once, and for each prints what
`-Xptxas -v` says of the two kernels (registers, spill bytes, shared memory)
and the device time of one launch at 22, 1408 and 45056 lanes (the narrow end
of the bucket reduction, its scan steps, a round of a 32768-point MSM; events
around replays of a CUDA graph whose launches rotate over distinct buffers).

With --baseline DIR, the same two kernels are also built from
DIR/aleo_tpu_torch/csrc/g1_fused.cu (another checkout, for example the
parent commit unpacked with `git archive`; same launcher signatures) at its
own defaults and timed beside them, first.

Every variant's outputs are held against the first one's after normalize
(exact), and `raw_equal` says whether the stored limbs agree before it too.
The variant that `_build.py` builds is the first of VARIANTS. Needs a CUDA
device and nvcc.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aleo_tpu_torch import _build, params
from aleo_tpu_torch.fields import limb_kernels as lk

VARIANTS = [        # (name, roles, lanes a block, blocks an SM must hold)
    ("r6_l32_b4", 6, 32, 4),        # the default: 192 threads, <= 85 registers
    ("r6_l32_b1", 6, 32, 1),        # no cap
    ("r6_l32_b5", 6, 32, 5),        # <= 68 registers
    ("r6_l64_b2", 6, 64, 2),        # 384 threads, <= 85 registers
    ("r3_l32_b8", 3, 32, 8),        # 96 threads, <= 85 registers
    ("r3_l64_b4", 3, 64, 4),        # 192 threads, <= 85 registers
    ("r2_l32_b8", 2, 32, 8),        # 64 threads, <= 128 registers
    ("r2_l64_b5", 2, 64, 5),        # 128 threads, <= 102 registers
]
WIDTHS = (22, 1408, 22 * 2048)
L = params.FQ_LIMBS
SETS = 3
KERNELS = {         # name -> (coordinate inputs, flag inputs)
    "g1_add": (6, 0), "g1_add_sel": (5, 2),
}


def _compile(source, out, defines):
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, *defines, "-I", os.path.dirname(source),
           "-shared", "-o", out, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(so):
    lib = ctypes.CDLL(so)
    for kname, (nc, nf) in KERNELS.items():
        fn = getattr(lib, kname + "_launch")
        fn.argtypes = [ctypes.c_void_p] * (nc + nf + 3) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build_all(baseline):
    """Every variant (and the baseline) at once -> [(name, settings, lib, ptxas)]."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    here = os.path.join(_build.CSRC_DIR, "g1_fused.cu")
    jobs = []
    if baseline:
        src = os.path.join(baseline, "aleo_tpu_torch", "csrc", "g1_fused.cu")
        jobs.append(("baseline", {"source": src}, os.path.join(out_dir, "g1_baseline.so"), []))
    for name, roles, lanes, blocks in VARIANTS:
        defines = [f"-DG1S_ROLES={roles}", f"-DG1S_LANES={lanes}", f"-DG1S_MIN_BLOCKS={blocks}"]
        settings = {"roles": roles, "lanes": lanes, "min_blocks": blocks}
        jobs.append((name, settings, os.path.join(out_dir, f"g1_{name}.so"), defines))
    procs = [_compile(s.get("source", here), so, d) for _, s, so, d in jobs]
    built = []
    for (name, settings, so, _), proc in zip(jobs, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        info = _build.ptxas_info(log)
        ptxas = {k: info.get(k + "_kernel") for k in KERNELS}
        built.append((name, settings, _load(so), ptxas))
    return built


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another checkout whose g1_fused.cu is timed first")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_g1_variants: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    built = build_all(args.baseline)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    M = max(WIDTHS)

    def coord():
        x = torch.randint(0, 1 << 16, (L, M), dtype=torch.int32, device="cuda", generator=gen)
        x[L - 1] %= 0x35C          # below 2p
        return x

    sets = [[coord() for _ in range(6)] for _ in range(SETS)]
    sign = torch.randint(0, 2, (1, M), dtype=torch.int32, device="cuda", generator=gen)
    valid = torch.ones((1, M), dtype=torch.int32, device="cuda")
    stream = torch.cuda.Stream()
    fq = lk.get_fq()
    result = {"card": card, "widths": list(WIDTHS), "variants": {}}
    first = {}
    for name, settings, lib, ptxas in built:
        row = {**settings, "ptxas": ptxas, "ms": {}, "raw_equal": {}}
        for kname, (nc, nf) in KERNELS.items():
            fn = getattr(lib, kname + "_launch")
            for w in WIDTHS:
                ins = [[t[:, :w].contiguous() for t in s[:nc]] for s in sets]
                flags = [f[:, :w].contiguous() for f in (sign, valid)][:nf]
                outs = [torch.empty((L, w), dtype=torch.int32, device="cuda") for _ in range(3)]

                def launch(s):
                    ptrs = [t.data_ptr() for t in (*ins[s], *flags, *outs)]
                    rc = fn(*ptrs, w, torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{kname} ({name}): cudaError {rc}")

                with torch.cuda.stream(stream):
                    launch(0)
                    torch.cuda.synchronize()
                    got = torch.cat(outs).clone()
                    key = (kname, w)
                    if key in first:
                        want = first[key]
                        norm = lambda t: torch.cat([lk.normalize(fq, c) for c in t.split(L)])
                        assert torch.equal(norm(got), norm(want)), \
                            f"{kname} ({name}) differs at {w} lanes"
                        row["raw_equal"][f"{kname}_{w}"] = bool(torch.equal(got, want))
                    else:
                        first[key] = got
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(graph, stream=stream):
                        for s in range(SETS):
                            launch(s)
                    graph.replay()
                    torch.cuda.synchronize()
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    for _ in range(20):
                        graph.replay()
                    e1.record()
                    torch.cuda.synchronize()
                    row["ms"][f"{kname}_{w}"] = e0.elapsed_time(e1) / (20 * SETS)
        result["variants"][name] = row
        print(json.dumps({name: row}), flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
