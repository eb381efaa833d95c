#!/usr/bin/env python3
"""Block size and register budget of the projective G1 kernels, tried out.

    python3 scripts/torch_g1_variants.py [out.json]

Builds `aleo_tpu_torch/csrc/g1_fused.cu` once for each variant below (threads
a block through -DG1_THREADS; blocks an SM must hold through -DG1_MIN_BLOCKS,
the second argument of __launch_bounds__, which caps a thread's registers at
65536 / (threads * blocks) and makes the compiler spill what does not fit), and
for each prints what `-Xptxas -v` says of every kernel (registers, spill
bytes) and the device time of one launch of g1_double, g1_add, g1_add_sel and
g1_add_sel_proj at the 45056 lanes of a 32768-point MSM (events around
replays of a CUDA graph whose launches rotate over buffers larger than the L2
cache). Every variant's outputs are held against the first one's, limb for
limb. The variant that `_build.py` builds is the first. Needs a CUDA device
and nvcc.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aleo_tpu_torch import _build, params

VARIANTS = [        # (name, threads a block, blocks an SM must hold)
    ("t128_b3", 128, 3),        # <= 168 registers
    ("t128_b1", 128, 1),
    ("t64_b1", 64, 1),
    ("t256_b1", 256, 1),
    ("t128_b4", 128, 4),        # <= 128 registers
    ("t64_b5", 64, 5),          # <= 200 registers
    ("t64_b6", 64, 6),          # <= 168 registers
]
M = 22 * 2048
L = params.FQ_LIMBS
SETS = 3
KERNELS = {         # name -> (coordinate inputs, flag inputs)
    "g1_double": (3, 0), "g1_add": (6, 0), "g1_add_sel": (5, 2), "g1_add_sel_proj": (6, 2),
}


def build(name, threads, blocks):
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"g1_{name}.so")
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, f"-DG1_THREADS={threads}",
           f"-DG1_MIN_BLOCKS={blocks}", "-I", _build.CSRC_DIR, "-shared", "-o", so,
           os.path.join(_build.CSRC_DIR, "g1_fused.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    info, cur = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)_kernel", line)
        if m:
            cur = m.group(1)
            info[cur] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            info[cur].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            info[cur]["registers"] = int(m.group(1))
    lib = ctypes.CDLL(so)
    for kname, (nc, nf) in KERNELS.items():
        fn = getattr(lib, kname + "_launch")
        fn.argtypes = [ctypes.c_void_p] * (nc + nf + 3) + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, info


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("torch_g1_variants: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)

    def coord():
        x = torch.randint(0, 1 << 16, (L, M), dtype=torch.int32, device="cuda", generator=gen)
        x[L - 1] %= 0x35C          # below 2p
        return x

    sets = [[coord() for _ in range(6)] for _ in range(SETS)]
    sign = torch.randint(0, 2, (1, M), dtype=torch.int32, device="cuda", generator=gen)
    valid = torch.ones((1, M), dtype=torch.int32, device="cuda")
    outs = [torch.empty((L, M), dtype=torch.int32, device="cuda") for _ in range(3)]
    stream = torch.cuda.Stream()
    result = {"card": card, "lanes": M, "variants": {}}
    first = {}
    for name, threads, blocks in VARIANTS:
        lib, info = build(name, threads, blocks)
        row = {"threads": threads, "min_blocks": blocks, "ptxas": info, "ms": {}}
        for kname, (nc, nf) in KERNELS.items():
            fn = getattr(lib, kname + "_launch")
            flags = [sign, valid][:nf]

            def launch(s):
                ptrs = [t.data_ptr() for t in (*sets[s][:nc], *flags, *outs)]
                rc = fn(*ptrs, M, torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{kname} ({name}): cudaError {rc}")

            with torch.cuda.stream(stream):
                launch(0)
                torch.cuda.synchronize()
                got = torch.cat(outs).clone()
                if kname in first:
                    assert torch.equal(got, first[kname]), f"{kname} ({name}) differs"
                else:
                    first[kname] = got
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
                row["ms"][kname] = e0.elapsed_time(e1) / (20 * SETS)
        result["variants"][name] = row
        print(json.dumps({name: row}), flush=True)
    text = json.dumps(result)
    print(text)
    if argv:
        os.makedirs(os.path.dirname(os.path.abspath(argv[0])), exist_ok=True)
        with open(argv[0], "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
