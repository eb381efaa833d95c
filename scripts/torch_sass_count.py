#!/usr/bin/env python3
"""Machine instructions of the port's kernels and of its two Fq products,
counted in the SASS.

    python3 scripts/torch_sass_count.py [out.json]

Builds the kernel library (`aleo_tpu_torch/_build.py`), disassembles it with
the toolkit's `cuobjdump -sass` and prints one JSON object: for each of
fq_fermat, fq_inv_up, fq_inv_down, fq_mul, fq_apply, g1_double and the three
adders g1_add, g1_add_sel, g1_add_sel_proj, the number of instructions in its SASS
and, for every loop (a branch back to an earlier instruction), the
instructions of the loop body, with the first branches as the SASS spells
them. fq_fermat's body is branch-free apart from its one loop
of SAFEGCD_BATCHES batches, so the instructions one thread issues are the
loop body times that count plus the rest, which the object also gives
(`per_lane`).

`products` compares the two Fq Montgomery products: fq_mul (csrc/mont.cuh,
one 64-bit carry through 288 steps) and fq_mul_ptx (csrc/fq_mul_ptx.cuh, two
carry chains a row). Each is compiled alone into a probe kernel that loads
two operands, multiplies once and stores (PROBE below, built beside the
library, not part of it), and the object gives each probe's instructions by
opcode. Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
"""

import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aleo_tpu_torch import _build
from aleo_tpu_torch.curves import g1_affine as ga

KERNELS = ("fq_fermat_kernel", "fq_inv_up_kernel", "fq_inv_down_kernel", "fq_mul_kernel",
           "fq_apply_kernel", "g1_double_kernel", "g1_add_kernel", "g1_add_sel_kernel",
           "g1_add_sel_proj_kernel")
PROBE = r"""
#include "fq.cuh"
#include "fq_mul_ptx.cuh"
#define PROBE_KERNEL(name, mul)                                                  \
    __global__ void name(const int* a, const int* b, int* r, int M) {            \
        long m = (long)blockIdx.x * blockDim.x + threadIdx.x;                    \
        if (m >= M) return;                                                      \
        uint32_t x[FQ_WORDS], y[FQ_WORDS], z[FQ_WORDS];                          \
        fq_load(x, a, M, m);                                                     \
        fq_load(y, b, M, m);                                                     \
        mul(z, x, y);                                                            \
        fq_store(r, M, m, z);                                                    \
    }
PROBE_KERNEL(probe_fq_mul_kernel, fq_mul)
PROBE_KERNEL(probe_fq_mul_ptx_kernel, fq_mul_ptx)
"""
PROBES = ("probe_fq_mul_kernel", "probe_fq_mul_ptx_kernel")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def functions(sass: str) -> dict:
    """SASS text -> {mangled name: [its lines]}."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name:
            out[name].append(line)
    return out


def count(lines) -> dict:
    """Instructions of one function (NOP padding left out), and of each loop
    in it: a branch back to an earlier instruction, given as a label or as an
    address, closes a loop from there. The one-instruction loop that closes
    every function after its EXIT is no loop of the code."""
    offsets, labels, branches = [], {}, []
    pending = []
    for line in lines:
        lab = _LABEL.match(line)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = _INSTR.search(line)
        if not ins or ins.group(2).split()[0] == "NOP":
            continue
        off = int(ins.group(1), 16)
        offsets.append(off)
        for name in pending:
            labels[name] = off
        pending = []
        words = ins.group(2).split()
        opcode = words[1] if words[0].startswith("@") and len(words) > 1 else words[0]
        if opcode.startswith("BRA"):
            branches.append((off, ins.group(2)))
    loops = []
    for off, text in branches:
        label = re.search(r"\.L_x_\d+", text)
        addrs = re.findall(r"0x([0-9a-f]+)", text)
        target = labels.get(label.group(0)) if label else int(addrs[-1], 16) if addrs else None
        if target is not None and target <= off:
            body = sum(1 for o in offsets if target <= o <= off)
            if body > 1:
                loops.append(body)
    return {"instructions": len(offsets), "loop_bodies": loops,
            "branches": [text for _, text in branches[:6]]}


def opcodes(lines) -> dict:
    """Instructions of one function by opcode (its first word, predicates
    and modifiers left out; NOP left out)."""
    out = {}
    for line in lines:
        ins = _INSTR.search(line)
        if not ins:
            continue
        words = ins.group(2).split()
        op = (words[1] if words[0].startswith("@") and len(words) > 1 else words[0]).split(".")[0]
        if op != "NOP":
            out[op] = out.get(op, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _one(funcs, kernel):
    hits = [k for k in funcs if kernel in k]
    if len(hits) != 1:
        sys.exit(f"torch_sass_count: {kernel}: {len(hits)} functions in the SASS")
    return funcs[hits[0]]


def probe_sass(tool) -> dict:
    """The two products' probe kernels, compiled with the library's flags."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "sass_probe.cu")
    cubin = os.path.join(_build.BUILD_DIR, "sass_probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    subprocess.run([_build._find_nvcc(), *flags, "-I", _build.CSRC_DIR, "-cubin", "-o", cubin,
                    src], capture_output=True, text=True, check=True)
    sass = subprocess.run([tool, "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    funcs = functions(sass)
    out = {}
    for kernel in PROBES:
        lines = _one(funcs, kernel)
        out[kernel] = {"instructions": count(lines)["instructions"], "by_opcode": opcodes(lines)}
    return out


def main(argv):
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = _build.library()
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    funcs = functions(sass)
    result = {}
    for kernel in KERNELS:
        result[kernel] = count(_one(funcs, kernel))
    fermat = result["fq_fermat_kernel"]
    if len(fermat["loop_bodies"]) == 1:
        body = fermat["loop_bodies"][0]
        fermat["per_lane"] = body * ga.SAFEGCD_BATCHES + fermat["instructions"] - body
    out = json.dumps({"sass": result, "products": probe_sass(tool),
                      "library": os.path.basename(lib._name)})
    print(out)
    if argv:
        with open(argv[0], "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
