#!/usr/bin/env python3
"""Machine instructions of the batch inversion's kernels, counted in the SASS.

    python3 scripts/torch_sass_count.py [out.json]

Builds the kernel library (`aleo_tpu_torch/_build.py`), disassembles it with
the toolkit's `cuobjdump -sass` and prints one JSON object: for each of
fq_fermat, fq_inv_up, fq_inv_down and fq_mul, the number of instructions in
its SASS and, for every loop (a branch back to an earlier instruction), the
instructions of the loop body, with the first branches as the SASS spells
them. fq_fermat's body is branch-free apart from its one loop of
SAFEGCD_BATCHES batches, so the instructions one thread issues are the loop
body times that count plus the rest, which the object also gives
(`per_lane`). Needs nvcc and cuobjdump (the CUDA toolkit), not a card.
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

KERNELS = ("fq_fermat_kernel", "fq_inv_up_kernel", "fq_inv_down_kernel", "fq_mul_kernel")
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


def main(argv):
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    lib = _build.library()
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          check=True).stdout
    funcs = functions(sass)
    result = {}
    for kernel in KERNELS:
        hits = [k for k in funcs if kernel in k]
        if len(hits) != 1:
            sys.exit(f"torch_sass_count: {kernel}: {len(hits)} functions in the SASS")
        result[kernel] = count(funcs[hits[0]])
    fermat = result["fq_fermat_kernel"]
    if len(fermat["loop_bodies"]) == 1:
        body = fermat["loop_bodies"][0]
        fermat["per_lane"] = body * ga.SAFEGCD_BATCHES + fermat["instructions"] - body
    out = json.dumps({"sass": result, "library": os.path.basename(lib._name)})
    print(out)
    if argv:
        with open(argv[0], "w") as f:
            f.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
