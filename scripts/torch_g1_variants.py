#!/usr/bin/env python3
"""Build settings of the projective kernels, fq_apply, fq_mul and fq_mul_canon,
tried out.

    python3 scripts/torch_g1_variants.py [--families F,...] [--baseline DIR ...]
                                         [--rounds N] [out.json]

Five families of kernels, each built from its source once for each variant
below, all builds at once; for each variant the script prints what
`-Xptxas -v` says of the kernels (registers, spill bytes, shared memory)
and the device time of one launch at each width (events around replays of
a CUDA graph whose launches rotate over distinct buffers, more than the
50 MB L2 cache in all at the main path's width).

- g1: the three adders of `aleo_tpu_torch/csrc/g1_fused.cu` (g1_add,
  g1_add_sel, g1_add_sel_proj) spread a lane over G1S_ROLES threads,
  G1S_LANES lanes a block, and ask for G1S_MIN_BLOCKS blocks an SM (the
  second argument of __launch_bounds__, which caps a thread's registers at
  65536 / (roles * lanes * blocks)). Widths 22, 1408 and 45056 lanes (the
  narrow end of the bucket reduction, its scan steps, a round of a
  32768-point MSM); g1_add_sel_proj with all lanes valid, half of them, and
  one in 16 (the later steps of the top-window merge).
- double: g1_double of the same file, the doubling's mode of the role
  split, over G1S_DBL_ROLES roles and G1S_LANES lanes a block (its blocks
  an SM follow: 768 threads). Widths 22, 1408 and 45056.
- apply: fq_apply of `aleo_tpu_torch/csrc/g1_affine.cu`, one thread a lane:
  FQA_LANES lanes a block (and so the blocks an SM holds). Widths 128, 50688
  (a round of the batch-affine MSM of a proof) and 180224 (msm_batch_host's,
  k = 4).
- mul: fq_mul of the same file, FQM_LANES lanes a thread, strided by the
  grid. Widths 2 (to_affine's), 128, 50688 and 180224.
- canon: fq_mul_canon of `aleo_tpu_torch/csrc/proto_mul.cu` (the tools'
  canonical Fq product), one lane a thread, FQC_THREADS threads a block.
  Widths 1, 129, 1001 and 65536 (the tools' default).

`--families` picks some of them (default: all). Each --baseline DIR (another
checkout, for example the parent commit unpacked with `git archive`; same
launcher signatures) has the same kernels built from DIR's
`aleo_tpu_torch/csrc/` at its own defaults and timed beside them, first.
The variants of one kernel and width are timed in --rounds rounds (default
3), every variant once a round, the order reversed in every other round, so
that two variants are compared within the same stretch of the card's
clocks; `ms` is the median of a variant's rounds, `ms_rounds` all of them.

Every variant's outputs are held against the first one's of its family
after normalize (exact), and `raw_equal` says whether the stored limbs
agree before it too. The variant that `_build.py` builds is the first of
each family that sets no define. Needs a CUDA device and nvcc.
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

L = params.FQ_LIMBS
SETS = 3
# family -> source, kernels {name: (input kinds, output kinds, valid rows)},
# widths, variants [(name, defines)], and optionally the number of input
# sets (default SETS). An input kind is "c" for a coordinate or the name of
# a flag row; an output kind "c" or "f".
FAMILIES = {
    "g1": {
        "source": "g1_fused.cu",
        "kernels": {
            "g1_add": ("cccccc", "ccc", ("all",)),
            "g1_add_sel": (("c",) * 5 + ("sign", "valid"), "ccc", ("all",)),
            "g1_add_sel_proj": (("c",) * 6 + ("sign", "valid"), "ccc", ("all", "half", "few")),
        },
        "widths": (22, 1408, 22 * 2048),
        "variants": [
            ("r6_l32_b4", []),                              # the default: 192 threads, <= 85 registers
            ("r6_l32_b1", ["-DG1S_MIN_BLOCKS=1"]),          # no cap
            ("r6_l32_b5", ["-DG1S_MIN_BLOCKS=5"]),          # <= 68 registers
            ("r6_l64_b2", ["-DG1S_LANES=64", "-DG1S_MIN_BLOCKS=2"]),
            ("r3_l32_b8", ["-DG1S_ROLES=3", "-DG1S_MIN_BLOCKS=8"]),
            ("r2_l32_b8", ["-DG1S_ROLES=2", "-DG1S_MIN_BLOCKS=8"]),
        ],
    },
    "double": {
        "source": "g1_fused.cu",
        "kernels": {"g1_double": ("ccc", "ccc", ("all",))},
        "widths": (22, 1408, 22 * 2048),
        "variants": [
            ("r4_l32", []),                                 # the default: 128 threads
            ("r6_l32", ["-DG1S_DBL_ROLES=6"]),
            ("r4_l64", ["-DG1S_LANES=64", "-DG1S_MIN_BLOCKS=2"]),
            ("r6_l64", ["-DG1S_DBL_ROLES=6", "-DG1S_LANES=64", "-DG1S_MIN_BLOCKS=2"]),
        ],
    },
    "apply": {
        "source": "g1_affine.cu",
        "kernels": {
            "fq_apply": (("c", "c", "inf1", "c", "c", "sign", "case", "c", "c"), "ccf", ("all",)),
        },
        "widths": (128, 22 * 2048 * 9 // 8, 4 * 22 * 2048),
        "variants": [
            ("t32", []),                            # the default: 32 lanes a block
            ("t64", ["-DFQA_LANES=64"]),
            ("t128", ["-DFQA_LANES=128"]),
            ("t256", ["-DFQA_LANES=256"]),
        ],
    },
    "mul": {
        "source": "g1_affine.cu",
        "kernels": {"fq_mul": ("cc", "c", ("all",))},
        "widths": (2, 128, 22 * 2048 * 9 // 8, 4 * 22 * 2048),
        "variants": [
            ("k1", []),                             # the default: one lane a thread
            ("k2", ["-DFQM_LANES=2"]),
            ("k4", ["-DFQM_LANES=4"]),
        ],
        "sets": 8,                                  # 117 MB at 50688 lanes
    },
    "canon": {
        "source": "proto_mul.cu",
        "kernels": {"fq_mul_canon": ("cc", "c", ("all",))},
        "widths": (1, 129, 1001, 1 << 16),
        "variants": [
            ("t32", []),                            # the default: one warp a block
            ("t64", ["-DFQC_THREADS=64"]),
            ("t128", ["-DFQC_THREADS=128"]),
        ],
        "sets": 8,                                  # 151 MB at 65536 lanes
    },
}


def _compile(source, out, defines):
    cmd = [_build._find_nvcc(), *_build.NVCC_FLAGS, *defines, "-I", os.path.dirname(source),
           "-shared", "-o", out, source]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _load(so, kernels):
    lib = ctypes.CDLL(so)
    for kname, (ins, outs, _) in kernels.items():
        fn = getattr(lib, kname + "_launch")
        fn.argtypes = [ctypes.c_void_p] * (len(ins) + len(outs)) + [ctypes.c_int,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def build_all(baselines, families):
    """Every variant of every family named (and the baselines) at once ->
    {family: [(name, defines, lib, ptxas)]}; a baseline's name is
    "baseline_" and its directory's name, its defines None."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for fam in families:
        spec = FAMILIES[fam]
        for base in baselines:
            src = os.path.join(base, "aleo_tpu_torch", "csrc", spec["source"])
            name = "baseline_" + os.path.basename(os.path.normpath(base))
            jobs.append((fam, name, None, src, []))
        for name, defines in spec["variants"]:
            jobs.append((fam, name, defines, os.path.join(_build.CSRC_DIR, spec["source"]),
                         defines))
    procs = [_compile(src, os.path.join(out_dir, f"{fam}_{name}.so"), d)
             for fam, name, _, src, d in jobs]
    built = {fam: [] for fam in families}
    for (fam, name, defines, _, _), proc in zip(jobs, procs):
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{fam} {name}: nvcc failed\n{log}")
        kernels = FAMILIES[fam]["kernels"]
        info = _build.ptxas_info(log)
        # by kernel (a baseline's may be the instances of a template)
        ptxas = {k: {n: v for n, v in info.items() if n.startswith(k + "_kernel")}
                 for k in kernels}
        so = os.path.join(out_dir, f"{fam}_{name}.so")
        built[fam].append((name, defines, _load(so, kernels), ptxas))
    return built


def _inputs(gen, m, n_sets):
    """n_sets sets of operands: coordinates < 2p, and the flag rows."""
    def coord():
        x = torch.randint(0, 1 << 16, (L, m), dtype=torch.int32, device="cuda", generator=gen)
        x[L - 1] %= 0x35C          # below 2p
        return x

    def flag(hi):
        return torch.randint(0, hi, (1, m), dtype=torch.int32, device="cuda", generator=gen)

    def few():
        return (torch.randint(0, 16, (1, m), device="cuda", generator=gen) == 0).to(torch.int32)

    sets = []
    for _ in range(n_sets):
        sets.append({"c": [coord() for _ in range(6)], "sign": flag(2), "inf1": flag(2),
                     "case": flag(4), "valid": {"all": torch.ones_like(flag(2)),
                                                "half": flag(2), "few": few()}})
    return sets


def _args(s, ins, w, vrow):
    """The inputs of one launch at width w from set s."""
    coords = iter(s["c"])
    out = []
    for kind in ins:
        t = next(coords) if kind == "c" else (s["valid"][vrow] if kind == "valid" else s[kind])
        out.append(t[:, :w].contiguous())
    return out


def _norm(fq, t):
    return lk.normalize(fq, t) if t.shape[0] == L else t


def _time(graph, n_sets):
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(20):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (20 * n_sets)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="another checkout whose kernels are timed first (repeatable)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated families to build and time (default: all)")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_g1_variants: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    families = args.families.split(",")
    if set(families) - set(FAMILIES):
        sys.exit(f"torch_g1_variants: unknown family {sorted(set(families) - set(FAMILIES))}")
    built = build_all(args.baseline, families)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    stream = torch.cuda.Stream()
    fq = lk.get_fq()
    result = {"card": card, "rounds": args.rounds, "families": {}}
    for fam in families:
        spec = FAMILIES[fam]
        n_sets = spec.get("sets", SETS)
        sets = _inputs(gen, max(spec["widths"]), n_sets)
        rows = {name: {"defines": defines, "ptxas": ptxas, "ms": {}, "ms_rounds": {},
                       "raw_equal": {}} for name, defines, _, ptxas in built[fam]}
        for kname, (ins, outk, vrows) in spec["kernels"].items():
            for w in spec["widths"]:
                for vrow in vrows:
                    key = f"{kname}_{w}" + ("" if vrow == "all" else f"_{vrow}_valid")
                    ins_s = [_args(s, ins, w, vrow) for s in sets]
                    graphs, first = [], None
                    for name, _, lib, _ in built[fam]:
                        fn = getattr(lib, kname + "_launch")
                        outs = [torch.empty((L if k == "c" else 1, w), dtype=torch.int32,
                                            device="cuda") for k in outk]

                        def launch(i, fn=fn, outs=outs, name=name):
                            ptrs = [t.data_ptr() for t in (*ins_s[i], *outs)]
                            rc = fn(*ptrs, w, torch.cuda.current_stream().cuda_stream)
                            if rc:
                                raise RuntimeError(f"{kname} ({name}): cudaError {rc}")

                        with torch.cuda.stream(stream):
                            launch(0)
                            torch.cuda.synchronize()
                            got = [o.clone() for o in outs]
                            if first is None:
                                first = got
                            else:
                                assert all(torch.equal(_norm(fq, a), _norm(fq, b))
                                           for a, b in zip(got, first)), \
                                    f"{kname} ({name}) differs at {key}"
                                rows[name]["raw_equal"][key] = all(
                                    torch.equal(a, b) for a, b in zip(got, first))
                            graph = torch.cuda.CUDAGraph()
                            with torch.cuda.graph(graph, stream=stream):
                                for i in range(n_sets):
                                    launch(i)
                        graphs.append((name, graph, outs))
                    times = {name: [] for name, _, _ in graphs}
                    for r in range(args.rounds):
                        for name, graph, _ in (graphs if r % 2 == 0 else graphs[::-1]):
                            with torch.cuda.stream(stream):
                                times[name].append(_time(graph, n_sets))
                    for name, t in times.items():
                        rows[name]["ms_rounds"][key] = t
                        rows[name]["ms"][key] = sorted(t)[len(t) // 2]
                    print(json.dumps({fam: key, "ms": {n: rows[n]["ms"][key] for n in times}}),
                          flush=True)
        result["families"][fam] = {"widths": list(spec["widths"]), "variants": rows}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
