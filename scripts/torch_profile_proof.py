#!/usr/bin/env python3
"""Where the time of one proof goes on the GPU (aleo_tpu_torch).

    python3 scripts/torch_profile_proof.py [micro|transfer] [out.json]

Synthesises keys, proves once to warm up (tables, allocator), then proves
once more under `torch.profiler` and prints one JSON object: the proof's wall
seconds with and without the profiler, the summed device time of all kernels,
the device's busy share (summed kernel time over wall time: one stream, so
kernels do not overlap), the number of kernel launches, the kernels with
the most device time, and the port's own kernels and the library matrix
products (every kernel with "gemm" in its name: the int8 product of
`torch._int_mm` and the float32 `torch.bmm` of MatNTT) by name.

It then splits the NTT side off: every call of the four NTT entry points is
logged during the proof and replayed alone, on random data of the same
sizes, once untraced and once under the profiler; `ntt_side` holds the
calls by size, their wall seconds, kernel launches and device time. With
ALEO_TORCH_MATNTT_MIN set past every size the same script profiles the
butterfly network, with ALEO_TORCH_MSM_AFFINE=0 the proof whose MSMs take
the projective pipeline (`msm_affine_mode` in the result says which ran), and
with ALEO_TORCH_FIXED_BASE=auto the proof whose commits take the fixed-base
MSM (`fixed_base_mode`; the warm-up proof builds the tables, the profiled one
finds them cached).
Needs a CUDA device.
"""

import json
import os
import random
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aleo_tpu_torch import config
from aleo_tpu_torch.curves import g1_affine as ga
from aleo_tpu_torch.curves import g1_fused as gf
from aleo_tpu_torch.fields import fmat_kernels as fk
from aleo_tpu_torch.ntt import ntt as dntt
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.program.examples import load_example
from aleo_tpu_torch.program.interpreter import Registry
from aleo_tpu_torch.program.parser import parse_program
from aleo_tpu_torch.program.values import Record, Value
from aleo_tpu_torch.snark import pipeline
from aleo_tpu_torch.utils import profiling as prof

MICRO = """
program micro.aleo;

function bump:
    input r0 as u64.private;
    add r0 1u64 into r1;
    output r1 as u64.private;
"""


PATTERNS = ("fmat_reduce", "fmat_carry2d", "fmat_carry3d", "fq_prepare", "fq_mul",
            "fq_inv_up", "fq_fermat", "fq_inv_down", "fq_apply", "g1_double",
            "g1_add_kernel", "g1_add_sel_kernel", "g1_add_sel_proj", "g1_normalize", "gemm")
NTT_ENTRIES = ("ntt_lf", "intt_lf", "coset_ntt_lf", "coset_intt_lf")


def kernel_rows(p):
    """(name, device microseconds, count) of every kernel of a profile."""
    events = list(p.key_averages())
    # kernel rows only: an operator's row repeats the time of its kernels
    on_device = [ev for ev in events
                 if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA]
    rows = []
    for ev in on_device or events:
        own = getattr(ev, "self_device_time_total", None)
        if own is None:
            own = getattr(ev, "self_cuda_time_total", 0)
        if own > 0:
            rows.append((ev.key, own, ev.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def by_pattern(rows):
    out = {}
    for pat in PATTERNS:
        hit = [r for r in rows if pat in r[0].lower()]
        out[pat] = {"device_ms": sum(r[1] for r in hit) / 1e3,
                    "count": sum(r[2] for r in hit)}
    return out


def main(argv):
    which = argv[0] if argv else "transfer"
    out_path = argv[1] if len(argv) > 1 else None
    if not torch.cuda.is_available():
        sys.exit("torch_profile_proof: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if which == "micro":
        reg = Registry()
        reg.add(parse_program(MICRO))
        pid, fn, deg, caller = "micro.aleo", "bump", 8193, 0
        inputs = [Value("u64", 41)]
    else:
        reg = load_example("simple_token")
        pid, fn, deg, caller = "token.aleo", "transfer", 32769, 123456789
        rec = Record("token.aleo", "token", owner=caller, gates=0,
                     entries={"amount": Value("u64", 500)}, nonce=7)
        inputs = [rec, Value("address", 987654321), Value("u64", 120)]
    srs = Srs.generate(deg)
    keys = pipeline.synthesize_keys(reg, pid, fn, srs=srs, cache=False)

    def prove():
        ep = pipeline.prove_execution(keys, reg, inputs, caller=caller,
                                      rng_nonce=lambda: 11, rng=random.Random(3))
        torch.cuda.synchronize()
        return ep

    prove()                                   # warm-up
    prof.reset()
    prof.enable()
    t0 = time.time()
    ep = prove()
    plain_s = time.time() - t0
    stages = prof.report()
    prof.enable(False)
    assert pipeline.verify_execution(keys, ep)

    # log the NTT side's calls while the traced proof runs
    ntt_calls = []
    real = {name: getattr(dntt, name) for name in NTT_ENTRIES}

    def logged(name):
        def call(x, *shift):
            ntt_calls.append((name, x.shape[1], shift))
            return real[name](x, *shift)
        return call

    ga.reset_launches()
    fk.reset_launches()
    gf.reset_launches()
    for name in NTT_ENTRIES:
        setattr(dntt, name, logged(name))
    try:
        t0 = time.time()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            prove()
        traced_s = time.time() - t0
    finally:
        for name in NTT_ENTRIES:
            setattr(dntt, name, real[name])
    port_launches = {**ga.LAUNCHES, **fk.LAUNCHES, **gf.LAUNCHES}
    rows = kernel_rows(p)
    device_s = sum(r[1] for r in rows) / 1e6

    # the NTT side alone: the same calls on random data of the same sizes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    data = {}
    for _, n, _ in ntt_calls:
        if n not in data:
            x = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, device="cuda",
                              generator=gen)
            x[15] %= 0x12AB                  # below the modulus
            data[n] = x

    def replay():
        for name, n, shift in ntt_calls:
            real[name](data[n], *shift)
        torch.cuda.synchronize()

    replay()
    t0 = time.time()
    replay()
    ntt_s = time.time() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as pn:
        replay()
    ntt_rows = kernel_rows(pn)
    by_size = {}
    for _, n, _ in ntt_calls:
        by_size[str(n)] = by_size.get(str(n), 0) + 1
    ntt_side = {
        "matntt_min_n": config.MATNTT_MIN_N, "fused_reduce": config.FUSED_REDUCE,
        "calls": len(ntt_calls), "calls_by_size": by_size,
        "seconds": ntt_s, "kernel_launches": sum(r[2] for r in ntt_rows),
        "device_kernel_seconds": sum(r[1] for r in ntt_rows) / 1e6,
        "by_pattern": by_pattern(ntt_rows),
        "top_kernels": [
            {"name": k[:80], "device_ms": us / 1e3, "count": c} for k, us, c in ntt_rows[:8]
        ],
    }
    result = {
        "card": card, "circuit": which, "n": keys.index.n, "m": keys.index.m,
        "msm_affine_mode": config.MSM_AFFINE_MODE,
        "fixed_base_mode": config.FIXED_BASE_MODE,
        "proof_seconds": plain_s, "proof_seconds_traced": traced_s,
        "device_kernel_seconds": device_s,
        "device_busy_share_traced": device_s / traced_s if traced_s else None,
        "device_busy_share_of_untraced_wall": device_s / plain_s if plain_s else None,
        "kernel_launches": sum(r[2] for r in rows),
        "port_kernel_launches": port_launches,
        "by_pattern": by_pattern(rows),
        "gemm_kernels": [
            {"name": k[:100], "device_ms": us / 1e3, "count": c}
            for k, us, c in rows if "gemm" in k.lower()
        ],
        "ntt_side": ntt_side,
        "stages": stages,
        "top_kernels": [
            {"name": k[:80], "device_ms": us / 1e3, "count": c} for k, us, c in rows[:20]
        ],
    }
    text = json.dumps(result)
    print(text)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
