#!/usr/bin/env python3
"""Compare Fr product formulations on one NVIDIA GPU.

    python3 tools/torch_microbench_fr_mul.py [log2 N] [--device cpu]

Counterpart of `tools/microbench_fr_mul.py` for the PyTorch/CUDA port.
Paths:
  a) limbs-last product of `fields.modring.FR_RING` (n, L): the same limb
     arithmetic moved to limbs-first and back, canonical out
  b) limbs-first eager product (`fields.fr_lf.mul`: plain PyTorch on the
     limb arithmetic of `fields.limb_kernels`), (L, n), what the prover runs
  c) limbs-first fused product, one CUDA kernel (`fields.proto_mul.fr_mul`,
     `csrc/proto_mul.cu`)

Also times a butterfly-stage shape for (b) and for (a): twiddle gather +
product + add/sub + select.

Before any timing the kernel is held against its plain version on the raw
lazy limbs of every lane, and against the eager `fr_lf.mul` after
`normalize`; the product of (a) against (b) on every lane. The device is
CUDA and the script raises without one.
`--device cpu` runs the plain version in the kernel's place (a check of the
script, no measurement of a card): its times are host times and are
labelled so. Inputs come from numpy's generator with seed 0, as in the
original. The first line printed is the card's name and power limit.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from aleo_tpu_torch import params
from aleo_tpu_torch.fields import fr_lf as lf
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.fields import proto_mul as pm
from aleo_tpu_torch.fields.modring import FR_RING as F

R = params.R


def card_line(device) -> str:
    if device.type != "cuda":
        return f"{device} (no card: plain PyTorch versions, host times)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bench(fn, *args, n, iters=20, label="", device=None):
    """One warm-up call, then `iters` calls: CUDA events on a card, the host
    clock on the CPU. Prints ms per call and million products per second
    (n products a call)."""
    out = fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            out = fn(*args)
        e1.record()
        torch.cuda.synchronize()
        dt = e0.elapsed_time(e1) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        dt = (time.perf_counter() - t0) / iters
    print(f"{label:32s} {dt * 1e3:8.3f} ms  {n / dt / 1e6:10.2f} Mmul/s  [{device.type}]",
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("log2n", type=int, nargs="?", default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device = limbs.resolve_device(args.device)
    n = 1 << args.log2n
    print(card_line(device), flush=True)
    print("device:", device, "N =", n, flush=True)

    rng = np.random.default_rng(0)
    a_int = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]
    b_int = [int.from_bytes(rng.bytes(31), "little") % R for _ in range(n)]
    alf = lf.encode(a_int, device=device)              # (L, n)
    blf = lf.encode(b_int, device=device)

    # correctness before any timing: raw lazy limbs against the plain
    # version on every lane, field values against the eager product
    out_k = pm.fr_mul(alf, blf)
    assert torch.equal(out_k, pm.fr_mul_plain(alf, blf)), "fr_mul: raw limbs differ"
    want = lf.normalize(lf.mul(alf, blf))
    assert torch.equal(lf.normalize(out_k), want), "fr_mul != fr_lf.mul"
    assert lf.decode(out_k[:, :8]) == [x * y % R for x, y in zip(a_int[:8], b_int[:8])]
    print("fused == eager: ok", flush=True)
    a_ll = F.encode(a_int, device=device)              # (n, L)
    b_ll = F.encode(b_int, device=device)
    assert torch.equal(F.mul(a_ll, b_ll), want.T), "FR_RING.mul != fr_lf.mul"
    print("limbs-last == eager: ok", flush=True)

    it = args.iters
    bench(F.mul, a_ll, b_ll, n=n, iters=it, label="limbs-last ModRing", device=device)
    bench(lf.mul, alf, blf, n=n, iters=it, label="limbs-first eager", device=device)
    fused = "limbs-first fused kernel" if device.type == "cuda" else "fused path, plain version"
    bench(pm.fr_mul, alf, blf, n=n, iters=it, label=fused, device=device)

    # butterfly-stage shape: gather twiddle + mul + add/sub/select, eager
    wtab_int, acc = [], 1
    for _ in range(n):
        wtab_int.append(acc)
        acc = acc * 5 % R
    wtab = lf.encode(wtab_int, device=device)
    iota = torch.arange(n, dtype=torch.int64, device=device)
    span = min(128, n // 2)

    def stage_lf(x):
        tw = wtab[:, (iota * 7) & (n - 1)]
        m = lf.mul(tw, x)
        partner_idx = iota ^ span
        m_p = m[:, partner_idx]
        x_p = x[:, partner_idx]
        lower = (iota & span) == 0
        return lf.select(lower, lf.add(x, m_p), lf.sub(x_p, m))

    bench(stage_lf, alf, n=n, iters=it, label="bfly stage limbs-first eager", device=device)

    wtab_ll = wtab.T.contiguous()

    def stage_ll(x):
        tw = wtab_ll[(iota * 7) & (n - 1)]
        m = F.mul(tw, x)
        partner_idx = iota ^ span
        m_p = m[partner_idx]
        x_p = x[partner_idx]
        lower = (iota & span) == 0
        return F.select(lower, F.add(x, m_p), F.sub(x_p, m))

    assert torch.equal(stage_ll(a_ll), lf.normalize(stage_lf(alf)).T), \
        "limbs-last stage != limbs-first stage"
    bench(stage_ll, a_ll, n=n, iters=it, label="bfly stage limbs-last ModRing", device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
