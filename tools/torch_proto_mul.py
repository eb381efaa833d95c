#!/usr/bin/env python3
"""Fq Montgomery product as one CUDA kernel, limbs-first (24, N) layout.

    python3 tools/torch_proto_mul.py [--log2n 16] [--device cpu]

Counterpart of `tools/proto_pallas_mul.py` for the PyTorch/CUDA port.
Validates: correctness of `fq_mul_canon` and `fq_mul_chain12`
(`aleo_tpu_torch/fields/proto_mul.py`, kernels in `csrc/proto_mul.cu`)
against their plain PyTorch versions on every lane and against Python
integers on the 64 distinct lanes, before any timing; then throughput at
N = 2^16 and the cost of the fused chain of twelve dependent products (a
point-add-like workload) in one launch.

The device is CUDA and the script raises without one. `--device cpu` runs
the plain versions instead of the kernels (a check of the script, no
measurement of a card): its times are host times and are labelled so.
Inputs come from numpy's generator with seed 5, as in the original. The
first line printed is the card's name and power limit.
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
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.fields import proto_mul as pm

L = params.FQ_LIMBS
Q = params.Q
DISTINCT = 64


def card_line(device) -> str:
    if device.type != "cuda":
        return f"{device} (no card: plain PyTorch versions, host times)"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def timeit(fn, *args, iters=30, label="", device=None):
    """Seconds per call after one warm-up call, the wrapper's host side
    included (as the original times a call): CUDA events around `iters` calls
    on a card, the host clock on the CPU."""
    fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn(*args)
        e1.record()
        torch.cuda.synchronize()
        dt = e0.elapsed_time(e1) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        dt = (time.perf_counter() - t0) / iters
    n = args[0].shape[1]
    print(f"{label:40s} {dt * 1e6:10.1f} us   {n / dt / 1e6:10.2f} Mmul/s  [{device.type}]",
          flush=True)
    return dt


def chain_ints(av, bv):
    """The chain of twelve products on Python integers (Montgomery form in,
    canonical Montgomery form out)."""
    r_inv = pow(1 << (16 * L), -1, Q)
    x, y = list(av), list(bv)
    for _ in range(pm.CHAIN_ROUNDS):
        x, y = ([u * v * r_inv % Q for u, v in zip(x, y)],
                [v * u * r_inv % Q for u, v in zip(x, y)])
    return x


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log2n", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = limbs.resolve_device(args.device)
    n = 1 << args.log2n
    assert n >= DISTINCT
    print(card_line(device), flush=True)
    print("device:", device, "N =", n, flush=True)

    rng = np.random.default_rng(5)
    av = [int(rng.integers(0, 2**62)) ** 2 % Q for _ in range(DISTINCT)]
    bv = [int(rng.integers(0, 2**62)) ** 2 % Q for _ in range(DISTINCT)]
    a_ll = np.tile(limbs.to_mont_host(av, Q, L), (n // DISTINCT, 1))
    b_ll = np.tile(limbs.to_mont_host(bv, Q, L), (n // DISTINCT, 1))
    a = limbs.to_tensor(a_ll.T, device)
    b = limbs.to_tensor(b_ll.T, device)

    # correctness before any timing: every lane against the plain version,
    # the distinct lanes against Python integers
    got = pm.fq_mul_canon(a, b)
    assert torch.equal(got, pm.fq_mul_canon_plain(a, b)), "fq_mul_canon mismatch"
    want = [x * y % Q for x, y in zip(av, bv)]
    assert limbs.from_mont_host(limbs.to_numpy(got[:, :DISTINCT]).T, Q) == want
    got12 = pm.fq_mul_chain12(a, b)
    assert torch.equal(got12, pm.fq_mul_chain12_plain(a, b)), "fq_mul_chain12 mismatch"
    am = limbs.limbs_to_ints(a_ll[:DISTINCT])
    bm = limbs.limbs_to_ints(b_ll[:DISTINCT])
    assert limbs.limbs_to_ints(limbs.to_numpy(got12[:, :DISTINCT]).T) == chain_ints(am, bm)
    print("kernel correctness ok" if device.type == "cuda" else "plain version ok", flush=True)

    timeit(pm.fq_mul_canon, a, b, label=f"fq_mul_canon (24,{n})", device=device)
    t12 = timeit(pm.fq_mul_chain12, a, b, iters=10, label="fq_mul_chain12, 12-dep-mul chain",
                 device=device)
    print(f"per-mul in chain: {t12 / 12 * 1e6:.1f} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
