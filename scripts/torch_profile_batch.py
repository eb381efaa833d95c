#!/usr/bin/env python3
"""Where the time of a batch of proofs goes on the GPU (aleo_tpu_torch).

    python3 scripts/torch_profile_batch.py [k] [out.json]

Synthesises the keys of token.aleo/transfer (n = 8192, m = 32768) and k
transitions with different amounts (default 4), then, in the batch-affine
MSM mode and again in the projective one: proves the batch once to warm up
(tables, plans, allocator), once more untraced with the stage timers of
`utils/profiling.py` on, and once under `torch.profiler`. For each mode it
prints one JSON object: the batch's wall seconds with and without the
profiler, the summed device time of all kernels, the device's busy share
(summed kernel time over the untraced wall time: one stream, so kernels do
not overlap), the number of kernel launches, the port's kernels and the
library matrix products by name, the stage timers and the kernels with the
most device time. One single proof of the first transition is timed beside
each batch, untraced, in the same process. Needs a CUDA device.
"""

import json
import os
import random
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from torch_profile_proof import by_pattern, kernel_rows

from aleo_tpu_torch import config
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.program.examples import load_example
from aleo_tpu_torch.program.values import Record, Value
from aleo_tpu_torch.snark import batch, pipeline, prover
from aleo_tpu_torch.snark.verifier import verify
from aleo_tpu_torch.utils import profiling as prof

SENDER, RECEIVER = 123456789, 987654321


def main(argv):
    k = int(argv[0]) if argv else 4
    out_path = argv[1] if len(argv) > 1 else None
    if not torch.cuda.is_available():
        sys.exit("torch_profile_batch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    reg = load_example("simple_token")
    srs = Srs.generate(32769)
    keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
    rec = Record("token.aleo", "token", owner=SENDER, gates=0,
                 entries={"amount": Value("u64", 500)}, nonce=7)
    syns = [
        pipeline.synthesize_and_check(
            keys, reg, [rec, Value("address", RECEIVER), Value("u64", 100 + i)],
            SENDER, lambda: 11)
        for i in range(k)
    ]
    cs_list = [s.cs for s in syns]

    def prove_batch():
        proofs = batch.prove_batch(keys.index, cs_list, rng=random.Random(3))
        torch.cuda.synchronize()
        return proofs

    def prove_single():
        proof = prover.prove(keys.index, cs_list[0], rng=random.Random(3))
        torch.cuda.synchronize()
        return proof

    results = []
    default_mode = config.MSM_AFFINE_MODE
    try:
        for mode in ("1", "0"):
            config.MSM_AFFINE_MODE = mode
            prove_batch()                             # warm-up
            prove_single()
            t0 = time.time()
            prove_single()
            single_s = time.time() - t0
            torch.cuda.reset_peak_memory_stats()
            prof.reset()
            prof.enable()
            t0 = time.time()
            proofs = prove_batch()
            plain_s = time.time() - t0
            stages = prof.report()
            prof.enable(False)
            peak = torch.cuda.max_memory_allocated()
            assert verify(keys.vk, syns[-1].public_inputs, proofs[-1])
            t0 = time.time()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
                prove_batch()
            traced_s = time.time() - t0
            rows = kernel_rows(p)
            del p
            device_s = sum(r[1] for r in rows) / 1e6
            results.append({
                "card": card, "k": k, "n": keys.index.n, "m": keys.index.m,
                "msm_affine_mode": mode,
                "batch_seconds": plain_s, "seconds_per_proof": plain_s / k,
                "single_proof_seconds": single_s,
                "batch_seconds_traced": traced_s,
                "device_kernel_seconds": device_s,
                "device_busy_share_of_untraced_wall": device_s / plain_s,
                "kernel_launches": sum(r[2] for r in rows),
                "peak_device_bytes": peak,
                "by_pattern": by_pattern(rows),
                "stages": stages,
                "top_kernels": [
                    {"name": name[:80], "device_ms": us / 1e3, "count": c}
                    for name, us, c in rows[:12]
                ],
            })
            print(json.dumps(results[-1]), flush=True)
    finally:
        config.MSM_AFFINE_MODE = default_mode
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(json.dumps(results) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
