#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (aleo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, as below
    python3 chip_smoke.py kernels    # only the named phases (device always runs)

Phases, each printing one JSON line with its seconds:

  device    the card's name and power limit; builds the CUDA kernels from
            aleo_tpu_torch/csrc/ with nvcc
  kernels   fq_prepare, fq_mul, fq_fermat, fq_apply each against its plain
            PyTorch version on the card (exact equality after normalize) at
            the lane grid of a 32768-point MSM, edge-case lanes planted among
            random ones; then madd and batch_inv_lf whole. `ms` is a kernel's
            device time (replays of a captured CUDA graph over buffers larger
            than the L2 cache); `plain_ms`, `madd_ms` and `batch_inv_lf_ms`
            are whole calls, host side included
  msm       msm_host at 2^12 points against the host Pippenger oracle; NTT
            round trip and one coset NTT at 2^17 against host evaluation
  micro     keys, proof and verification of micro.aleo/bump
  transfer  the main path at full size: synthesize_keys, prove_execution and
            verify_execution of token.aleo/transfer (examples/simple_token),
            with the kernels' launch counts set to 0 just before and read
            just after

It fails (non-zero exit, no result line) without CUDA, if the build fails,
or if any phase fails. The last line of its output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds. `bound_ms` is the larger of bytes / 3.35 TB/s (each input read once,
each output written once) and operations / 16.75e12 per second, where one
operation is one 32-bit integer multiply-add instruction (a 32x32->64
multiply-accumulate is two) and the rate is half the card's published
float32 rate of 67 TFLOP/s = 33.5e12 multiply-adds per second, since an SM
has half as many int32 lanes as float32 lanes.
"""

import json
import random
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: no CUDA device: this script runs on the GPU only\n")
    sys.exit(1)

from aleo_tpu_torch import _build, params
from aleo_tpu_torch.curves import g1_affine as ga
from aleo_tpu_torch.fields import fr_lf as lf
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.msm import msm as msm_mod
from aleo_tpu_torch.ntt import ntt as dntt
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.program.examples import load_example
from aleo_tpu_torch.program.interpreter import Registry
from aleo_tpu_torch.program.parser import parse_program
from aleo_tpu_torch.program.values import Record, Value
from aleo_tpu_torch.reference import polynomial as rpoly
from aleo_tpu_torch.reference.curve import G1
from aleo_tpu_torch.reference.msm import msm_pippenger_jac
from aleo_tpu_torch.snark import pipeline
from aleo_tpu_torch.snark.verifier import verify
from aleo_tpu_torch.utils import profiling as prof

DEV = torch.device("cuda")
Q, R = params.Q, params.R
L = params.FQ_LIMBS
SEED = 20240229

HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 16.75e12
MADS_PER_PRODUCT = 2 * 2 * 12 * 12      # two 12x12-word passes, 2 instructions each

# lane grid of a 32768-point MSM at auto_c = 12: 22 windows x 2048 buckets
# plus one eighth of spare lanes
M_GRID = 22 * 2048 * 9 // 8             # 50688
M_FERMAT = ga.FERMAT_W                  # 128

KERNELS = {
    "fq_prepare": "aleo_tpu/curves/g1_affine.py:240",
    "fq_mul": "aleo_tpu/curves/g1_affine.py:300",
    "fq_fermat": "aleo_tpu/curves/g1_affine.py:319",
    "fq_apply": "aleo_tpu/curves/g1_affine.py:273",
}

MICRO = """
program micro.aleo;

function bump:
    input r0 as u64.private;
    add r0 1u64 into r1;
    output r1 as u64.private;
"""


def say(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def fq_tensor(ints):
    return limbs.to_tensor(limbs.ints_to_limbs(ints, L).T, DEV)


def norm(t):
    return lk.normalize(lk.get_fq(), t)


def same(a, b):
    """Exact equality of two Fq limb tensors after normalize -> max |diff|."""
    return int((norm(a).to(torch.int64) - norm(b).to(torch.int64)).abs().max().item())


def kernel_ms(launch, sets, reps=10):
    """Device time of one kernel launch, in ms. `launch(args)` is called once
    for each argument tuple of `sets` while a CUDA graph is captured, and the
    graph's replays are timed with events: the wrappers' host time is not in
    it. The sets are distinct buffers of more than the 50 MB L2 cache in
    all, so each launch finds its inputs in device memory as a round of the
    MSM does."""
    for args in sets:
        launch(args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in sets:
            launch(args)
    graph.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * len(sets))


def copies(args, n):
    """n argument tuples: the given one and n - 1 clones of it."""
    return [args] + [tuple(t.clone() for t in args) for _ in range(n - 1)]


def cuda_ms(fn, reps):
    """Time of one call in ms, host side included (events around a loop)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


# ---------------------------------------------------------------------------


def phase_device():
    t0 = time.time()
    line = smi_line()
    print(line, flush=True)
    _build.library()
    ptxas = [ln for ln in _build.BUILD_LOG.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    say({"phase": "device", "card": line, "torch": torch.__version__,
         "cuda": torch.version.cuda, "ptxas": ptxas, "seconds": round(time.time() - t0, 3)})
    return line


def _grid_inputs(rng, m):
    """Random lazy (< 2p) accumulator and addend lanes with the rare cases
    planted: tangent (equal points, also with the +p representative),
    cancellation (P == -acc, by value and by sign), identities on either
    side, the (0, 0) sentinel, invalid lanes."""
    x1 = [rng.randrange(2 * Q) for _ in range(m)]
    y1 = [rng.randrange(1, 2 * Q) for _ in range(m)]
    x2 = [rng.randrange(2 * Q) for _ in range(m)]
    y2 = [rng.randrange(1, 2 * Q) for _ in range(m)]
    inf1 = [0] * m
    inf2 = [0] * m
    sign = [rng.randrange(2) for _ in range(m)]
    valid = [1] * m
    for k in range(0, m, 97):
        kind = (k // 97) % 8
        a, b = x1[k] % Q, y1[k] % Q or 1
        x1[k], y1[k] = a, b
        if kind == 0:      # tangent, same representative
            x2[k], y2[k], sign[k] = a, b, 0
        elif kind == 1:    # tangent by sign: the differences come out as p
            x2[k], y2[k], sign[k] = a + Q, Q - b, 1
        elif kind == 2:    # P == -acc by value
            x2[k], y2[k], sign[k] = a, Q - b, 0
        elif kind == 3:    # P == -acc by sign, lazy x
            x2[k], y2[k], sign[k] = a + Q, b, 1
        elif kind == 4:    # acc identity
            inf1[k], x1[k], y1[k] = 1, 0, 0
        elif kind == 5:    # addend identity: the (0, 0) sentinel
            inf2[k], x2[k], y2[k] = 1, 0, 0
        elif kind == 6:    # both identity
            inf1[k], inf2[k], x1[k], y1[k], x2[k], y2[k] = 1, 1, 0, 0, 0, 0
        else:              # invalid lane
            valid[k] = 0
    flag = lambda v: torch.tensor([v], dtype=torch.int32, device=DEV)
    return (fq_tensor(x1), fq_tensor(y1), flag(inf1), fq_tensor(x2), fq_tensor(y2),
            flag(inf2), flag(sign), flag(valid))


def _madd_plain(x1, y1, inf1, x2, y2, inf2, sign, valid):
    """madd from the plain versions alone (every lane inverted on its own)."""
    d, num, case = ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    return ga._apply_plain(x1, y1, inf1, x2, y2, sign, case, num, ga._fermat_plain(d))


def phase_kernels():
    t0 = time.time()
    rng = random.Random(SEED)
    m = M_GRID
    x1, y1, inf1, x2, y2, inf2, sign, valid = _grid_inputs(rng, m)
    res = {}

    # fq_prepare
    d, num, case = ga.fq_prepare(x1, y1, inf1, x2, y2, inf2, sign, valid)
    dp, nump, casep = ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    torch.cuda.synchronize()
    err = max(same(d, dp), same(num, nump), int((case - casep).abs().max().item()))
    counts = [int((casep == k).sum().item()) for k in range(4)]
    assert min(counts) > 0, f"a case has no lane: {counts}"
    res["fq_prepare"] = {
        "max_abs_err": err, "lanes": m, "case_lanes": counts,
        "ms": kernel_ms(lambda a: ga.fq_prepare(*a),
                        copies((x1, y1, inf1, x2, y2, inf2, sign, valid), 4)),
        "plain_ms": cuda_ms(lambda: ga._prepare_plain(x1, y1, inf1, x2, y2, inf2, sign, valid), 3),
        "bytes": (6 * 4 * L + 5 * 4) * m, "mads": MADS_PER_PRODUCT * m,
    }

    # fq_mul (also on row-strided halves, as the inversion tree calls it)
    prod = ga.fq_mul(x1, y2)
    err = same(prod, ga._mul_plain(x1, y2))
    half = m // 2
    err = max(err, same(ga.fq_mul(x1[:, :half], x1[:, half:]),
                        ga._mul_plain(x1[:, :half], x1[:, half:])))
    res["fq_mul"] = {
        "max_abs_err": err, "lanes": m,
        "ms": kernel_ms(lambda a: ga.fq_mul(*a), copies((x1, y2), 8)),
        "plain_ms": cuda_ms(lambda: ga._mul_plain(x1, y2), 5),
        "bytes": 3 * 4 * L * m, "mads": MADS_PER_PRODUCT * m,
    }

    # fq_fermat at the root width: random lazy lanes, 1, p + 1, p - 1, 2p - 1
    vals = [rng.randrange(1, 2 * Q) for _ in range(M_FERMAT)]
    vals = [v if v % Q else 1 for v in vals]
    vals[:4] = [1, Q + 1, Q - 1, 2 * Q - 1]
    fx = fq_tensor(vals)
    finv = ga.fq_fermat(fx)
    err = same(finv, ga._fermat_plain(fx))
    err = max(err, same(ga.fq_mul(finv, fx), ga._one_mont(DEV).expand(L, M_FERMAT)))
    exp_products = (Q - 2).bit_length() - 1 + bin(Q - 2).count("1") - 1
    res["fq_fermat"] = {
        "max_abs_err": err, "lanes": M_FERMAT,
        "ms": kernel_ms(lambda a: ga.fq_fermat(*a), copies((fx,), 2)),
        "plain_ms": cuda_ms(lambda: ga._fermat_plain(fx), 3),
        "bytes": 2 * 4 * L * M_FERMAT,
        "mads": exp_products * MADS_PER_PRODUCT * M_FERMAT,
    }

    # fq_apply, fed the true inverses of the prepared denominators
    inv = ga._fermat_plain(dp)
    ox, oy, oinf = ga.fq_apply(x1, y1, inf1, x2, y2, sign, casep, nump, inv)
    px, py, pinf = ga._apply_plain(x1, y1, inf1, x2, y2, sign, casep, nump, inv)
    torch.cuda.synchronize()
    err = max(same(ox, px), same(oy, py), int((oinf - pinf).abs().max().item()))
    res["fq_apply"] = {
        "max_abs_err": err, "lanes": m,
        "ms": kernel_ms(lambda a: ga.fq_apply(*a),
                        copies((x1, y1, inf1, x2, y2, sign, casep, nump, inv), 4)),
        "plain_ms": cuda_ms(lambda: ga._apply_plain(x1, y1, inf1, x2, y2, sign, casep, nump, inv), 3),
        "bytes": (8 * 4 * L + 4 * 4) * m, "mads": 3 * MADS_PER_PRODUCT * m,
    }

    # batch_inv_lf and madd whole (odd widths exercise the padding with one)
    for w in (m, 1001, 129, 1):
        binv = ga.batch_inv_lf(dp[:, :w].contiguous())
        assert same(binv, inv[:, :w]) == 0, f"batch_inv_lf disagrees at width {w}"
    acc = ga.G1AF(x1, y1, inf1)
    got = ga.madd(acc, x2, y2, inf2, sign, valid)
    assert same(got.x, px) == 0 and same(got.y, py) == 0
    assert int((got.inf - pinf).abs().max().item()) == 0
    wx, wy, winf = _madd_plain(x1, y1, inf1, x2, y2, inf2, sign, valid)
    assert same(got.x, wx) == 0 and same(got.y, wy) == 0
    madd_ms = cuda_ms(lambda: ga.madd(acc, x2, y2, inf2, sign, valid), 5)
    binv_ms = cuda_ms(lambda: ga.batch_inv_lf(dp), 5)
    torch.cuda.synchronize()

    for name, r in res.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        by_ops = r["mads"] / INT32_MADS_PER_S * 1e3
        r["bound_ms"] = max(by_bytes, by_ops)
        r["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        assert r["max_abs_err"] == 0, f"{name} disagrees with its plain version"
    say({"phase": "kernels", "kernels": res, "madd_ms": madd_ms,
         "batch_inv_lf_ms": binv_ms, "seconds": round(time.time() - t0, 3)})
    return res


def phase_msm():
    t0 = time.time()
    rng = random.Random(SEED + 1)
    n = 1 << 12
    g = G1.generator()
    p = G1.mul(rng.randrange(1, R), g)
    pts = []
    for _ in range(n):
        pts.append(p)
        p = G1.add(p, g)
    rng.shuffle(pts)
    scalars = [rng.randrange(R) for _ in range(n)]
    scalars[0], scalars[1], scalars[2], pts[3] = 0, R - 1, 1, None
    ga.reset_launches()
    t1 = time.time()
    got = msm_mod.msm_host(scalars, pts, device=DEV)
    torch.cuda.synchronize()
    msm_s = time.time() - t1
    assert got == msm_pippenger_jac(scalars, pts), "msm_host disagrees with the oracle"
    launches = dict(ga.LAUNCHES)

    n = 1 << 17
    coeffs = [rng.randrange(R) for _ in range(n)]
    a = lf.encode(coeffs, device=DEV)
    t1 = time.time()
    ev = dntt.ntt_lf(a)
    torch.cuda.synchronize()
    ntt_s = time.time() - t1
    assert lf.decode(dntt.intt_lf(ev)) == coeffs, "NTT round trip failed at 2^17"
    dom = dntt.domain(n)
    shift = params.FR_GENERATOR
    t1 = time.time()
    cev = dntt.coset_ntt_lf(a, shift)
    torch.cuda.synchronize()
    coset_s = time.time() - t1
    idx = [0, 1, 77777, n - 1]
    ev_h = lf.decode(ev[:, idx])
    cev_h = lf.decode(cev[:, idx])
    for k, i in enumerate(idx):
        x = pow(dom.w, i, R)
        assert ev_h[k] == rpoly.evaluate(coeffs, x), f"NTT wrong at {i}"
        assert cev_h[k] == rpoly.evaluate(coeffs, shift * x % R), f"coset NTT wrong at {i}"
    say({"phase": "msm", "msm_points": 1 << 12, "msm_seconds": msm_s,
         "msm_launches": launches, "ntt_lanes": n, "ntt_seconds": ntt_s,
         "coset_ntt_seconds": coset_s, "seconds": round(time.time() - t0, 3)})


def phase_micro(srs):
    t0 = time.time()
    reg = Registry()
    reg.add(parse_program(MICRO))
    t1 = time.time()
    keys = pipeline.synthesize_keys(reg, "micro.aleo", "bump", srs=srs, cache=False)
    torch.cuda.synchronize()
    keys_s = time.time() - t1
    t1 = time.time()
    ep = pipeline.prove_execution(keys, reg, [Value("u64", 41)], rng=random.Random(7))
    torch.cuda.synchronize()
    prove_s = time.time() - t1
    assert ep.transition.outputs[0].data == 42
    t1 = time.time()
    assert pipeline.verify_execution(keys, ep), "micro proof does not verify"
    say({"phase": "micro", "n": keys.index.n, "m": keys.index.m,
         "keys_seconds": keys_s, "prove_seconds": prove_s,
         "verify_seconds": time.time() - t1, "seconds": round(time.time() - t0, 3)})


def phase_transfer(srs):
    """The main path, at the full size of token.aleo/transfer."""
    t0 = time.time()
    reg = load_example("simple_token")
    sender, receiver = 123456789, 987654321
    rec = Record(
        "token.aleo", "token", owner=sender, gates=0,
        entries={"amount": Value("u64", 500)}, nonce=7,
    )
    inputs = [rec, Value("address", receiver), Value("u64", 120)]

    ga.reset_launches()
    prof.reset()
    prof.enable()
    t1 = time.time()
    keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", srs=srs, cache=False)
    torch.cuda.synchronize()
    keys_s = time.time() - t1
    keys_launches = dict(ga.LAUNCHES)
    t1 = time.time()
    ep = pipeline.prove_execution(keys, reg, inputs, caller=sender,
                                  rng_nonce=lambda: 11, rng=random.Random(SEED))
    torch.cuda.synchronize()
    prove_s = time.time() - t1
    t1 = time.time()
    ok = pipeline.verify_execution(keys, ep, debug=True)
    verify_s = time.time() - t1
    launches = dict(ga.LAUNCHES)          # the main path's counts
    stages = prof.report()
    prof.enable(False)

    proof_launches = {k: launches[k] - keys_launches[k] for k in launches}
    assert ok, "transfer proof does not verify"
    assert [r.entries["amount"].data for r in ep.transition.created_records] == [120, 380]
    bad = list(ep.public_inputs)
    bad[2] = (bad[2] + 1) % R
    assert not verify(keys.vk, bad, ep.proof), "tampered public input was accepted"
    assert (keys.index.n, keys.index.m) == (8192, 32768), (keys.index.n, keys.index.m)
    for k, v in proof_launches.items():
        assert v > 0, f"{k} was never launched during the proof"
    say({"phase": "transfer", "n": keys.index.n, "m": keys.index.m, "ell": keys.index.ell,
         "constraints": keys.constraint_counts["total"],
         "keys_seconds": keys_s,
         "synthesis_seconds": stages["pipeline/synthesize"]["seconds"],
         "prove_seconds": prove_s, "verify_seconds": verify_s,
         "launches_keys": keys_launches, "launches_proof": proof_launches,
         "stages": stages, "peak_device_bytes": torch.cuda.max_memory_allocated(),
         "seconds": round(time.time() - t0, 3)})
    return launches


def main(argv):
    t_all = time.time()
    want = set(argv) or {"kernels", "msm", "micro", "transfer"}
    card = phase_device()
    kres = phase_kernels() if "kernels" in want else None
    if "msm" in want:
        phase_msm()
    launches = None
    if want & {"micro", "transfer"}:
        t0 = time.time()
        # one SRS for both circuits: max(2n + 1, m) + 1 powers for n = 8192,
        # m = 32768 (micro needs fewer and takes the same one)
        deg = 32769 if "transfer" in want else 8193
        srs = Srs.generate(deg, device=DEV)
        say({"phase": "srs", "powers": deg + 1, "seconds": round(time.time() - t0, 3)})
        if "micro" in want:
            phase_micro(srs)
        if "transfer" in want:
            launches = phase_transfer(srs)
    if kres is not None and launches is not None:
        say({"kernels": [
            {"name": name, "route": "cuda",
             "source": "aleo_tpu_torch/csrc/g1_affine.cu", "replaces": KERNELS[name],
             "launches": launches[name], "max_abs_err": r["max_abs_err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
             "bound_by": r["bound_by"], "library_ms": None}
            for name, r in kres.items()
        ]})
    torch.cuda.synchronize()
    print(card, flush=True)
    say({"total_seconds": round(time.time() - t_all, 3)})
    if want != {"kernels", "msm", "micro", "transfer"}:
        print("partial run: no result line", flush=True)
        return 0
    say({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
