"""The port's measurement entry point: the twin of the JAX package's root
`bench.py`, its sections, sizes and output, on the GPU.

    python -m aleo_tpu_torch.bench                          # batch-affine MSM
    ALEO_TORCH_MSM_AFFINE=0 python -m aleo_tpu_torch.bench  # projective MSM

Prints ONE JSON line on stdout:
  {"metric": "msm_g1_2e16_points_per_sec", "value": N, "unit": "points/s",
   "vs_baseline": N}

Headline metric: G1 MSM points/s at 2^16 on the production path
(`msm_fast_host`, the routine every KZG commitment of the prover takes),
window from `auto_c`. `vs_baseline` is against BASELINE.md's CPU anchor
(a multicore arkworks/snarkVM-class Pippenger for BLS12-377, ~5e5 points/s).

Secondary metrics go to stderr with one `BENCH_DETAIL <json>` line, under the
JAX bench's key names: the 2^16 MSM and a batch of four over one table; a
2^24 variable-base MSM in four chunks of 2^22 points; NTTs at 2^16, 2^20 and
2^22 and coset NTTs at 2^20 and 2^22; the simple_token transfer proof; the
batch prover at k = 4, 8 and 16, every proof verified.

One departure from the JAX bench: a section that raises or runs out of time
is logged with its traceback, the JSON line is still printed (with a null
value when the MSM section failed), and `main` returns 1.

Every section takes the device and its sizes as parameters, with the JAX
bench's values as defaults; `device=None` means CUDA and raises without it.
The inputs are the JAX bench's: the same 64 host points tiled, the same
numpy scalar draws, the same NTT values.
"""

from __future__ import annotations

import json
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from . import params
from .curves import g1
from .curves.g1 import G1Points
from .fields import fr_lf as lf
from .fields import limbs
from .msm import msm as msm_mod
from .ntt import ntt as dntt
from .reference.curve import G1
from .reference.msm import msm_pippenger_jac

CPU_ANCHOR_MSM_PPS = 5.0e5  # BASELINE.md: CPU anchor for the 2^16 MSM
# CPU anchor for the NTT: a multicore arkworks/snarkVM-class radix-2 FFT over
# Fr runs a 2^20 transform in ~150 ms on a 16-core box -> ~7e7 butterflies/s
# (BASELINE.md, "NTT anchor")
CPU_ANCHOR_NTT_BFLY = 7.0e7

MSM_N = 1 << 16
TILE = 64               # distinct host points, tiled over the MSM's n
NTT_VALUES = 1 << 12    # distinct NTT input values, tiled over the transform


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _log2(n: int) -> int:
    return n.bit_length() - 1


# -- inputs ----------------------------------------------------------------------


def host_points():
    """The JAX bench's 64 distinct host points: P_0 = G, P_(j+1) = 2 P_j + G."""
    base = G1.generator()
    pts, cur = [], base
    for _ in range(TILE):
        pts.append(cur)
        cur = G1.add(cur, G1.add(cur, base))
    return pts


def _tiled_points(n: int, device=None) -> G1Points:
    """n points, point i = P_(i mod 64): the 64 host points encoded once and
    tiled on the device (the order of the JAX bench's `host_pts * (n // 64)`)."""
    assert n % TILE == 0
    device = limbs.resolve_device(device)
    enc = g1.encode_points(host_points(), device=device)
    return G1Points(*(a.repeat(n // TILE, 1) for a in enc))


def _rand_limbs(n: int, seed: int) -> np.ndarray:
    """(n, 16) uint32 16-bit limbs of scalars below 2^252 (< r): the JAX
    bench's numpy draw."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    a[:, 15] &= 0x0FFF
    return a


def _rand_scalars(n: int, seed: int, device=None) -> torch.Tensor:
    """The same draw as (n, 16) int32 scalar limbs on the device."""
    device = limbs.resolve_device(device)
    return torch.from_numpy(_rand_limbs(n, seed).astype(np.int32)).to(device)


def class_sums(*scalar_limbs: np.ndarray) -> np.ndarray:
    """(64, 16) int64: limb l of row j is the sum of limb l over the scalars
    i = j mod 64 of every (n, 16) array given (each an MSM over the tiled
    points). Exact while each class holds fewer than 2^47 scalars."""
    sums = np.zeros((TILE, 16), dtype=np.int64)
    for a in scalar_limbs:
        assert a.shape[0] % TILE == 0 and a.shape[0] // TILE < 1 << 40
        sums += a.reshape(-1, TILE, 16).sum(axis=0, dtype=np.int64)
    return sums


def tiled_oracle(sums: np.ndarray):
    """The host value of MSMs over the tiled points from their class sums:
    sum_j (sum_(i = j mod 64) s_i mod r) P_j, a host MSM of 64 points (the
    Jacobian Pippenger of reference/msm.py) -> host affine point (None for
    the identity)."""
    scalars = [sum(int(v) << (16 * k) for k, v in enumerate(row)) % params.R for row in sums]
    return msm_pippenger_jac(scalars, host_points(), 5)


def _ntt_values(rng, device):
    """(16, 4096) Montgomery limbs of the next 4096 values of the JAX bench's
    NTT draw."""
    return lf.encode(
        [int.from_bytes(rng.bytes(31), "little") % params.R for _ in range(NTT_VALUES)],
        device=device,
    )


def _chain(x: torch.Tensor, iters: int, shift: int | None = None) -> torch.Tensor:
    """`iters` dependent forward transforms (coset ones when `shift` is given)."""
    for _ in range(iters):
        x = dntt.ntt_lf(x) if shift is None else dntt.coset_ntt_lf(x, shift)
    return x


def _checksum(v: torch.Tensor) -> int:
    """The JAX bench's readback: the sum of every stored limb mod 2^32."""
    return int(v.to(torch.int64).sum().item()) & 0xFFFFFFFF


# -- sections --------------------------------------------------------------------


def bench_msm(detail, device=None, n=MSM_N, iters=5, k=4):
    """The production MSM at n points, then `msm_batch_host` over k MSMs of
    one table (the commit-group shape of the prover). -> (points/s, the
    MSM's point, the batch's points)."""
    device = limbs.resolve_device(device)
    logn = _log2(n)
    log("building MSM inputs...")
    table = msm_mod.make_table(_tiled_points(n, device))
    scalars = _rand_scalars(n, 0xBE7C, device)
    c = msm_mod.auto_c(n)

    log(f"first MSM (c={c}, kernels built if not yet)...")
    t0 = time.time()
    out = msm_mod.msm_fast_host(scalars, table, c=c)
    compile_s = time.time() - t0
    log(f"MSM first run: {compile_s:.1f}s")
    _sync(device)
    t0 = time.time()
    for _ in range(iters):
        out = msm_mod.msm_fast_host(scalars, table, c=c)
    _sync(device)
    msm_s = (time.time() - t0) / iters
    msm_pps = n / msm_s
    log(f"MSM 2^{logn} (production path, c={c}): {msm_s*1e3:.1f} ms -> {msm_pps:,.0f} points/s")
    detail[f"msm_2e{logn}_ms"] = round(msm_s * 1e3, 2)
    detail["msm_compile_s"] = round(compile_s, 1)

    # the JAX bench's count model of the work: W * n bucket adds and the
    # reduction's ~3 * W * 2^(c-1), ~7 Fq products an add, 1728 32-bit
    # multiplies a product of 24 16-bit limbs; a count, not a device rate
    W = -(-254 // c)
    adds = W * n + 3 * W * (1 << (c - 1))
    u32_rate = adds * 7 * 1728 / msm_s
    detail["msm_u32_mul_g_per_s"] = round(u32_rate / 1e9, 1)
    log(f"MSM count model: ~{u32_rate/1e9:.1f} G counted u32-mul/s")

    sc_b = torch.stack([_rand_scalars(n, 100 + i, device) for i in range(k)])
    t0 = time.time()
    outs = msm_mod.msm_batch_host(sc_b, table, c=c)
    log(f"batch MSM first: {time.time()-t0:.1f}s")
    _sync(device)
    t0 = time.time()
    for _ in range(iters):
        outs = msm_mod.msm_batch_host(sc_b, table, c=c)
    _sync(device)
    batch_s = (time.time() - t0) / iters
    detail[f"msm_batch{k}_2e{logn}_ms"] = round(batch_s * 1e3, 2)
    detail[f"msm_batch{k}_pts_per_s"] = round(k * n / batch_s, 1)
    log(f"batch MSM k={k} x 2^{logn}: {batch_s*1e3:.1f} ms -> "
        f"{k*n/batch_s:,.0f} points/s amortized")
    return msm_pps, out, outs


def bench_msm_2e24(detail, device=None, chunk=1 << 22, n_chunks=4):
    """BASELINE config 4 on one card: a 2^24 variable-base MSM in chunks of
    2^22 points over one table (scalars from seeds 7000 on), the chunks'
    points added on the host. -> (the sum, the chunks' points)."""
    device = limbs.resolve_device(device)
    logn = _log2(chunk * n_chunks)
    log(f"MSM 2^{logn}: {n_chunks} chunks of 2^{_log2(chunk)}")
    table = msm_mod.make_table(_tiled_points(chunk, device))
    c = msm_mod.auto_c(chunk)
    scalars = [_rand_scalars(chunk, 7000 + i, device) for i in range(n_chunks)]
    msm_mod.msm_fast_host(scalars[0], table, c=c)      # first call at this size
    _sync(device)
    t0 = time.time()
    acc, parts = None, []
    for sc in scalars:
        parts.append(msm_mod.msm_fast_host(sc, table, c=c))
        acc = G1.add(acc, parts[-1])
    _sync(device)
    dt = time.time() - t0
    detail[f"msm_2e{logn}_s"] = round(dt, 2)
    detail[f"msm_2e{logn}_pts_per_s"] = round(chunk * n_chunks / dt, 1)
    log(f"MSM 2^{logn} (variable-base, chunked x{n_chunks}): {dt:.2f} s -> "
        f"{chunk*n_chunks/dt:,.0f} points/s")
    return acc, parts


def bench_ntt(detail, device=None, logns=(16, 20, 22), coset_logns=(20, 22)):
    """`iters` dependent NTTs (10, 5 from 2^22) on the 4096 values of the
    JAX bench's draw tiled over n, then one scalar readback; the same chain
    of coset NTTs at `coset_logns`. -> {detail key: checksum}."""
    device = limbs.resolve_device(device)
    rng = np.random.default_rng(0xA1E0)
    sums = {}
    for logn in logns:
        n = 1 << logn
        data = _ntt_values(rng, device).repeat(1, n // NTT_VALUES)
        iters = 5 if logn >= 22 else 10
        chains = [("ntt", None)]
        if logn in coset_logns:
            chains.append(("coset_ntt", params.FR_GENERATOR))
        for name, shift in chains:
            key = f"{name}_2e{logn}"
            t0 = time.time()
            _checksum(_chain(data, iters, shift))
            log(f"{name} 2^{logn} first: {time.time()-t0:.1f}s")
            t0 = time.time()
            sums[key] = _checksum(_chain(data, iters, shift))
            dt = (time.time() - t0) / iters
            detail[f"{key}_ms"] = round(dt * 1e3, 2)
            if shift is None:
                bf = n // 2 * logn
                log(f"NTT 2^{logn}: {dt*1e3:.2f} ms -> {bf/dt/1e6:,.1f} M butterflies/s "
                    f"(vs CPU anchor {bf/dt/CPU_ANCHOR_NTT_BFLY:.2f}x)")
                detail[f"{key}_mbfly_s"] = round(bf / dt / 1e6, 1)
                detail[f"{key}_vs_baseline"] = round(bf / dt / CPU_ANCHOR_NTT_BFLY, 2)
            else:
                log(f"coset NTT 2^{logn}: {detail[f'{key}_ms']} ms")
    return sums


def _transfer_inputs(amount, sender, receiver):
    from .program.values import Record, Value

    rec = Record("token.aleo", "token", owner=sender, gates=0,
                 entries={"amount": Value("u64", 500)}, nonce=7)
    return [rec, Value("address", receiver), Value("u64", amount)]


def bench_proof(detail, device=None):
    """simple_token transfer (BASELINE config 3): keys once (deploy-time
    work, not timed), a first proof, verified, then two timed proofs."""
    from .program.examples import load_example
    from .snark import pipeline

    device = limbs.resolve_device(device)
    log("synthesizing simple_token transfer keys (deploy-time)...")
    t0 = time.time()
    reg = load_example("simple_token")
    keys = pipeline.synthesize_keys(reg, "token.aleo", "transfer", device=device)
    log(f"keys: {time.time()-t0:.1f}s  n={keys.index.n} m={keys.index.m} "
        f"constraints={keys.constraint_counts['total']}")
    sender, receiver = 123456789, 987654321

    t0 = time.time()
    ep = pipeline.prove_execution(
        keys, reg, _transfer_inputs(120, sender, receiver), caller=sender
    )
    log(f"first proof: {time.time()-t0:.1f}s")
    ok = pipeline.verify_execution(keys, ep)
    log(f"verify: {ok}")
    if not ok:
        raise RuntimeError("proof did not verify")
    iters = 2
    _sync(device)
    t0 = time.time()
    for i in range(iters):
        ep = pipeline.prove_execution(
            keys, reg, _transfer_inputs(100 + i, sender, receiver), caller=sender
        )
    _sync(device)
    proof_s = (time.time() - t0) / iters
    log(f"simple_token transfer proof: {proof_s:.2f} s -> {1/proof_s:.3f} proofs/s")
    detail["transfer_proof_s"] = round(proof_s, 2)
    detail["transfer_proofs_per_s"] = round(1 / proof_s, 4)
    detail["transfer_constraints"] = keys.constraint_counts["total"]
    return keys, reg, sender, receiver


def bench_batch_proof(detail, keys, reg, sender, receiver, ks=(4, 8, 16)):
    """BASELINE config 5: same-circuit transfers in one `prove_batch`, at each
    k a first batch whose every proof is verified, then a timed one."""
    from .program.synthesizer import synthesize_execution
    from .snark.batch import prove_batch
    from .snark.verifier import verify

    def mk_cs(i):
        return synthesize_execution(
            reg, "token.aleo", "transfer",
            _transfer_inputs(100 + i, sender, receiver), caller=sender,
        ).cs

    device = keys.index.srs.device
    cs_pool = [mk_cs(i) for i in range(max(ks))]
    best = None
    for k in ks:
        cs_list = cs_pool[:k]
        t0 = time.time()
        proofs = prove_batch(keys.index, cs_list)
        log(f"batch prove k={k} first: {time.time()-t0:.1f}s")
        oks = [verify(keys.vk, cs.public_inputs(), pf) for cs, pf in zip(cs_list, proofs)]
        if not all(oks):
            raise RuntimeError(f"batch k={k}: proofs {[i for i, ok in enumerate(oks) if not ok]} "
                               "did not verify")
        _sync(device)
        t0 = time.time()
        prove_batch(keys.index, cs_list)
        _sync(device)
        batch_s = time.time() - t0
        detail[f"batch{k}_total_s"] = round(batch_s, 2)
        detail[f"batch{k}_s_per_proof"] = round(batch_s / k, 2)
        detail[f"batch{k}_proofs_per_s"] = round(k / batch_s, 4)
        log(f"batch prove k={k}: {batch_s:.1f} s -> {batch_s/k:.2f} s/proof "
            f"({k/batch_s:.3f} proofs/s), all verify")
        if best is None or batch_s / k < best:
            best = batch_s / k
    detail["batch_best_s_per_proof"] = round(best, 2)


# -- entry point -----------------------------------------------------------------


class _SectionTimeout(Exception):
    pass


def _with_timeout(fn, seconds, *args):
    """Run a section under SIGALRM, so that one that hangs cannot swallow the
    headline line (main thread only)."""

    def handler(signum, frame):
        raise _SectionTimeout(f"{fn.__name__} ran past {seconds} s")

    old = signal.signal(signal.SIGALRM, handler)
    signal.alarm(seconds)
    try:
        return fn(*args)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(device=None) -> int:
    """Every section in the JAX bench's order -> 0, or 1 when one failed."""
    device = limbs.resolve_device(device)
    log(f"device: {device}")
    if device.type == "cuda":
        log(f"card: {_card_line()}  torch {torch.__version__} cuda {torch.version.cuda}")
    detail, failed = {}, []

    def section(name, seconds, fn, *args):
        try:
            return _with_timeout(fn, seconds, *args)
        except Exception:  # a section's failure is reported, and main fails
            log(f"{name} failed:\n{traceback.format_exc()}")
            failed.append(name)
            return None

    msm = section("MSM bench", 900, bench_msm, detail, device)
    section("NTT bench", 900, bench_ntt, detail, device)
    section("2^24 MSM bench", 900, bench_msm_2e24, detail, device)
    proof_ctx = section("proof bench", 2400, bench_proof, detail, device)
    if proof_ctx is not None:
        section("batch proof bench", 2400, bench_batch_proof, detail, *proof_ctx)
    log("BENCH_DETAIL " + json.dumps(detail))
    msm_pps = msm[0] if msm is not None else None
    print(
        json.dumps(
            {
                "metric": "msm_g1_2e16_points_per_sec",
                "value": None if msm_pps is None else round(msm_pps, 1),
                "unit": "points/s",
                "vs_baseline": None if msm_pps is None else round(msm_pps / CPU_ANCHOR_MSM_PPS, 3),
            }
        ),
        flush=True,
    )
    if failed:
        log(f"failed sections: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
