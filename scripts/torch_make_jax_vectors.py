#!/usr/bin/env python3
"""Writes tests/torch_vectors/jax_reference.json: the JAX package's own
outputs at the full sizes and on the inputs of chip_smoke.py, so that the
port's results on the GPU can be held against the reference byte for byte.

    python scripts/torch_make_jax_vectors.py                      # every entry
    python scripts/torch_make_jax_vectors.py --entries ntt,msm    # some of them

This is the one file on the port's side that imports the JAX package
(`aleo_tpu`). It lives under scripts/, outside `aleo_tpu_torch/`, because the
port and chip_smoke.py may not import JAX (tests/test_torch_imports.py holds
them to that): the vector file is the bridge between the two packages. It
runs the JAX package on the CPU (about 15 minutes for the transfer's keys and
proof, more for the batch of four; over two hours for every entry) and writes
each entry as soon as it is done, merged into the file under a lock, so
entries may be made by several runs side by side. A run of several groups of
entries (GROUPS) makes each group in a process of its own: one process over
all nine entries ran out of memory in XLA's CPU compiler at the last one.

The file is the single source of the inputs: chip_smoke.py takes its seeds,
amounts and sizes from each entry's `inputs` and fails if they differ from
its phase's constants or if an input digest differs. The entries:

  srs       the seed and degree of the SRS, sha256 over its G1 powers'
            compressed affine bytes (serialize.point_to_bytes) in index order
  transfer  token.aleo/transfer (n = 8192, m = 32768): the verifying key's
            n, m, ell and 12 index commitments, the public inputs, the proof
  batch     prove_batch over four transfers of amounts 100 to 103 under one
            seeded rng: each proof and its public inputs
  ntt       ntt.ntt and ntt.coset_ntt (shift FR_GENERATOR) at 2^20 and 2^22
            on chip_smoke.py's bench-phase check inputs: sha256 of the
            outputs as canonical integers (32 bytes little-endian each, index
            order) and eight sampled (index, value) pairs
  msm       the bench's 2^16 MSM (64 tiled host points, numpy scalars seeded
            0xBE7C) as compressed affine bytes
  poseidon  hash.poseidon.hash_batch over the record scan's 16384 rows of
            four at rates 2, 4 and 8: sha256 of the outputs as canonical
            integers, per rate
  credits   credits.aleo's transfer_private (n = 8192, m = 32768), join
            (4096, 32768) and transfer_public (2048, 8192), keys synthesized
            over the SRS, each proved once with the transfer's seed: per
            function the verifying key, the public inputs and the proof
  ecdh      edwards_device.shared_secrets over the record scan's on-curve
            ephemeral points (16383 of 16384: the planted off-curve point,
            which the port sends to the host ladder, is left out): the
            digest of the inputs, sha256 of the outputs (x, y canonical, lane
            order) and eight sampled lanes
  limbs_last  the limbs-last API on the draws of chip_smoke.py's phase
            limbs_last: FR_RING and FQ_RING mul, add, sub, neg, batch_inv and
            inv at 2^16 lanes, coset_ntt at 2^16, eval_coeffs and
            divide_by_linear_via_domain at m = 32768, poly_mul, divide_by_
            vanishing, kzg.commit, open_at and batch_open_at: digests of the
            canonical outputs and points as bytes, with the inputs' digests

Each entry records the seconds it took on this CPU; the file records the JAX
version and the commit it was made at. tests/test_torch_vectors.py reruns
these functions (its `slow` test) to renew or audit the file.
"""

from __future__ import annotations

import argparse
import fcntl
import hashlib
import json
import multiprocessing
import os
import pathlib
import queue as queue_mod
import random
import subprocess
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", os.path.expanduser("~/.cache/aleo_tpu_xla"))
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from aleo_tpu import params  # noqa: E402

OUT = ROOT / "tests" / "torch_vectors" / "jax_reference.json"
ENTRIES = ("srs", "transfer", "batch", "ntt", "msm", "poseidon", "credits", "ecdh",
           "limbs_last")
# entries made in one process: the transfer and the batch share the SRS and
# the transfer's keys; every other entry makes what it needs
GROUPS = (("srs", "transfer", "batch"), ("ntt",), ("msm",), ("poseidon",), ("credits",),
          ("ecdh",), ("limbs_last",))
R = params.R

# chip_smoke.py's constants: its seed, the transfer's parties and record, the
# batch's amounts, the bench phase's transform and MSM inputs, the record scan
SEED = 20240229
SRS_SEED, SRS_DEGREE = b"aleo-tpu-srs", 32769
TRANSFER = {"example": "simple_token", "program": "token.aleo", "function": "transfer",
            "sender": 123456789, "receiver": 987654321, "record_amount": 500,
            "record_nonce": 7, "amount": 120, "rng_nonce": 11, "rng_seed": SEED}
BATCH_AMOUNTS = [100, 101, 102, 103]
NTT_LOGNS = (20, 22)
NTT_SAMPLES = 8
MSM_N, MSM_SEED, MSM_TILE = 1 << 16, 0xBE7C, 64
MSM_TIMEOUT_S = 600
RS_SEED, RS_ROWS, RS_INPUTS, RS_RATES, RS_CHECKED = SEED + 11, 16384, 4, (2, 4, 8), 32
# phase credits: three credits.aleo functions, one of each (n, m) that the
# server, the worker and the CLI prove, the transfer's sender as owner and
# caller; records as [microcredits, nonce]
CREDITS = {"program": "credits.aleo", "caller": TRANSFER["sender"],
           "rng_nonce": TRANSFER["rng_nonce"], "rng_seed": SEED,
           "functions": {
               "transfer_private": {"n": 8192, "m": 32768, "records": [[1_000_000, 7]],
                                    "receiver": TRANSFER["receiver"], "amount": 250_000},
               "join": {"n": 4096, "m": 32768, "records": [[300_000, 7], [200_000, 8]]},
               "transfer_public": {"n": 2048, "m": 8192,
                                   "receiver": TRANSFER["receiver"], "amount": 50_000}}}
# phase record_scan's ECDH: 16384 ephemeral points, one off the curve; the
# JAX ladder runs over the first ECDH_LANES on-curve lanes
ECDH_POINTS, ECDH_LANES, ECDH_SAMPLES = 16384, 16383, 8
# phase limbs_last: the ring ops at 2^16 lanes (64 sampled lanes checked on
# the card); a transfer proof's |K| = m and |H| = n; poly_mul of two 16384-
# coefficient polynomials, divide_by_vanishing of 40960, 4 polynomials opened
LL_SEED, LL_LANES, LL_SAMPLE, LL_M, LL_N = SEED + 10, 1 << 16, 64, 32768, 8192
LL_MUL, LL_VANISH, LL_OPEN = 16384, 40960, 4


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def int_bytes(values, width: int = 32) -> bytes:
    """Canonical integers as `width` bytes little-endian each, in order."""
    return b"".join(int(v).to_bytes(width, "little") for v in values)


# -- inputs (the same draws as chip_smoke.py) --------------------------------------


def ntt_input(logn: int, seed: int) -> np.ndarray:
    """(2^logn, 16) uint16 limbs: random values below r, read as Montgomery
    forms (chip_smoke.py's `_ntt_check_limbs`)."""
    a = np.random.default_rng(seed).integers(0, 1 << 16, size=(1 << logn, 16), dtype=np.uint16)
    a[:, 15] %= R >> 240
    return a


def msm_scalars(n: int, seed: int) -> np.ndarray:
    """(n, 16) uint32 limbs of scalars below 2^252: the bench's numpy draw."""
    a = np.random.default_rng(seed).integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    a[:, 15] &= 0x0FFF
    return a


def msm_host_points():
    """The bench's 64 host points: P_0 = G, P_(j+1) = 2 P_j + G."""
    from aleo_tpu.reference.curve import G1

    base, pts = G1.generator(), []
    cur = base
    for _ in range(MSM_TILE):
        pts.append(cur)
        cur = G1.add(cur, G1.add(cur, base))
    return pts


def poseidon_rows(rng=None):
    """rate -> the record scan's rows, drawn as chip_smoke.py's phase
    record_scan draws them from one rng: per rate the rows, the sampled
    indices and the permutation's states, in that order."""
    rng = rng or random.Random(RS_SEED)
    out = {}
    for rate in RS_RATES:
        out[rate] = [[rng.randrange(R) for _ in range(RS_INPUTS)] for _ in range(RS_ROWS)]
        rng.sample(range(RS_ROWS), RS_CHECKED)
        for _ in range(RS_ROWS):
            for _ in range(rate + 1):
                rng.randrange(R)
    return out


def transfer_inputs(amount):
    from aleo_tpu.program.values import Record, Value

    rec = Record("token.aleo", "token", owner=TRANSFER["sender"], gates=0,
                 entries={"amount": Value("u64", TRANSFER["record_amount"])},
                 nonce=TRANSFER["record_nonce"])
    return [rec, Value("address", TRANSFER["receiver"]), Value("u64", amount)]


def credits_inputs(fn):
    """One credits.aleo function's inputs: its records (owned by the
    caller), then the receiver and the amount where it takes them."""
    from aleo_tpu.program.values import Record, Value

    spec = CREDITS["functions"][fn]
    out = [Record("credits.aleo", "credits", owner=CREDITS["caller"], gates=0,
                  entries={"microcredits": Value("u64", mc)}, nonce=nonce)
           for mc, nonce in spec.get("records", [])]
    if "receiver" in spec:
        out.append(Value("address", spec["receiver"]))
    if "amount" in spec:
        out.append(Value("u64", spec["amount"]))
    return out


def f5_point(rng):
    """chip_smoke.py's `_f5_point`: an off-curve point P with 1 + d*t = 0 in
    add(2P, P), drawn from rng."""
    from aleo_tpu.reference import edwards
    from aleo_tpu.reference.field import FR

    D = params.EDWARDS_D
    while True:
        u = rng.randrange(1, R)
        s = (D * D * pow(u, 4, R) - 1) * pow(2 * D * u * u, -1, R) % R
        disc = (s * s - 4 * u * u) % R
        if not FR.is_square(disc):
            continue
        x2 = (s + FR.sqrt(disc)) * pow(2, -1, R) % R
        if x2 == 0 or not FR.is_square(x2):
            continue
        x = FR.sqrt(x2)
        P = (x, u * pow(x, -1, R) % R)
        assert not edwards.is_on_curve(P)
        return P


def ecdh_inputs():
    """(view scalar, 16384 points, planted lane): the record scan's ECDH
    draws, after its Poseidon draws from the same rng."""
    from aleo_tpu.reference import edwards

    rng = random.Random(RS_SEED)
    poseidon_rows(rng)
    view = rng.randrange(3 << 248, 1 << 250) & ~1
    P, Q = edwards.rand(rng), edwards.rand(rng)
    pts = [P]
    for _ in range(ECDH_POINTS - 1):
        pts.append(edwards.add(pts[-1], Q))
    planted = rng.randrange(ECDH_POINTS)
    pts[planted] = f5_point(rng)
    return view, pts, planted


def ecdh_digest(view, pts) -> str:
    """sha256 of the view scalar and every point's (x, y), canonical."""
    return sha256(int_bytes([view] + [c for p in pts for c in p]))


def limbs_last_inputs():
    """chip_smoke.py's phase limbs_last draws from one rng, in its order:
    per ring (Fq, then Fr) the operands x, y, the inv operand z (x with
    three zero lanes) and the sampled lanes; then 2^16 coefficients, the
    coset NTT's checked index, z, three check points, the 40960
    coefficients to divide by v_H, the four polynomials to open, gamma."""
    from aleo_tpu.fields.modring import FQ_RING, FR_RING

    rng = random.Random(LL_SEED)
    out = {"rings": {}}
    for ring in (FQ_RING, FR_RING):
        p, n = ring.p, LL_LANES
        xs = [rng.randrange(1, p) for _ in range(n)]
        ys = [rng.randrange(p) for _ in range(n)]
        xs[:4] = [1, p - 1, 2, p - 2]
        ys[:4] = [0, p - 1, p - 1, 1]
        zs = list(xs)
        for i in (5, n // 2, n - 1):
            zs[i] = 0
        rng.sample(range(n), LL_SAMPLE)
        out["rings"][ring.name] = (xs, ys, zs)
    out["coeffs"] = [rng.randrange(R) for _ in range(LL_LANES)]
    rng.randrange(LL_LANES)
    out["z"] = rng.randrange(R)
    rng.randrange(R)
    rng.randrange(R)
    out["vanish"] = [rng.randrange(R) for _ in range(LL_VANISH)]
    rng.randrange(R)
    out["open"] = [[rng.randrange(R) for _ in range(LL_N)] for _ in range(LL_OPEN)]
    out["gamma"] = rng.randrange(R)
    return out


def limbs_last_input_digests(ins) -> dict:
    """The inputs' digests that the entry stores and chip_smoke.py checks."""
    from aleo_tpu.fields.modring import FQ_RING, FR_RING

    out = {}
    for ring in (FQ_RING, FR_RING):
        xs, ys, zs = ins["rings"][ring.name]
        out[ring.name] = sha256(int_bytes(xs + ys + zs, 2 * ring.L))
    out["coeffs"] = sha256(int_bytes(ins["coeffs"]))
    out["vanish"] = sha256(int_bytes(ins["vanish"]))
    out["open"] = sha256(int_bytes(v for p in ins["open"] for v in p))
    out["z_gamma"] = sha256(int_bytes([ins["z"], ins["gamma"]]))
    return out


# -- entries -------------------------------------------------------------------------


def make_srs():
    from aleo_tpu.pcs.srs import Srs
    from aleo_tpu.snark.serialize import point_to_bytes

    srs = Srs.generate(SRS_DEGREE, seed=SRS_SEED)
    digest = hashlib.sha256()
    for p in srs.host_affine():
        digest.update(point_to_bytes(p))
    entry = {"inputs": {"seed": SRS_SEED.decode(), "max_degree": SRS_DEGREE},
             "powers": SRS_DEGREE + 1, "g1_powers_sha256": digest.hexdigest()}
    return entry, srs


def make_keys(srs):
    from aleo_tpu.program.examples import load_example
    from aleo_tpu.snark import pipeline

    reg = load_example(TRANSFER["example"])
    keys = pipeline.synthesize_keys(reg, TRANSFER["program"], TRANSFER["function"],
                                    srs=srs, cache=False)
    return reg, keys


def make_transfer(srs, reg, keys):
    from aleo_tpu.snark import pipeline, prover
    from aleo_tpu.snark.serialize import point_to_bytes, proof_to_bytes

    syn = pipeline.synthesize_and_check(keys, reg, transfer_inputs(TRANSFER["amount"]),
                                        TRANSFER["sender"], lambda: TRANSFER["rng_nonce"])
    proof = prover.prove(keys.index, syn.cs, rng=random.Random(TRANSFER["rng_seed"]))
    vk = keys.vk
    data = proof_to_bytes(proof, vk.n, vk.m, vk.ell)
    return {"inputs": dict(TRANSFER),
            "vk": {"n": vk.n, "m": vk.m, "ell": vk.ell,
                   "index_commitments": [point_to_bytes(p).hex() for p in vk.index_commitments]},
            "public_inputs": [str(v) for v in syn.public_inputs],
            "proof": data.hex(), "proof_sha256": sha256(data)}


def make_batch(srs, reg, keys):
    from aleo_tpu.snark import batch, pipeline
    from aleo_tpu.snark.serialize import proof_to_bytes

    syns = [pipeline.synthesize_and_check(keys, reg, transfer_inputs(a), TRANSFER["sender"],
                                          lambda: TRANSFER["rng_nonce"]) for a in BATCH_AMOUNTS]
    proofs = batch.prove_batch(keys.index, [s.cs for s in syns],
                               rng=random.Random(TRANSFER["rng_seed"]))
    vk = keys.vk
    return {"inputs": {**dict(TRANSFER, amount=None), "amounts": list(BATCH_AMOUNTS)},
            "proofs": [{"public_inputs": [str(v) for v in s.public_inputs],
                        "proof": proof_to_bytes(p, vk.n, vk.m, vk.ell).hex()}
                       for s, p in zip(syns, proofs)]}


def _ntt_outputs(name, values):
    """Digest and eight sampled (index, value) pairs of one transform's
    canonical integers; the indices from a seed made of the name."""
    rng = random.Random(name)
    idx = sorted(rng.sample(range(len(values)), NTT_SAMPLES))
    return {"sha256": sha256(int_bytes(values)),
            "samples": [[i, str(values[i])] for i in idx]}


def make_ntt(logn):
    from aleo_tpu.fields.modring import FR_RING
    from aleo_tpu.ntt import ntt

    seed = SEED + logn
    a = ntt_input(logn, seed)
    x = jnp.asarray(a.astype(np.uint32))
    out = {"inputs": {"logn": logn, "seed": seed, "shift": params.FR_GENERATOR,
                      "input_sha256": sha256(a.tobytes())}}
    for name, fn in (("ntt", ntt.ntt), ("coset_ntt", lambda v: ntt.coset_ntt(v, params.FR_GENERATOR))):
        t0 = time.time()
        y = np.asarray(fn(x))
        values = FR_RING.from_mont_host(y).tolist()
        out[name] = {**_ntt_outputs(f"{name}{logn}", values), "seconds": time.time() - t0}
        del y, values
    return out


def _in_child(target, args, timeout_s):
    """target(queue, *args) in a spawned process -> its first result, or
    None when it gives none within timeout_s seconds (or dies)."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=target, args=(queue, *args))
    proc.start()
    t0 = time.time()
    try:
        while time.time() - t0 < timeout_s:
            try:
                return queue.get(timeout=5)
            except queue_mod.Empty:
                if not proc.is_alive():     # died without a result
                    return None
        return None
    finally:
        proc.kill()
        proc.join()


def _msm_device(queue, n, seed):
    from aleo_tpu.curves import g1
    from aleo_tpu.msm import msm

    pts = g1.encode_points(msm_host_points() * (n // MSM_TILE))
    out = msm.msm(jnp.asarray(msm_scalars(n, seed)), pts)
    queue.put(g1.decode_points(g1.G1Points(*(c.reshape(1, -1) for c in out)))[0])


def make_msm():
    """The JAX `msm.msm` on the CPU backend in a child process; after
    MSM_TIMEOUT_S seconds without a result, the JAX package's host Pippenger."""
    from aleo_tpu.reference.msm import msm_pippenger_jac
    from aleo_tpu.snark.serialize import point_to_bytes

    t0 = time.time()
    point = _in_child(_msm_device, (MSM_N, MSM_SEED), MSM_TIMEOUT_S)
    method = "aleo_tpu.msm.msm.msm"
    if point is None:
        a = msm_scalars(MSM_N, MSM_SEED).astype(object)
        scalars = [sum(int(v) << (16 * k) for k, v in enumerate(row)) for row in a]
        point = msm_pippenger_jac(scalars, msm_host_points() * (MSM_N // MSM_TILE), 12)
        method = ("aleo_tpu.reference.msm.msm_pippenger_jac (msm.msm gave no result "
                  f"after {time.time() - t0:.0f} s on the CPU)")
    return {"inputs": {"n": MSM_N, "scalar_seed": MSM_SEED, "tile": MSM_TILE},
            "method": method, "point": point_to_bytes(point).hex()}


def make_poseidon():
    from aleo_tpu.fields.modring import FR_RING
    from aleo_tpu.hash import poseidon

    rows = poseidon_rows()
    entry = {"inputs": {"seed": RS_SEED, "rows": RS_ROWS, "inputs_per_row": RS_INPUTS,
                        "rates": list(RS_RATES),
                        "rows_sha256": {str(r): sha256(int_bytes(v for row in rows[r] for v in row))
                                        for r in RS_RATES}},
             "sha256": {}}
    for rate in RS_RATES:
        enc = FR_RING.encode([v for row in rows[rate] for v in row]).reshape(
            RS_ROWS, RS_INPUTS, FR_RING.L)
        out = poseidon.hash_batch(rate, enc)
        entry["sha256"][str(rate)] = sha256(int_bytes(FR_RING.decode(out).tolist()))
    return entry


def make_credits(srs):
    """Keys, one seeded proof and its bytes for each function of CREDITS."""
    from aleo_tpu.sdk.credits import registry_with_credits
    from aleo_tpu.snark import pipeline, prover
    from aleo_tpu.snark.serialize import point_to_bytes, proof_to_bytes

    reg = registry_with_credits()
    out = {"inputs": CREDITS, "functions": {}}
    for fn in CREDITS["functions"]:
        keys, keys_s = _timed(lambda: pipeline.synthesize_keys(
            reg, CREDITS["program"], fn, srs=srs, cache=False))
        t0 = time.time()
        syn = pipeline.synthesize_and_check(keys, reg, credits_inputs(fn), CREDITS["caller"],
                                            lambda: CREDITS["rng_nonce"])
        proof = prover.prove(keys.index, syn.cs, rng=random.Random(CREDITS["rng_seed"]))
        vk = keys.vk
        data = proof_to_bytes(proof, vk.n, vk.m, vk.ell)
        out["functions"][fn] = {
            "vk": {"n": vk.n, "m": vk.m, "ell": vk.ell,
                   "index_commitments": [point_to_bytes(p).hex() for p in vk.index_commitments]},
            "public_inputs": [str(v) for v in syn.public_inputs],
            "proof": data.hex(), "proof_sha256": sha256(data),
            "keys_seconds": keys_s, "prove_seconds": time.time() - t0}
        print(f"credits/{fn}: keys {keys_s:.1f} s, proof {time.time() - t0:.1f} s", flush=True)
    return out


def make_ecdh():
    """The JAX device ladder over the held on-curve lanes."""
    from aleo_tpu.curves import edwards_device

    view, pts, planted = ecdh_inputs()
    lanes = [i for i in range(ECDH_POINTS) if i != planted][:ECDH_LANES]
    got = edwards_device.shared_secrets(view, [pts[i] for i in lanes])
    rng = random.Random("ecdh")
    idx = sorted(rng.sample(range(len(lanes)), ECDH_SAMPLES))
    return {"inputs": {"seed": RS_SEED, "points": ECDH_POINTS, "planted": planted,
                       "lanes": len(lanes), "input_sha256": ecdh_digest(view, pts)},
            "sha256": sha256(int_bytes(c for p in got for c in p)),
            "samples": [[lanes[i], str(got[i][0]), str(got[i][1])] for i in idx]}


def _commit_device(queue, coeffs):
    from aleo_tpu.curves import g1
    from aleo_tpu.fields.modring import FR_RING
    from aleo_tpu.pcs import kzg
    from aleo_tpu.pcs.srs import Srs

    srs = Srs.generate(SRS_DEGREE, seed=SRS_SEED)
    out = kzg.commit(srs, FR_RING.encode(coeffs))
    queue.put(g1.decode_points(g1.G1Points(*(c.reshape(1, -1) for c in out)))[0])


def make_limbs_last(srs):
    """The limbs-last API's outputs on the phase's draws, as canonical
    values' digests (ring ops: 32 bytes an Fr value, 48 an Fq value)."""
    from aleo_tpu.fields.modring import FQ_RING, FR_RING
    from aleo_tpu.ntt import ntt
    from aleo_tpu.pcs import kzg
    from aleo_tpu.pcs import poly_device as pd
    from aleo_tpu.reference.msm import msm_pippenger_jac
    from aleo_tpu.snark.serialize import point_to_bytes

    ins = limbs_last_inputs()
    entry = {"inputs": {"seed": LL_SEED, "lanes": LL_LANES, "sample": LL_SAMPLE, "m": LL_M,
                        "n": LL_N, "mul": LL_MUL, "vanish": LL_VANISH, "open": LL_OPEN,
                        "input_sha256": limbs_last_input_digests(ins)}}
    fr_sha = lambda t: sha256(int_bytes(FR_RING.decode(t).tolist()))
    for ring in (FQ_RING, FR_RING):
        w = 2 * ring.L
        xs, ys, zs = ins["rings"][ring.name]
        a, b, z = (ring.encode(v) for v in (xs, ys, zs))
        ops = {"mul": (ring.mul, a, b), "add": (ring.add, a, b), "sub": (ring.sub, a, b),
               "neg": (ring.neg, a), "batch_inv": (ring.batch_inv, a), "inv": (ring.inv, z)}
        entry[ring.name] = {op: sha256(int_bytes(ring.decode(jax.jit(fn)(*args)).tolist(), w))
                            for op, (fn, *args) in ops.items()}
    x = FR_RING.encode(ins["coeffs"])
    entry["coset_ntt"] = fr_sha(ntt.coset_ntt(x, params.FR_GENERATOR))
    pdev, zd = x[:LL_M], FR_RING.const(ins["z"])
    entry["eval_coeffs"] = str(FR_RING.decode(pd.eval_coeffs(pdev, zd)))
    q, y = pd.divide_by_linear_via_domain(pdev, zd)
    entry["divide_by_linear"] = {"q": fr_sha(q), "y": str(FR_RING.decode(y))}
    entry["poly_mul"] = fr_sha(pd.poly_mul(x[:LL_MUL], x[LL_MUL:2 * LL_MUL]))
    vq, vr = pd.divide_by_vanishing(FR_RING.encode(ins["vanish"]), LL_N)
    entry["divide_by_vanishing"] = {"q": fr_sha(vq), "r": fr_sha(vr)}
    # kzg.commit's device MSM in a child process; the host Pippenger after
    # MSM_TIMEOUT_S seconds without a result
    t0 = time.time()
    point = _in_child(_commit_device, (ins["coeffs"][:LL_M],), MSM_TIMEOUT_S)
    method = "aleo_tpu.pcs.kzg.commit"
    if point is None:
        point = msm_pippenger_jac(ins["coeffs"][:LL_M], srs.host_affine()[:LL_M], 12)
        method = ("aleo_tpu.reference.msm.msm_pippenger_jac (kzg.commit gave no result "
                  f"after {time.time() - t0:.0f} s on the CPU)")
    entry["commit"] = {"point": point_to_bytes(point).hex(), "method": method}
    polys = [FR_RING.encode(v) for v in ins["open"]]
    w, y = kzg.open_at(srs, polys[0], zd)
    entry["open_at"] = {"w": point_to_bytes(w).hex(), "y": str(FR_RING.decode(y))}
    wb, ys = kzg.batch_open_at(srs, polys, zd, FR_RING.const(ins["gamma"]))
    entry["batch_open_at"] = {"w": point_to_bytes(wb).hex(),
                              "ys": [str(FR_RING.decode(v)) for v in ys]}
    return entry


# -- the file --------------------------------------------------------------------------


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def write_entry(name: str, entry: dict, seconds: float, path=OUT) -> None:
    """Merge one entry into the file, under a lock on its directory."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd = os.open(path.parent, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        doc = json.loads(path.read_text()) if path.exists() else {}
        doc["generator"] = "scripts/torch_make_jax_vectors.py"
        doc["jax_version"] = jax.__version__
        doc["commit"] = _commit()
        entries = doc.setdefault("entries", {})
        entries[name] = {**entry, "seconds": seconds}
        doc["entries"] = {k: entries[k] for k in ENTRIES if k in entries}
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(doc, indent=1) + "\n")
        os.replace(tmp, path)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    print(f"{name}: {seconds:.1f} s", flush=True)


def _timed(fn, *args):
    t0 = time.time()
    out = fn(*args)
    return out, time.time() - t0


def make(entries, path=OUT) -> None:
    """Compute the named entries with the JAX package and write each one."""
    srs = reg = keys = None
    if {"srs", "transfer", "batch", "credits", "limbs_last"} & set(entries):
        (entry, srs), s = _timed(make_srs)
        if "srs" in entries:
            write_entry("srs", entry, s, path)
    if {"transfer", "batch"} & set(entries):
        (reg, keys), keys_s = _timed(make_keys, srs)
        print(f"keys: {keys_s:.1f} s", flush=True)
    if "transfer" in entries:
        entry, s = _timed(make_transfer, srs, reg, keys)
        write_entry("transfer", {**entry, "keys_seconds": keys_s}, s, path)
    if "batch" in entries:
        write_entry("batch", *_timed(make_batch, srs, reg, keys), path)
    if "ntt" in entries:
        t0 = time.time()
        entry = {str(1 << logn): make_ntt(logn) for logn in NTT_LOGNS}
        write_entry("ntt", entry, time.time() - t0, path)
    if "msm" in entries:
        write_entry("msm", *_timed(make_msm), path)
    if "poseidon" in entries:
        write_entry("poseidon", *_timed(make_poseidon), path)
    if "credits" in entries:
        write_entry("credits", *_timed(make_credits, srs), path)
    if "ecdh" in entries:
        write_entry("ecdh", *_timed(make_ecdh), path)
    if "limbs_last" in entries:
        write_entry("limbs_last", *_timed(make_limbs_last, srs), path)


def make_each(entries, path=OUT) -> None:
    """make() for each group of the named entries, in turn, each in a
    process of its own (this script with --entries and --out)."""
    for group in GROUPS:
        todo = [e for e in group if e in entries]
        if todo:
            subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                            "--entries", ",".join(todo), "--out", str(path)], check=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entries", default=",".join(ENTRIES),
                    help="comma-separated subset of " + ",".join(ENTRIES))
    ap.add_argument("--out", default=str(OUT), help="the file to write (default: %(default)s)")
    args = ap.parse_args(argv)
    entries = [e for e in args.entries.split(",") if e]
    unknown = set(entries) - set(ENTRIES)
    if unknown:
        ap.error(f"unknown entries {sorted(unknown)}")
    if sum(any(e in entries for e in group) for group in GROUPS) > 1:
        make_each(entries, args.out)
    else:
        make(entries, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
