"""Proof byte serialization (compressed points, canonical field order).

The wire-format role of snarkVM's `Proof` to/from bytes (surfaced in the
reference as `ProvingKey`/`VerifyingKey`/`Proof` byte APIs,
`upstream:wasm/src/programs/proving_key.rs:34-42` and
`rust/src/lib.rs:230`). Format (little-endian):

  header:  b"ATP1" | u32 n | u32 m | u32 ell (domain sizes for sanity)
  points:  each G1 point 48 bytes — x in LE with flag bits in the top byte
           (bit7: infinity, bit6: y is the lexicographically larger root);
           order: COMMIT_NAMES, then w_beta, w_gamma
  scalars: each Fr 32 bytes LE —
           sigmas (3), sigma_s, evals_beta in BETA_POLYS order,
           evals_gamma in GAMMA_POLYS order

BLS12-377's q is 377 bits, so a 384-bit field leaves 7 spare top bits for
the flags (the same packing trick as the ZCash BLS12-381 format).
"""

from __future__ import annotations

import struct

from .. import params
from ..reference.field import FQ as _FQ
from .prover import BETA_POLYS, COMMIT_NAMES, GAMMA_POLYS, Proof

Q = params.Q
R = params.R

_INF = 0x80
_YSIGN = 0x40


def point_to_bytes(p) -> bytes:
    if p is None:
        return bytes(47) + bytes([_INF])
    x, y = p
    buf = bytearray(int(x).to_bytes(48, "little"))
    if y > Q - y:  # y is the larger of the two roots
        buf[47] |= _YSIGN
    return bytes(buf)


def point_from_bytes(b: bytes):
    assert len(b) == 48
    flags = b[47]
    if flags & _INF:
        return None
    buf = bytearray(b)
    buf[47] &= 0x3F
    x = int.from_bytes(bytes(buf), "little")
    assert x < Q, "x coordinate out of range"
    y2 = (x * x % Q * x + params.G1_B) % Q
    y = _FQ.sqrt(y2)  # raises if x is not on the curve
    if (y > Q - y) != bool(flags & _YSIGN):
        y = Q - y
    return (x, y % Q)


def fr_to_bytes(v: int) -> bytes:
    return int(v % R).to_bytes(32, "little")


def proof_to_bytes(proof: Proof, n: int, m: int, ell: int) -> bytes:
    out = [b"ATP1", struct.pack("<III", n, m, ell)]
    for name in COMMIT_NAMES:
        out.append(point_to_bytes(proof.commitments[name]))
    out.append(point_to_bytes(proof.w_beta))
    out.append(point_to_bytes(proof.w_gamma))
    for s in proof.sigmas:
        out.append(fr_to_bytes(s))
    out.append(fr_to_bytes(proof.sigma_s))
    for k in BETA_POLYS:
        out.append(fr_to_bytes(proof.evals_beta[k]))
    for k in GAMMA_POLYS:
        out.append(fr_to_bytes(proof.evals_gamma[k]))
    return b"".join(out)


def proof_from_bytes(data: bytes) -> tuple[Proof, int, int, int]:
    assert data[:4] == b"ATP1", "bad magic"
    n, m, ell = struct.unpack_from("<III", data, 4)
    off = 16
    pts = []
    for _ in range(len(COMMIT_NAMES) + 2):
        pts.append(point_from_bytes(data[off : off + 48]))
        off += 48
    commitments = dict(zip(COMMIT_NAMES, pts[:-2]))
    w_beta, w_gamma = pts[-2], pts[-1]

    def rd_fr():
        nonlocal off
        v = int.from_bytes(data[off : off + 32], "little")
        off += 32
        assert v < R, "scalar out of range"
        return v

    sigmas = (rd_fr(), rd_fr(), rd_fr())
    sigma_s = rd_fr()
    evals_beta = {k: rd_fr() for k in BETA_POLYS}
    evals_gamma = {k: rd_fr() for k in GAMMA_POLYS}
    assert off == len(data), "trailing bytes"
    proof = Proof(
        commitments=commitments,
        sigmas=sigmas,
        sigma_s=sigma_s,
        evals_beta=evals_beta,
        evals_gamma=evals_gamma,
        w_beta=w_beta,
        w_gamma=w_gamma,
    )
    return proof, n, m, ell
