"""snarkVM wire-format primitives: field/point byte encodings + key blobs.

Counterpart of the JAX package's `snark/snarkvm_bytes.py`: host code, the
same bytes. It reads and writes snarkVM's `ProvingKey::from_bytes` /
`VerifyingKey` / universal-SRS blobs
(`upstream:wasm/src/programs/proving_key.rs:34-42`,
`verifying_key.rs:35-43`, parameter files of
`website/src/workers/keys.js:1-28`). This module is that byte layer:

  * field elements — canonical little-endian bigint dumps (Fr 32 B, Fq 48 B),
    the snarkvm-utilities `ToBytes`/`FromBytes` convention;
  * G1/G2 affine — X coordinate(s) LE with the arkworks/snarkvm-curves
    SW flag bits in the top of the final byte (compressed), or X||Y with an
    infinity flag (uncompressed); Y recovered via Tonelli-Shanks;
  * length-prefixed vectors and the universal-SRS / circuit-key containers.

Status vs bit-exactness (BASELINE.md): the PRIMITIVE encodings implement the
published snarkVM conventions and round-trip against this framework's own
curve oracle; the CONTAINER field orders follow snarkVM 0.14.5's struct
layouts as documented below and are written so that, when `tools/vectors`
fixtures exist, any mismatch is a constants fix (flag bit positions, field
order), not new plumbing. Flag-bit positions are module constants for
exactly that reason.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .. import params
from ..reference.curve import G1
from ..reference.field import FQ
from ..reference.tower import Fq2

Q = params.Q
R = params.R

FQ_BYTES = 48
FR_BYTES = 32

# arkworks/snarkvm-curves SWFlags, stored in the top bits of the final byte:
#   compressed:   bit7 = y is the "positive" (lexicographically larger) root
#   both:         bit6 = point at infinity
# (constants, so a vector-discovered flip is a one-line fix)
FLAG_Y_IS_POSITIVE = 0x80
FLAG_INFINITY = 0x40


# ---------------------------------------------------------------------------
# field elements
# ---------------------------------------------------------------------------


def fr_to_bytes(v: int) -> bytes:
    return int(v % R).to_bytes(FR_BYTES, "little")


def fr_from_bytes(b: bytes) -> int:
    assert len(b) == FR_BYTES
    v = int.from_bytes(b, "little")
    assert v < R, "non-canonical Fr encoding"
    return v


def fq_to_bytes(v: int) -> bytes:
    return int(v % Q).to_bytes(FQ_BYTES, "little")


def fq_from_bytes(b: bytes) -> int:
    assert len(b) == FQ_BYTES
    v = int.from_bytes(b, "little")
    assert v < Q, "non-canonical Fq encoding"
    return v


def _y_is_positive(y: int) -> bool:
    """arkworks convention: the larger of {y, -y} is 'positive'."""
    return y > Q - y


# ---------------------------------------------------------------------------
# G1 affine (short Weierstrass y^2 = x^3 + 1)
# ---------------------------------------------------------------------------


def g1_to_bytes(p: Optional[Tuple[int, int]], compressed: bool = True) -> bytes:
    if compressed:
        if p is None:
            buf = bytearray(FQ_BYTES)
            buf[-1] |= FLAG_INFINITY
            return bytes(buf)
        x, y = p
        buf = bytearray(fq_to_bytes(x))
        if _y_is_positive(y):
            buf[-1] |= FLAG_Y_IS_POSITIVE
        return bytes(buf)
    if p is None:
        buf = bytearray(2 * FQ_BYTES)
        buf[-1] |= FLAG_INFINITY
        return bytes(buf)
    x, y = p
    return fq_to_bytes(x) + fq_to_bytes(y)


def g1_from_bytes(b: bytes) -> Optional[Tuple[int, int]]:
    if len(b) == FQ_BYTES:  # compressed
        flags = b[-1] & (FLAG_Y_IS_POSITIVE | FLAG_INFINITY)
        if flags & FLAG_INFINITY:
            return None
        raw = bytearray(b)
        raw[-1] &= ~(FLAG_Y_IS_POSITIVE | FLAG_INFINITY) & 0xFF
        x = fq_from_bytes(bytes(raw))
        y2 = (pow(x, 3, Q) + 1) % Q
        y = FQ.sqrt(y2)
        if _y_is_positive(y) != bool(flags & FLAG_Y_IS_POSITIVE):
            y = Q - y
        assert G1.is_on_curve((x, y)), "decoded point not on curve"
        return (x, y)
    assert len(b) == 2 * FQ_BYTES
    if b[-1] & FLAG_INFINITY:
        return None
    x = fq_from_bytes(b[:FQ_BYTES])
    y = fq_from_bytes(b[FQ_BYTES:])
    assert G1.is_on_curve((x, y)), "decoded point not on curve"
    return (x, y)


# ---------------------------------------------------------------------------
# G2 affine over Fq2 (x = c0 + c1*u)
# ---------------------------------------------------------------------------


def g2_to_bytes(p: Optional[Tuple[Fq2, Fq2]], compressed: bool = True) -> bytes:
    if p is None:
        size = 2 * FQ_BYTES if compressed else 4 * FQ_BYTES
        buf = bytearray(size)
        buf[-1] |= FLAG_INFINITY
        return bytes(buf)
    x, y = p
    xb = fq_to_bytes(x.c0) + fq_to_bytes(x.c1)
    if compressed:
        buf = bytearray(xb)
        # sign of y: lexicographic on (c1, c0), matching arkworks' Fq2 order
        pos = (y.c1, y.c0) > ((Q - y.c1) % Q, (Q - y.c0) % Q)
        if pos:
            buf[-1] |= FLAG_Y_IS_POSITIVE
        return bytes(buf)
    return xb + fq_to_bytes(y.c0) + fq_to_bytes(y.c1)


def g2_from_bytes(b: bytes) -> Optional[Tuple[Fq2, Fq2]]:
    from ..reference.curve import G2

    if len(b) == 2 * FQ_BYTES:  # compressed
        flags = b[-1] & (FLAG_Y_IS_POSITIVE | FLAG_INFINITY)
        if flags & FLAG_INFINITY:
            return None
        raw = bytearray(b)
        raw[-1] &= ~(FLAG_Y_IS_POSITIVE | FLAG_INFINITY) & 0xFF
        x = Fq2(fq_from_bytes(bytes(raw[:FQ_BYTES])),
                fq_from_bytes(bytes(raw[FQ_BYTES:])))
        y2 = x * x * x + G2.B
        y = y2.sqrt()
        pos = (y.c1, y.c0) > ((Q - y.c1) % Q, (Q - y.c0) % Q)
        if pos != bool(flags & FLAG_Y_IS_POSITIVE):
            y = Fq2((Q - y.c0) % Q, (Q - y.c1) % Q)
        return (x, y)
    assert len(b) == 4 * FQ_BYTES
    if b[-1] & FLAG_INFINITY:
        return None
    x = Fq2(fq_from_bytes(b[:FQ_BYTES]), fq_from_bytes(b[FQ_BYTES : 2 * FQ_BYTES]))
    y = Fq2(fq_from_bytes(b[2 * FQ_BYTES : 3 * FQ_BYTES]), fq_from_bytes(b[3 * FQ_BYTES :]))
    return (x, y)


# ---------------------------------------------------------------------------
# vectors / containers
# ---------------------------------------------------------------------------


def write_vec(w: io.BytesIO, items: List[bytes], long_len: bool = True) -> None:
    """snarkvm-utilities Vec<T> framing: u64 LE length prefix (long_len) —
    some legacy paths use u32 (long_len=False)."""
    w.write(struct.pack("<Q" if long_len else "<I", len(items)))
    for it in items:
        w.write(it)


def read_vec(r: io.BytesIO, item_size: int, long_len: bool = True) -> List[bytes]:
    n = struct.unpack("<Q" if long_len else "<I", r.read(8 if long_len else 4))[0]
    return [r.read(item_size) for _ in range(n)]


@dataclass
class UniversalSrsBlob:
    """The universal powers-of-tau parameter blob (the `.srs` download of
    `website/src/workers/keys.js`): degree header + G1 powers + the G2
    elements the verifier needs."""

    max_degree: int
    powers_g1: List[Optional[Tuple[int, int]]]
    g2_gen: Optional[Tuple[Fq2, Fq2]]
    g2_tau: Optional[Tuple[Fq2, Fq2]]

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        w.write(struct.pack("<Q", self.max_degree))
        write_vec(w, [g1_to_bytes(p) for p in self.powers_g1])
        w.write(g2_to_bytes(self.g2_gen))
        w.write(g2_to_bytes(self.g2_tau))
        return w.getvalue()

    @staticmethod
    def from_bytes(b: bytes) -> "UniversalSrsBlob":
        r = io.BytesIO(b)
        max_degree = struct.unpack("<Q", r.read(8))[0]
        powers = [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)]
        g2_gen = g2_from_bytes(r.read(2 * FQ_BYTES))
        g2_tau = g2_from_bytes(r.read(2 * FQ_BYTES))
        return UniversalSrsBlob(max_degree, powers, g2_gen, g2_tau)

    @staticmethod
    def from_srs(srs) -> "UniversalSrsBlob":
        return UniversalSrsBlob(
            srs.max_degree, list(srs.host_affine()), srs.g2_gen, srs.g2_tau
        )

    def to_srs(self, seed: bytes = b"imported", device=None):
        """Materialize as a device Srs on `device` (no tau knowledge:
        degree-bound pairing checks then need the ceremony's shifted G2
        powers)."""
        from ..curves import g1 as g1mod
        from ..pcs.srs import Srs

        powers = g1mod.encode_points(self.powers_g1, device=device)
        return Srs(
            powers, self.g2_gen, self.g2_tau, self.max_degree,
            list(self.powers_g1), seed,
        )


# ---------------------------------------------------------------------------
# snarkVM 0.14.5 circuit-key containers, field-for-field
#
# The reference serializes keys via snarkVM's native ToBytes/FromBytes
# (`ProvingKeyNative::{to,from}_bytes_le`,
# upstream:wasm/src/programs/proving_key.rs:34-42,
# verifying_key.rs:35-43). The native structs live in snarkvm-algorithms
# 0.14.5 (`snark::marlin::data_structures`, Cargo.lock:2200-2229):
#
#   CircuitProvingKey { circuit_verifying_key, circuit: Circuit,
#                       committer_key: CommitterKey }
#   CircuitVerifyingKey { circuit_info: CircuitInfo,
#                         circuit_commitments: Vec<Commitment>, id }
#   Circuit { index_info: CircuitInfo, a, b, c: Matrix,
#             a_arith, b_arith, c_arith: MatrixArithmetization }
#   MatrixArithmetization { row, col, row_col, val polynomials
#                           + their evaluations over K }
#   CommitterKey (sonic_pc) { powers_of_beta_g, lagrange_bases_at_beta_g,
#                             powers_of_beta_times_gamma_g,
#                             shifted_powers_of_beta_g: Option,
#                             shifted_powers_of_beta_times_gamma_g: Option,
#                             enforced_degree_bounds: Option, max_degree }
#
# Every field below is written in that order with the snarkvm-utilities
# primitive conventions (u64 LE lengths, compressed points, canonical LE
# fields). Exact encodings this container CANNOT pin without fixtures
# (usize width, Option/BTreeMap framing) are isolated in the helpers
# `_write_opt`/`_write_map` so a vector-discovered difference is a
# one-line fix, not a structural one. tools/vectors dumps the real bytes
# the moment a Rust toolchain is available (BASELINE.md "bit-exactness").
# ---------------------------------------------------------------------------


@dataclass
class CircuitInfoBlob:
    """snarkVM `CircuitInfo`: the circuit's size header (all u64 LE)."""

    num_public_inputs: int
    num_variables: int
    num_constraints: int
    num_non_zero_a: int
    num_non_zero_b: int
    num_non_zero_c: int

    def to_bytes(self) -> bytes:
        return struct.pack(
            "<QQQQQQ", self.num_public_inputs, self.num_variables,
            self.num_constraints, self.num_non_zero_a, self.num_non_zero_b,
            self.num_non_zero_c,
        )

    @staticmethod
    def from_bytes(r: io.BytesIO) -> "CircuitInfoBlob":
        return CircuitInfoBlob(*struct.unpack("<QQQQQQ", r.read(48)))


def _write_fr_vec(w: io.BytesIO, coeffs: List[int]) -> None:
    write_vec(w, [fr_to_bytes(c) for c in coeffs])


def _read_fr_vec(r: io.BytesIO) -> List[int]:
    return [fr_from_bytes(x) for x in read_vec(r, FR_BYTES)]


def _write_opt(w: io.BytesIO, present: bool) -> None:
    """Option<T> framing: 1-byte discriminant (0 = None, 1 = Some)."""
    w.write(bytes([1 if present else 0]))


def _read_opt(r: io.BytesIO) -> bool:
    return r.read(1)[0] != 0


@dataclass
class MatrixBlob:
    """snarkVM `Matrix<F> = Vec<Vec<(F, usize)>>`: per-constraint rows of
    (coefficient, column-index) pairs."""

    rows: List[List[Tuple[int, int]]]

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        w.write(struct.pack("<Q", len(self.rows)))
        for row in self.rows:
            w.write(struct.pack("<Q", len(row)))
            for coeff, col in row:
                w.write(fr_to_bytes(coeff))
                w.write(struct.pack("<Q", col))
        return w.getvalue()

    @staticmethod
    def from_bytes(r: io.BytesIO) -> "MatrixBlob":
        n_rows = struct.unpack("<Q", r.read(8))[0]
        rows = []
        for _ in range(n_rows):
            n = struct.unpack("<Q", r.read(8))[0]
            row = []
            for _ in range(n):
                coeff = fr_from_bytes(r.read(FR_BYTES))
                col = struct.unpack("<Q", r.read(8))[0]
                row.append((coeff, col))
            rows.append(row)
        return MatrixBlob(rows)


@dataclass
class MatrixArithmetizationBlob:
    """snarkVM `MatrixArithmetization`: the indexed row/col/row_col/val
    polynomials of one matrix plus their evaluations over K.

    Mapping from this framework's indexer (snark/indexer.py MatrixIndex):
    row -> row_poly, col -> col_poly, row_col -> rcp_poly (the row*col
    product), val -> cval_poly (val scaled by col/n — the lincheck-side
    normalization; documented there)."""

    row: List[int]
    col: List[int]
    row_col: List[int]
    val: List[int]
    evals_row: List[int]
    evals_col: List[int]
    evals_row_col: List[int]
    evals_val: List[int]

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        for vec in (self.row, self.col, self.row_col, self.val,
                    self.evals_row, self.evals_col, self.evals_row_col,
                    self.evals_val):
            _write_fr_vec(w, vec)
        return w.getvalue()

    @staticmethod
    def from_bytes(r: io.BytesIO) -> "MatrixArithmetizationBlob":
        vecs = [_read_fr_vec(r) for _ in range(8)]
        return MatrixArithmetizationBlob(*vecs)


@dataclass
class CircuitBlob:
    """snarkVM `Circuit`: size header, the A/B/C sparse matrices, and their
    three arithmetizations — the indexed circuit the prover loads."""

    index_info: CircuitInfoBlob
    a: MatrixBlob
    b: MatrixBlob
    c: MatrixBlob
    a_arith: MatrixArithmetizationBlob
    b_arith: MatrixArithmetizationBlob
    c_arith: MatrixArithmetizationBlob

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        w.write(self.index_info.to_bytes())
        for m in (self.a, self.b, self.c):
            w.write(m.to_bytes())
        for ar in (self.a_arith, self.b_arith, self.c_arith):
            w.write(ar.to_bytes())
        return w.getvalue()

    @staticmethod
    def from_bytes(r: io.BytesIO) -> "CircuitBlob":
        info = CircuitInfoBlob.from_bytes(r)
        mats = [MatrixBlob.from_bytes(r) for _ in range(3)]
        ariths = [MatrixArithmetizationBlob.from_bytes(r) for _ in range(3)]
        return CircuitBlob(info, *mats, *ariths)


@dataclass
class CommitterKeyBlob:
    """snarkVM sonic_pc `CommitterKey`: the SRS power ranges a circuit's
    commitments use, including the shifted powers for degree bounds."""

    powers_of_beta_g: List[Optional[Tuple[int, int]]]
    lagrange_bases_at_beta_g: List[Tuple[int, List[Optional[Tuple[int, int]]]]]
    powers_of_beta_times_gamma_g: List[Optional[Tuple[int, int]]]
    shifted_powers_of_beta_g: Optional[List[Optional[Tuple[int, int]]]]
    shifted_powers_of_beta_times_gamma_g: Optional[
        List[Tuple[int, List[Optional[Tuple[int, int]]]]]
    ]
    enforced_degree_bounds: Optional[List[int]]
    max_degree: int

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        write_vec(w, [g1_to_bytes(p) for p in self.powers_of_beta_g])
        # BTreeMap<usize, Vec<G1Affine>>: u64 entry count, then sorted
        # (key, value-vec) pairs
        w.write(struct.pack("<Q", len(self.lagrange_bases_at_beta_g)))
        for key, pts in sorted(self.lagrange_bases_at_beta_g):
            w.write(struct.pack("<Q", key))
            write_vec(w, [g1_to_bytes(p) for p in pts])
        write_vec(w, [g1_to_bytes(p) for p in self.powers_of_beta_times_gamma_g])
        _write_opt(w, self.shifted_powers_of_beta_g is not None)
        if self.shifted_powers_of_beta_g is not None:
            write_vec(w, [g1_to_bytes(p) for p in self.shifted_powers_of_beta_g])
        _write_opt(w, self.shifted_powers_of_beta_times_gamma_g is not None)
        if self.shifted_powers_of_beta_times_gamma_g is not None:
            w.write(struct.pack("<Q", len(self.shifted_powers_of_beta_times_gamma_g)))
            for key, pts in sorted(self.shifted_powers_of_beta_times_gamma_g):
                w.write(struct.pack("<Q", key))
                write_vec(w, [g1_to_bytes(p) for p in pts])
        _write_opt(w, self.enforced_degree_bounds is not None)
        if self.enforced_degree_bounds is not None:
            w.write(struct.pack("<Q", len(self.enforced_degree_bounds)))
            for b in self.enforced_degree_bounds:
                w.write(struct.pack("<Q", b))
        w.write(struct.pack("<Q", self.max_degree))
        return w.getvalue()

    @staticmethod
    def from_bytes(r: io.BytesIO) -> "CommitterKeyBlob":
        powers = [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)]
        n_lag = struct.unpack("<Q", r.read(8))[0]
        lagrange = []
        for _ in range(n_lag):
            key = struct.unpack("<Q", r.read(8))[0]
            lagrange.append(
                (key, [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)])
            )
        gamma = [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)]
        shifted = None
        if _read_opt(r):
            shifted = [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)]
        shifted_gamma = None
        if _read_opt(r):
            n = struct.unpack("<Q", r.read(8))[0]
            shifted_gamma = []
            for _ in range(n):
                key = struct.unpack("<Q", r.read(8))[0]
                shifted_gamma.append(
                    (key, [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)])
                )
        bounds = None
        if _read_opt(r):
            n = struct.unpack("<Q", r.read(8))[0]
            bounds = [struct.unpack("<Q", r.read(8))[0] for _ in range(n)]
        max_degree = struct.unpack("<Q", r.read(8))[0]
        return CommitterKeyBlob(
            powers, lagrange, gamma, shifted, shifted_gamma, bounds, max_degree
        )


@dataclass
class CircuitVerifyingKeyBlob:
    """snarkVM `CircuitVerifyingKey` (behind
    wasm/src/programs/verifying_key.rs:35-43): the circuit-size header +
    the index-polynomial commitments, in indexer order
    [row_a, col_a, val_a(cval), row_col_a(rcp), row_b, ...]."""

    circuit_info: CircuitInfoBlob
    circuit_commitments: List[Optional[Tuple[int, int]]]

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        w.write(self.circuit_info.to_bytes())
        write_vec(w, [g1_to_bytes(p) for p in self.circuit_commitments])
        return w.getvalue()

    @staticmethod
    def from_bytes(b) -> "CircuitVerifyingKeyBlob":
        r = io.BytesIO(b) if isinstance(b, (bytes, bytearray)) else b
        info = CircuitInfoBlob.from_bytes(r)
        cms = [g1_from_bytes(x) for x in read_vec(r, FQ_BYTES)]
        return CircuitVerifyingKeyBlob(info, cms)

    @staticmethod
    def from_index(index) -> "CircuitVerifyingKeyBlob":
        return CircuitVerifyingKeyBlob(
            _info_from_index(index), list(index.index_commitments())
        )


@dataclass
class CircuitProvingKeyBlob:
    """snarkVM `CircuitProvingKey` (behind
    wasm/src/programs/proving_key.rs:34-42): circuit_verifying_key, then
    the indexed `Circuit`, then the `CommitterKey`."""

    circuit_verifying_key: CircuitVerifyingKeyBlob
    circuit: CircuitBlob
    committer_key: CommitterKeyBlob

    def to_bytes(self) -> bytes:
        w = io.BytesIO()
        w.write(self.circuit_verifying_key.to_bytes())
        w.write(self.circuit.to_bytes())
        w.write(self.committer_key.to_bytes())
        return w.getvalue()

    @staticmethod
    def from_bytes(b: bytes) -> "CircuitProvingKeyBlob":
        r = io.BytesIO(b)
        vk = CircuitVerifyingKeyBlob.from_bytes(r)
        circuit = CircuitBlob.from_bytes(r)
        ck = CommitterKeyBlob.from_bytes(r)
        return CircuitProvingKeyBlob(vk, circuit, ck)

    @staticmethod
    def from_index(index, cs) -> "CircuitProvingKeyBlob":
        """Serialize this framework's prover state into the snarkVM shape.

        cs: the ConstraintSystem the index was built from (source of the
        sparse A/B/C matrices). The index polynomials are (m, L) limbs-last
        Montgomery tensors, decoded through `FR_RING`."""
        from ..fields.modring import FR_RING as F

        vk = CircuitVerifyingKeyBlob.from_index(index)
        info = vk.circuit_info
        mats = [MatrixBlob(_matrix_rows(cs, name)) for name in "abc"]
        ariths = []
        for mi in index.matrices:
            def dec(a):
                return [int(v) for v in F.decode(a)]

            ariths.append(MatrixArithmetizationBlob(
                row=dec(mi.row_poly), col=dec(mi.col_poly),
                row_col=dec(mi.rcp_poly), val=dec(mi.cval_poly),
                evals_row=dec(mi.row_evals), evals_col=dec(mi.col_evals),
                evals_row_col=dec(mi.rcp_evals), evals_val=dec(mi.cval_evals),
            ))
        circuit = CircuitBlob(info, *mats, *ariths)
        srs = index.srs
        host = srs.host_affine()
        ck = CommitterKeyBlob(
            powers_of_beta_g=host,
            lagrange_bases_at_beta_g=[],
            powers_of_beta_times_gamma_g=[],
            shifted_powers_of_beta_g=host,   # sliced at use time
            shifted_powers_of_beta_times_gamma_g=None,
            enforced_degree_bounds=[index.n - 2, index.m - 2],
            max_degree=srs.max_degree,
        )
        return CircuitProvingKeyBlob(vk, circuit, ck)


def _info_from_index(index) -> CircuitInfoBlob:
    return CircuitInfoBlob(
        num_public_inputs=index.ell,
        num_variables=index.n,
        num_constraints=index.n,
        num_non_zero_a=index.m,
        num_non_zero_b=index.m,
        num_non_zero_c=index.m,
    )


def _matrix_rows(cs, name: str) -> List[List[Tuple[int, int]]]:
    """Sparse rows of one R1CS matrix from a ConstraintSystem
    (r1cs.py a_rows/b_rows/c_rows: sorted (var, coeff) pairs), in snarkVM's
    Vec<Vec<(coeff, col)>> shape."""
    return [
        [(int(coeff), int(col)) for col, coeff in row]
        for row in getattr(cs, f"{name}_rows")
    ]
