"""The port's snarkVM byte containers (aleo_tpu_torch.snark.snarkvm_bytes)
against the JAX package's module (aleo_tpu.snark.snarkvm_bytes), on the CPU.

The golden vectors of snarkVM need a Rust toolchain (`tools/vectors`), which
is not here: the port's bytes are held against the reference module's only.
Tolerance 0: equal bytes, equal decoded values.
"""

import io
import pickle
import random

import numpy as np
import pytest

from aleo_tpu import params
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.reference.curve import G1, G2
from aleo_tpu.snark import indexer as jidx
from aleo_tpu.snark import r1cs as jr1cs
from aleo_tpu.snark import snarkvm_bytes as jsb
from aleo_tpu_torch.pcs.srs import srs_from_numpy
from aleo_tpu_torch.snark import indexer as tidx
from aleo_tpu_torch.snark import r1cs as tr1cs
from aleo_tpu_torch.snark import snarkvm_bytes as tsb

R, Q = params.R, params.Q


def _g1_points(n, seed):
    rng = random.Random(seed)
    return [G1.mul(rng.randrange(1, R), G1.generator()) for _ in range(n)]


@pytest.fixture(scope="module")
def srs_pair(tmp_path_factory):
    jsrs = JSrs.generate(63, seed=b"blob-index-test")
    path = tmp_path_factory.mktemp("srs") / "srs.pkl"
    jsrs.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return jsrs, srs_from_numpy(blob, device="cpu")


def test_field_bytes_match_jax():
    rng = random.Random(1)
    for _ in range(20):
        v, q = rng.randrange(R), rng.randrange(Q)
        assert tsb.fr_to_bytes(v) == jsb.fr_to_bytes(v)
        assert tsb.fq_to_bytes(q) == jsb.fq_to_bytes(q)
        assert tsb.fr_from_bytes(tsb.fr_to_bytes(v)) == v
        assert tsb.fq_from_bytes(tsb.fq_to_bytes(q)) == q
    with pytest.raises(AssertionError):
        tsb.fr_from_bytes(int(R).to_bytes(32, "little"))


@pytest.mark.parametrize("compressed", [True, False])
def test_g1_bytes_match_jax(compressed):
    for p in _g1_points(6, seed=2) + [None]:
        b = tsb.g1_to_bytes(p, compressed=compressed)
        assert b == jsb.g1_to_bytes(p, compressed=compressed)
        assert len(b) == (48 if compressed else 96)
        assert tsb.g1_from_bytes(b) == p


@pytest.mark.parametrize("compressed", [True, False])
def test_g2_bytes_match_jax(compressed):
    rng = random.Random(3)
    pts = [G2.mul(rng.randrange(1, 1 << 60), G2.generator()) for _ in range(3)]
    for p in pts + [None]:
        b = tsb.g2_to_bytes(p, compressed=compressed)
        assert b == jsb.g2_to_bytes(p, compressed=compressed)
        assert tsb.g2_from_bytes(b) == p


def _containers(sb, pts, rng_seed):
    """One of each container of `sb` (either package's module), from the
    same values."""
    rng = random.Random(rng_seed)

    def fr_vec(n):
        return [rng.randrange(R) for _ in range(n)]

    info = sb.CircuitInfoBlob(4, 64, 64, 128, 128, 128)
    vk = sb.CircuitVerifyingKeyBlob(circuit_info=info, circuit_commitments=pts)
    arith = sb.MatrixArithmetizationBlob(*(fr_vec(4) for _ in range(8)))
    mat = sb.MatrixBlob([[(rng.randrange(R), 3), (rng.randrange(R), 7)], []])
    circuit = sb.CircuitBlob(info, mat, mat, mat, arith, arith, arith)
    ck = sb.CommitterKeyBlob(
        powers_of_beta_g=pts,
        lagrange_bases_at_beta_g=[(8, pts[:2])],
        powers_of_beta_times_gamma_g=pts[:2],
        shifted_powers_of_beta_g=pts[:3],
        shifted_powers_of_beta_times_gamma_g=[(5, pts[2:4])],
        enforced_degree_bounds=[62, 126],
        max_degree=255,
    )
    return sb.CircuitProvingKeyBlob(circuit_verifying_key=vk, circuit=circuit, committer_key=ck)


def test_containers_round_trip_with_the_jax_bytes():
    pts = _g1_points(5, seed=4) + [None]
    t, j = _containers(tsb, pts, 5), _containers(jsb, pts, 5)
    data = t.to_bytes()
    assert data == j.to_bytes()
    back = tsb.CircuitProvingKeyBlob.from_bytes(data)
    assert back == t
    vk = t.circuit_verifying_key
    assert tsb.CircuitVerifyingKeyBlob.from_bytes(vk.to_bytes()) == vk
    assert data[: len(vk.to_bytes())] == vk.to_bytes()
    for name in ("circuit", "committer_key"):
        part = getattr(t, name)
        assert part.to_bytes() == getattr(j, name).to_bytes()
    r = io.BytesIO(t.circuit.to_bytes())
    assert tsb.CircuitBlob.from_bytes(r) == t.circuit
    r = io.BytesIO(t.committer_key.to_bytes())
    assert tsb.CommitterKeyBlob.from_bytes(r) == t.committer_key


def test_universal_srs_blob_matches_jax(srs_pair):
    jsrs, tsrs = srs_pair
    blob = tsb.UniversalSrsBlob.from_srs(tsrs)
    data = blob.to_bytes()
    assert data == jsb.UniversalSrsBlob.from_srs(jsrs).to_bytes()
    back = tsb.UniversalSrsBlob.from_bytes(data)
    assert back == blob and back.max_degree == 63
    srs = back.to_srs(device="cpu")
    assert srs.device.type == "cpu" and srs.host_affine() == jsrs.host_affine()
    for k in "xyz":
        assert np.array_equal(getattr(srs.powers, k).numpy().astype(np.int64),
                              np.asarray(getattr(jsrs.powers, k)).astype(np.int64))
    assert (srs.g2_gen, srs.g2_tau) == (jsrs.g2_gen, jsrs.g2_tau)


def _tiny_circuit(r1cs):
    """The circuit of tests/test_snarkvm_bytes.py: x^2 + x + 5 = out."""
    LC = r1cs.LC
    cs = r1cs.ConstraintSystem()
    out = cs.alloc_input(35)
    x = cs.alloc_witness(5)
    x2 = cs.mul(LC.of(x), LC.of(x))
    cs.enforce_eq(LC.of(x2) + LC.of(x) + LC.constant(5), LC.of(out))
    return cs


def test_circuit_proving_key_from_index_matches_jax(srs_pair):
    jsrs, tsrs = srs_pair
    jcs, tcs = _tiny_circuit(jr1cs), _tiny_circuit(tr1cs)
    jpk = jsb.CircuitProvingKeyBlob.from_index(jidx.index_r1cs(jcs, srs=jsrs), jcs)
    tindex = tidx.index_r1cs(tcs, srs=tsrs)
    tpk = tsb.CircuitProvingKeyBlob.from_index(tindex, tcs)
    data = tpk.to_bytes()
    assert data == jpk.to_bytes()
    back = tsb.CircuitProvingKeyBlob.from_bytes(data)
    assert back == tpk
    assert back.circuit_verifying_key.circuit_commitments == list(tindex.index_commitments())
    assert len(back.circuit.a.rows) == tcs.num_constraints
    vk = tsb.CircuitVerifyingKeyBlob.from_index(tindex)
    assert vk.to_bytes() == jpk.circuit_verifying_key.to_bytes()
