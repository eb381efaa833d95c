"""The batch prover of the port (`aleo_tpu_torch.snark.batch`) on the CPU
against `aleo_tpu.snark.batch`, tolerance 0 (field and group elements).

  (a) the helpers: `_pad_b`, `_const_b`, the lifted field ops and round
      blocks, the four batched transforms on both sides of a lowered
      `MATNTT_MIN_N`, `_divide_by_linear_b`, against the reference's (values
      after normalize: the two NTT paths return different lazy
      representatives);
  (b) `prove_batch` on the cubic circuit of tests/test_batch_prover.py (SRS
      degree 63, k = 3): every proof verifies under both packages'
      verifiers, a proof is bound to its own statement, and with the same
      seeded `rng` the bytes equal the reference's proof by proof, on one
      device and sharded over three gloo ranks as (dp, field) = (3, 1)
      (how the ranks run: tests/test_torch_mesh.py); k = 1.
"""

import pickle
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.snark import batch as jbatch
from aleo_tpu.snark import indexer as jindexer
from aleo_tpu.snark import serialize as jser
from aleo_tpu.snark import verifier as jver
from aleo_tpu_torch import config as tconfig
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.snark import batch as tbatch
from aleo_tpu_torch.snark import indexer as tindexer
from aleo_tpu_torch.snark import pipeline as tpipe
from aleo_tpu_torch.snark import prover as tprover
from aleo_tpu_torch.snark import serialize as tser
from aleo_tpu_torch.snark import verifier as tver
from test_torch_batch_mesh import batch_worker
from test_torch_mesh import Ranks
from tests.test_snark import cubic_circuit

torch.set_num_threads(2)        # several test workers share the machine

R = params.R
SHIFT = params.FR_GENERATOR
K = 3


def _stack(rng, n, k=K):
    """k x n random field elements -> the port's (k, 16, n) int32 stack and
    the same limbs for jnp."""
    t = torch.stack([tlf.encode([rng.randrange(R) for _ in range(n)], device="cpu")
                     for _ in range(k)])
    return t, jnp.asarray(t.numpy().astype(np.uint32))


def _same_values(t, j):
    """Equal field values, limb for limb after normalize."""
    assert t.shape == tuple(j.shape), (t.shape, j.shape)
    k = t.shape[0]
    for p in range(k):
        want = tlf.encode([int(v) for v in jbatch.lf.decode(j[p])], device="cpu")
        assert torch.equal(tlf.normalize(t[p]), want)


# -- (a) helpers ---------------------------------------------------------------


def test_pad_b_and_const_b_match_the_reference():
    rng = random.Random(1)
    t, j = _stack(rng, 5)
    got = tbatch._pad_b(t, 8)
    assert got.shape == (K, 16, 8)
    assert np.array_equal(got.numpy(), np.asarray(jbatch._pad_b(j, 8)).astype(np.int64))
    assert tbatch._pad_b(t, 5) is t
    vals = [rng.randrange(R) for _ in range(K)]
    for n in (1, 4):
        c = tbatch._const_b(vals, n, device="cpu")
        assert c.shape == (K, 16, n)
        assert np.array_equal(c.numpy(), np.asarray(jbatch._const_b(vals, n)).astype(np.int64))


@pytest.mark.parametrize("name", ["_mul_b", "_add_b", "_sub_b"])
def test_lifted_binary_ops_match_the_reference(name):
    rng = random.Random(2)
    (ta, ja), (tb, jb) = _stack(rng, 6), _stack(rng, 6)
    _same_values(getattr(tbatch, name)(ta, tb), getattr(jbatch, name)(ja, jb))


def test_lifted_inversion_sum_and_evaluation_match_the_reference():
    rng = random.Random(3)
    ta, ja = _stack(rng, 7)
    inv = tbatch._binv_b(ta)
    _same_values(inv, jbatch._binv_b(ja))
    one = tlf.normalize(tlf.one(7, device="cpu"))
    for p in range(K):                      # each row is inverted on its own
        assert torch.equal(tlf.normalize(tlf.mul(inv[p], ta[p])), one)
    _same_values(tbatch._tsum_b(ta), jbatch._tsum_b(ja))
    tz, jz = _stack(rng, 1)
    y = tbatch._eval_b(ta, tz)
    assert y.shape == (K, 16, 1)
    _same_values(y, jbatch._eval_b(ja, jz))


def test_lifted_round_blocks_match_the_reference():
    """Blocks with shared (None) and per-proof (0) arguments, as the
    reference's `in_axes` give them."""
    rng = random.Random(4)
    n = 8
    (ta, ja), (tb, jb), (tc, jc) = _stack(rng, n), _stack(rng, n), _stack(rng, n)
    shared_t, shared_j = _stack(rng, n, k=1)
    _same_values(tbatch._h0_block_b(ta, tb, tc, shared_t[0]),
                 jbatch._h0_block_b(ja, jb, jc, shared_j[0]))
    _same_values(tbatch._qx_block_b(ta, tb, shared_t[0]),
                 jbatch._qx_block_b(ja, jb, shared_j[0]))
    alphas = [rng.randrange(R) for _ in range(K)]
    vhs = [rng.randrange(R) for _ in range(K)]
    _same_values(
        tbatch._u_alpha_block_b(tbatch._const_b(alphas, n, device="cpu"), shared_t[0],
                                tbatch._const_b(vhs, n, device="cpu")),
        jbatch._u_alpha_block_b(jbatch._const_b(alphas, n), shared_j[0],
                                jbatch._const_b(vhs, n)),
    )
    ws = [[rng.randrange(R) for _ in range(K)] for _ in range(3)]
    t_ws = torch.stack([tbatch._const_b(w, device="cpu") for w in ws], dim=1)
    j_ws = jnp.swapaxes(jnp.stack([jbatch._const_b(w) for w in ws]), 0, 1)
    _same_values(tbatch._weighted_sum3_b(torch.stack([ta, tb, tc]), t_ws),
                 jbatch._weighted_sum3_b(jnp.stack([ja, jb, jc]), j_ws))


@pytest.mark.parametrize("min_n,path", [(256, "matntt"), (1 << 14, "butterfly")])
@pytest.mark.parametrize("name,args", [
    ("_ntt_b", ()), ("_intt_b", ()), ("_coset_ntt_b", (SHIFT,)), ("_coset_intt_b", (SHIFT,)),
])
def test_batched_transforms_match_the_reference(name, args, min_n, path, monkeypatch):
    n = 512
    rng = random.Random(5)
    t, j = _stack(rng, n)
    monkeypatch.setattr(tconfig, "MATNTT_MIN_N", min_n)
    tbatch.reset_ntt_calls()
    got = getattr(tbatch, name)(t, *args)
    assert tbatch.NTT_CALLS == {"matntt": int(path == "matntt"),
                                "butterfly": int(path == "butterfly")}
    assert got.shape == t.shape and got.is_contiguous()
    _same_values(got, getattr(jbatch, name)(j, *args))


@pytest.mark.parametrize("min_n", [256, 1 << 14], ids=["matntt", "butterfly"])
def test_divide_by_linear_b_matches_the_reference(min_n, monkeypatch):
    n = 300                     # pads to 512
    rng = random.Random(6)
    t, j = _stack(rng, n)
    zs = [rng.randrange(R) for _ in range(K)]
    monkeypatch.setattr(tconfig, "MATNTT_MIN_N", min_n)
    q, y = tbatch._divide_by_linear_b(t, tbatch._const_b(zs, device="cpu"))
    jq, jy = jbatch._divide_by_linear_b(j, jbatch._const_b(zs))
    assert q.shape == (K, 16, n - 1) and y.shape == (K, 16, 1)
    _same_values(q, jq)
    _same_values(y, jy)
    # p(X) - y = q(X) (X - z) at a fresh point, on host integers
    x = rng.randrange(R)
    for p in range(K):
        coeffs = tlf.decode(t[p])
        qs = tlf.decode(q[p])
        px = sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R
        qx = sum(c * pow(x, i, R) for i, c in enumerate(qs)) % R
        assert (px - tlf.decode(y[p])[0]) % R == qx * (x - zs[p]) % R


# -- (b) prove_batch -------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's SRS carried across as its own blob; one index on each
    side from the same constraint system."""
    tmp = tmp_path_factory.mktemp("srs")
    jsrs = JSrs.generate(63, seed=b"batch-test-srs")
    jsrs.save(str(tmp / "srs.pkl"))
    with open(tmp / "srs.pkl", "rb") as f:
        tsrs = tpipe.srs_from_numpy(pickle.load(f), "cpu")
    cs_list = [cubic_circuit(x) for x in (3, 5, 11)]
    jindex = jindexer.index_r1cs(cs_list[0], srs=jsrs)
    tindex = tindexer.index_r1cs(cs_list[0], srs=tsrs, device="cpu")
    assert tindex.index_commitments() == jindex.index_commitments()
    return jindex, tindex, cs_list


@pytest.fixture(scope="module")
def batch_proofs(setup):
    _, tindex, cs_list = setup
    return tbatch.prove_batch(tindex, cs_list, rng=random.Random(9))


def test_batch_proofs_verify_under_the_jax_verifier(setup, batch_proofs):
    jindex, _, cs_list = setup
    vk = jver.VerifyingKey.from_index(jindex)
    assert len(batch_proofs) == K
    for cs, proof in zip(cs_list, batch_proofs):
        assert jver.verify(vk, cs.public_inputs(), proof)
    # proofs are bound to their own statements
    assert not jver.verify(vk, cs_list[1].public_inputs(), batch_proofs[0])


def test_batch_proofs_verify_under_the_port_verifier(setup, batch_proofs):
    _, tindex, cs_list = setup
    vk = tver.VerifyingKey.from_index(tindex)
    for cs, proof in zip(cs_list, batch_proofs):
        assert tver.verify(vk, cs.public_inputs(), proof)
    assert not tver.verify(vk, cs_list[1].public_inputs(), batch_proofs[0])
    assert batch_proofs[0].commitments["z"] != batch_proofs[1].commitments["z"]


@pytest.fixture(scope="module")
def jax_batch_proofs(setup):
    jindex, _, cs_list = setup
    return jbatch.prove_batch(jindex, cs_list, rng=random.Random(9))


def test_batch_proof_bytes_equal_the_reference(setup, batch_proofs, jax_batch_proofs):
    _, tindex, _ = setup
    jproofs = jax_batch_proofs
    dims = (tindex.n, tindex.m, tindex.ell)
    for tp, jp in zip(batch_proofs, jproofs):
        assert tser.proof_to_bytes(tp, *dims) == jser.proof_to_bytes(jp, *dims)
        assert tp.commitments == jp.commitments
        assert tp.evals_beta == jp.evals_beta and tp.evals_gamma == jp.evals_gamma


def test_sharded_batch_bytes_equal_the_reference(setup, jax_batch_proofs, tmp_path):
    """prove_batch(mesh=make_mesh(dp=3)) over three gloo ranks, one proof a
    rank, on the same circuits and seed: every rank returns all three
    proofs, byte for byte the reference's; two proofs, which do not divide
    over dp = 3, are refused."""
    _, tindex, cs_list = setup
    xs = (3, 5, 11)
    assert [cs.public_inputs() for cs in cs_list] == \
        [cubic_circuit(x).public_inputs() for x in xs]
    dims = (tindex.n, tindex.m, tindex.ell)
    want = [jser.proof_to_bytes(jp, *dims) for jp in jax_batch_proofs]
    assert len(set(want)) == K
    for got, ntts, uneven in Ranks(tmp_path, 3, batch_worker, xs, 3).results():
        assert got == want
        assert sum(ntts.values()) > 0
        assert uneven == "refused"


def test_batch_through_matntt_gives_the_same_bytes(setup, batch_proofs, monkeypatch):
    """Every batched transform of 4 lanes and more as MatNTT: same proofs."""
    _, tindex, cs_list = setup
    monkeypatch.setattr(tconfig, "MATNTT_MIN_N", 4)
    tbatch.reset_ntt_calls()
    again = tbatch.prove_batch(tindex, cs_list, rng=random.Random(9))
    assert tbatch.NTT_CALLS["matntt"] > 20
    dims = (tindex.n, tindex.m, tindex.ell)
    assert [tser.proof_to_bytes(p, *dims) for p in again] == \
        [tser.proof_to_bytes(p, *dims) for p in batch_proofs]


def test_batch_of_one_equals_the_single_prover(setup):
    """k = 1 works in the port, and draws from `rng` as `prove` does: z's
    masks, then those of z_A, z_B, z_C, then s."""
    _, tindex, cs_list = setup
    one = tbatch.prove_batch(tindex, cs_list[:1], rng=random.Random(21))
    single = tprover.prove(tindex, cs_list[0], rng=random.Random(21))
    dims = (tindex.n, tindex.m, tindex.ell)
    assert len(one) == 1
    assert tser.proof_to_bytes(one[0], *dims) == tser.proof_to_bytes(single, *dims)
