"""The slice as a whole, on the CPU: micro.aleo/bump keys made by the JAX
package are carried across with `keys_from_numpy`; the same constraint system
and `rng=random.Random(7)` go through both provers; the proofs' bytes are
equal and each verifies under the other package's verifier.

The port proves with its MatNTT threshold lowered to 256, so every transform
of the proof (2048 to 32768 lanes) runs as int8 products and the reduction's
plain version, against the JAX package's butterfly network (its CPU path).

Tolerance 0: a proof is field and group elements."""

import pickle
import random

import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.program.interpreter import Registry as JRegistry
from aleo_tpu.program.parser import parse_program as jparse
from aleo_tpu.program.values import Value as JValue
from aleo_tpu.snark import pipeline as jpipe
from aleo_tpu.snark import prover as jprover
from aleo_tpu.snark import serialize as jser
from aleo_tpu.snark import verifier as jver
from aleo_tpu_torch import config as tconfig
from aleo_tpu_torch.ntt import matntt as tmatntt
from aleo_tpu_torch.snark import pipeline as tpipe
from aleo_tpu_torch.snark import prover as tprover
from aleo_tpu_torch.snark import serialize as tser
from aleo_tpu_torch.snark import verifier as tver

torch.set_num_threads(2)        # several test workers share the machine

R = params.R

MICRO = """
program micro.aleo;

function bump:
    input r0 as u64.private;
    add r0 1u64 into r1;
    output r1 as u64.private;
"""


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """JAX-side keys and synthesis, and the port's keys from their blobs."""
    tmp = tmp_path_factory.mktemp("keys")
    reg = JRegistry()
    reg.add(jparse(MICRO))
    jsrs = JSrs.generate(8193, seed=b"test-torch-prover")
    jkeys = jpipe.synthesize_keys(reg, "micro.aleo", "bump", srs=jsrs)
    # exactly the numpy dictionaries the JAX package writes
    jpipe._save_keys(jkeys, str(tmp / "keys.pkl"))
    jsrs.save(str(tmp / "srs.pkl"))
    with open(tmp / "keys.pkl", "rb") as f:
        key_blob = pickle.load(f)
    with open(tmp / "srs.pkl", "rb") as f:
        srs_blob = pickle.load(f)
    tkeys = tpipe.keys_from_numpy(key_blob, srs_blob, device="cpu")
    syn = jpipe.synthesize_and_check(
        jkeys, reg, [JValue("u64", 41)], caller=0, rng_nonce=lambda: 5
    )
    return jkeys, tkeys, syn


@pytest.fixture(scope="module")
def proofs(carried):
    jkeys, tkeys, syn = carried
    jproof = jprover.prove(jkeys.index, syn.cs, rng=random.Random(7))
    sizes = []
    real_run, real_min = tmatntt._run, tconfig.MATNTT_MIN_N
    tmatntt._run = lambda x, *a, **k: sizes.append(x.shape[-1]) or real_run(x, *a, **k)
    tconfig.MATNTT_MIN_N = 256
    try:
        tproof = tprover.prove(tkeys.index, syn.cs, rng=random.Random(7))
    finally:
        tmatntt._run, tconfig.MATNTT_MIN_N = real_run, real_min
    return jproof, tproof, sizes


def test_keys_carried_across_are_the_same_keys(carried):
    jkeys, tkeys, _ = carried
    ji, ti = jkeys.index, tkeys.index
    assert (ti.n, ti.m, ti.ell, ti.num_inputs) == (ji.n, ji.m, ji.ell, ji.num_inputs)
    assert ti.index_commitments() == ji.index_commitments()
    assert tkeys.vk.index_commitments == jkeys.vk.index_commitments
    assert tkeys.constraint_counts == jkeys.constraint_counts
    assert ti.matrices[0].row_poly.dtype == torch.int32
    assert np.array_equal(ti.matrices[2].cval_poly.numpy().astype(np.int64),
                          np.asarray(ji.matrices[2].cval_poly).astype(np.int64))
    # and the port's own blob has the layout it was given
    blob = tpipe.keys_to_numpy(tkeys)
    again = tpipe.keys_from_numpy(blob, ti.srs, device="cpu")
    assert again.index.index_commitments() == ji.index_commitments()
    assert np.array_equal(blob["matrices"][1]["by_col"]["gather_idx"],
                          np.asarray(ji.matrices[1].by_col.gather_idx))


def test_proof_bytes_equal(carried, proofs):
    jproof, tproof, _ = proofs
    ji = carried[0].index
    dims = (ji.n, ji.m, ji.ell)
    assert tser.proof_to_bytes(tproof, *dims) == jser.proof_to_bytes(jproof, *dims)
    assert tproof.commitments == jproof.commitments
    assert tproof.sigmas == jproof.sigmas and tproof.sigma_s == jproof.sigma_s
    assert tproof.evals_beta == jproof.evals_beta
    assert tproof.evals_gamma == jproof.evals_gamma
    assert (tproof.w_beta, tproof.w_gamma) == (jproof.w_beta, jproof.w_gamma)


def test_every_transform_of_the_proof_ran_as_matntt(carried, proofs):
    ji = carried[0].index
    sizes = proofs[2]
    assert set(sizes) == {ji.n, 2 * ji.n, 4 * ji.n, ji.m, 4 * ji.m}, sorted(set(sizes))
    assert sizes.count(4 * ji.m) == 18          # 5 coset NTTs + 1 inverse per matrix


def test_port_proof_verifies_under_the_jax_verifier(carried, proofs):
    jkeys, _, syn = carried
    _, tproof, _ = proofs
    assert jver.verify(jkeys.vk, syn.public_inputs, tproof)


def test_jax_proof_verifies_under_the_port_verifier(carried, proofs):
    _, tkeys, syn = carried
    jproof, _, _ = proofs
    assert tver.verify(tkeys.vk, syn.public_inputs, jproof)
    bad = list(syn.public_inputs)
    bad[-1] = (bad[-1] + 1) % R
    assert not tver.verify(tkeys.vk, bad, jproof)


def test_port_proof_round_trips_through_bytes(carried, proofs):
    _, tkeys, syn = carried
    _, tproof, _ = proofs
    ti = tkeys.index
    back, n, m, ell = tser.proof_from_bytes(tser.proof_to_bytes(tproof, ti.n, ti.m, ti.ell))
    assert (n, m, ell) == (ti.n, ti.m, ti.ell)
    assert tver.verify(tkeys.vk, syn.public_inputs, back)
