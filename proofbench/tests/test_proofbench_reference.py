"""The seeded inputs repeat, and the plain reference agrees with the program
and with the JAX package's outputs where they are known.

The JAX package's keys, public inputs and proofs of credits.aleo (over the
SRS of 32770 powers seeded "aleo-tpu-srs") are those of its vector file; the
reference works out the same keys from the constraint matrices with the
SRS's trapdoor, and its verifier accepts the package's proofs and rejects
them under a changed input: the control at the cells' own circuits.
"""

import json
import os

import pytest
import torch

from proofbench.inputs import credits as credit_inputs
from proofbench.inputs import msm as msm_inputs
from proofbench.inputs import srs as srs_inputs
from proofbench.reference import curve, marlin, transitions
from proofbench.reference import msm as msm_reference
from proofbench.reference.field import R

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
VECTORS = os.path.join(ROOT, "tests", "torch_vectors", "jax_reference.json")
TRAFFIC = {"microcredits": [1_000_000, 10**12], "new_records": 2}


def test_credit_transitions_repeat_and_differ():
    a = credit_inputs.transitions(2**31 + 7, 3, 8, TRAFFIC)
    assert a == credit_inputs.transitions(2**31 + 7, 3, 8, TRAFFIC)
    assert a != credit_inputs.transitions(2**31 + 8, 3, 8, TRAFFIC)
    assert a != credit_inputs.transitions(2**31 + 7, 4, 8, TRAFFIC)
    assert len({t["owner"] for t in a}) == 8
    assert all(0 < t["amount"] < t["microcredits"] and len(t["out_nonces"]) == 2 for t in a)


def test_scalar_sets_repeat_and_lie_below_r():
    a = msm_inputs.scalar_sets(2**33 + 5, 2, 4096, "cpu")
    assert torch.equal(a, msm_inputs.scalar_sets(2**33 + 5, 2, 4096, "cpu"))
    assert not torch.equal(a, msm_inputs.scalar_sets(2**33 + 6, 2, 4096, "cpu"))
    vals = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in a.reshape(-1, 16)]
    assert max(vals) < R and max(vals) > R // 2
    assert len(set(vals)) == len(vals)


def test_msm_reference_against_scalar_multiplications():
    sc = msm_inputs.scalar_sets(11, 1, 32, "cpu")
    logs = [pow(5, j, R) for j in range(8)]
    want = curve.lincomb(
        [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in sc[0]],
        [curve.mul(logs[j % 8], curve.generator()) for j in range(32)])
    assert msm_reference.expected(msm_reference.class_sums(sc, 8)[0], logs) == want


def test_srs_equals_the_programs_generator():
    from aleo_tpu_torch.pcs.srs import Srs, srs_from_numpy

    blob = srs_inputs.make_blob(12)
    port = Srs.generate(12, device="cpu")
    ours = srs_from_numpy(blob, device="cpu")
    assert blob["host_pts"] == port._host_pts
    assert all(torch.equal(getattr(ours.powers, k), getattr(port.powers, k)) for k in "xyz")
    assert (ours.g2_gen, ours.g2_tau) == (port.g2_gen, port.g2_tau)
    assert curve.g2_on_curve(curve.g2_mul(srs_inputs.trapdoor(), curve.g2_generator()))


def _vectors():
    return json.load(open(VECTORS))["entries"]["credits"]


def _synthesis(function, spec, caller, nonce):
    from aleo_tpu_torch.program.interpreter import Registry
    from aleo_tpu_torch.program.parser import parse_program
    from aleo_tpu_torch.program.synthesizer import synthesize_execution
    from aleo_tpu_torch.program.values import Record, Value

    reg = Registry()
    reg.add(parse_program(open(os.path.join(ROOT, "proofbench/configs/credits.aleo")).read()))
    ins = [Record("credits.aleo", "credits", owner=caller, gates=0,
                  entries={"microcredits": Value("u64", mc)}, nonce=n)
           for mc, n in spec.get("records", [])]
    ins += [Value("address", spec["receiver"]), Value("u64", spec["amount"])]
    return synthesize_execution(reg, "credits.aleo", function, ins, caller=caller,
                                rng_nonce=lambda: nonce)


@pytest.mark.parametrize("function", ["transfer_private", "transfer_public"])
def test_reference_key_inputs_and_verifier_against_the_jax_package(function):
    vec = _vectors()
    inp = vec["inputs"]
    spec = inp["functions"][function]
    syn = _synthesis(function, spec, inp["caller"], inp["rng_nonce"])
    cs = syn.cs
    vk = marlin.index_key(cs.matrices(), cs.num_inputs, cs.num_constraints,
                          cs.num_variables, srs_inputs.trapdoor(), 32769)
    want = json.load(open(os.path.join(ROOT, "proofbench/reference/verifying_keys.json")))
    assert [curve.to_bytes(p).hex() for p in vk.index_commitments] == \
        want[function]["index_commitments"]
    (mc, nonce), = spec.get("records", [[1, 0]])
    t = {"owner": inp["caller"], "microcredits": mc, "nonce": nonce,
         "receiver": spec["receiver"], "amount": spec["amount"],
         "out_nonces": [inp["rng_nonce"]] * 2}
    pi = transitions.public_inputs(function, t)
    assert pi == syn.public_inputs
    assert [str(v) for v in pi] == vec["functions"][function]["public_inputs"]
    blob = bytes.fromhex(vec["functions"][function]["proof"])
    assert marlin.verify(vk, pi, marlin.parse_proof(blob)) == ""
    bad = list(pi)
    bad[-1] = (bad[-1] + 1) % R
    assert marlin.verify(vk, bad, marlin.parse_proof(blob)) != ""
    flipped = bytearray(blob)
    flipped[-32] ^= 1                     # the last gamma evaluation, lowest bit
    assert marlin.verify(vk, pi, marlin.parse_proof(bytes(flipped))) != ""
