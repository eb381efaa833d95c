"""`prove_batch(..., mesh=...)` of the port over gloo ranks on the CPU, the
cubic circuit of tests/test_snark.py (SRS degree 63), `random.Random(9)`.

Here: (dp, field) = (2, 1), k = 4 proofs. Each rank proves two and every
rank returns all four, whose bytes equal those of the port's batch on one
device, proof by proof; the first of each rank verifies under the JAX
package's verifier. The JAX package's own `prove_batch` takes 75 s at k = 2
and about 100 s at k = 4 on a CPU with a cold compilation cache, so this
file does not run it.
tests/test_torch_batch_prover.py holds the sharded bytes against it
directly: three ranks as (3, 1), one proof a rank, against the JAX batch at
k = 3 that file already computes, through `batch_worker` below.
How the ranks run: tests/test_torch_mesh.py.
"""

import random

import torch

from aleo_tpu_torch import params
from aleo_tpu_torch.parallel import mesh as tmesh
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.snark import batch as tbatch
from aleo_tpu_torch.snark import indexer as tindexer
from aleo_tpu_torch.snark import serialize as tser
from aleo_tpu_torch.snark.r1cs import LC, ConstraintSystem
from test_torch_mesh import Ranks

R = params.R
SRS_SEED = b"batch-test-srs"
XS = (3, 5, 11, 13)

torch.set_num_threads(2)        # beside the ranks and the other test workers


def cubic_circuit(x_val: int) -> ConstraintSystem:
    """Knowledge of x with x^3 + x + 5 = out (out public), as in
    tests/test_snark.py."""
    cs = ConstraintSystem()
    out_val = (pow(x_val, 3, R) + x_val + 5) % R
    out = cs.alloc_input(out_val)
    x = cs.alloc_witness(x_val)
    x2 = cs.mul(LC.of(x), LC.of(x))
    x3 = cs.mul(LC.of(x2), LC.of(x))
    cs.enforce_eq(LC.of(x3) + LC.of(x) + LC.constant(5), LC.of(out))
    assert cs.is_satisfied()
    return cs


def _index(xs=XS):
    cs_list = [cubic_circuit(x) for x in xs]
    srs = Srs.generate(63, seed=SRS_SEED, device="cpu")
    return tindexer.index_r1cs(cs_list[0], srs=srs, device="cpu"), cs_list


def _as_bytes(index, proofs):
    return [tser.proof_to_bytes(p, index.n, index.m, index.ell) for p in proofs]


def batch_worker(rank, xs=XS, dp=2):
    """The rank's view of the sharded batch of cubic_circuit(x) for x in xs
    -> (all proofs' bytes, the rank's batched transforms, whether k - 1
    proofs, which do not divide over dp, were refused)."""
    index, cs_list = _index(xs)
    mesh = tmesh.make_mesh(dp=dp, device="cpu")
    tbatch.reset_ntt_calls()
    proofs = tbatch.prove_batch(index, cs_list, rng=random.Random(9), mesh=mesh)
    # the rank's batched transforms ran over its own proofs
    ntts = dict(tbatch.NTT_CALLS)
    try:
        tbatch.prove_batch(index, cs_list[:-1], rng=random.Random(9), mesh=mesh)
        uneven = "accepted"
    except AssertionError:
        uneven = "refused"
    return _as_bytes(index, proofs), ntts, uneven


def test_sharded_batch_equals_the_one_device_batch(tmp_path):
    """The ranks run beside the one-device batch of this process. k = 3 does
    not divide over dp = 2 and is refused."""
    from aleo_tpu.pcs.srs import Srs as JSrs
    from aleo_tpu.snark import indexer as jindexer
    from aleo_tpu.snark import verifier as jver

    ranks = Ranks(tmp_path, 2, batch_worker)
    index, cs_list = _index()
    proofs = tbatch.prove_batch(index, cs_list, rng=random.Random(9))
    want = _as_bytes(index, proofs)
    assert len(set(want)) == len(XS)
    for got, ntts, uneven in ranks.results():
        assert got == want
        assert sum(ntts.values()) > 0
        assert uneven == "refused"
    # the first proof of each rank under the JAX package's verifier
    jindex = jindexer.index_r1cs(cs_list[0], srs=JSrs.generate(63, seed=SRS_SEED))
    assert jindex.index_commitments() == index.index_commitments()
    jvk = jver.VerifyingKey.from_index(jindex)
    for i in (0, 2):
        assert jver.verify(jvk, cs_list[i].public_inputs(), proofs[i])
