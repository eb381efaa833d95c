"""The port's device Poseidon (aleo_tpu_torch.hash.poseidon) against the JAX
package's (aleo_tpu.hash.poseidon) and the host oracle, at rates 2, 4 and 8,
on the CPU. Tolerance 0: equal limbs.

The parameters are built by each package from its own copy of
`reference/poseidon.py`; the first test is the check that they carried
across. Per rate the JAX package runs one permutation shape (its
`hash_batch` over B rows calls the same compiled permutation as `permute`
on B states), so it compiles once a rate.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields.modring import FR_RING as JF
from aleo_tpu.hash import poseidon as jpos
from aleo_tpu_torch.fields.modring import FR_RING as TF
from aleo_tpu_torch.hash import poseidon as tpos
from aleo_tpu_torch.reference import poseidon as ref

R = params.R
RATES = [2, 4, 8]
B, K = 3, 4        # rows of the hash, inputs a row (the record scan's shape, cut)


def _same(jv, tv):
    a = np.asarray(jv).astype(np.int64)
    b = tv.numpy().astype(np.int64)
    assert a.shape == b.shape and np.array_equal(a, b)


def _rows(rng, b, k):
    rows = [[rng.randrange(R) for _ in range(k)] for _ in range(b)]
    jx = jnp.stack([JF.encode(r) for r in rows])
    tx = torch.stack([TF.encode(r, device="cpu") for r in rows])
    return rows, jx, tx


@pytest.mark.parametrize("rate", RATES)
def test_device_params_match_jax(rate):
    j, t = jpos.device_params(rate), tpos.device_params(rate)
    assert (t.rate, t.t, t.full, t.partial) == (j.rate, j.t, j.full, j.partial)
    assert np.array_equal(t.ark.astype(np.int64), np.asarray(j.ark).astype(np.int64))
    assert np.array_equal(t.mds.astype(np.int64), np.asarray(j.mds).astype(np.int64))
    assert np.array_equal(t.full_flag, j.full_flag)
    ark, mds = t.tensors(torch.device("cpu"))
    assert ark.shape == (t.full + t.partial, rate + 1, TF.L) and mds.dtype == torch.int32


@pytest.mark.parametrize("rate", RATES)
def test_permute_matches_jax_and_host(rate):
    rng = random.Random(600 + rate)
    states, js, ts = _rows(rng, B, rate + 1)
    got = tpos.permute(ts, rate)
    _same(jpos.permute(js, rate), got)
    p = ref.PoseidonParams.standard(rate)
    for i, s in enumerate(states):
        assert TF.decode(got[i]).tolist() == ref.permute(s, p)


@pytest.mark.parametrize("rate", RATES)
def test_hash_batch_matches_jax_and_host(rate):
    rng = random.Random(700 + rate)
    rows, jx, tx = _rows(rng, B, K)
    got = tpos.hash_batch(rate, tx)
    _same(jpos.hash_batch(rate, jx), got)
    assert TF.decode(got).tolist() == [ref.hash_psd(rate, r) for r in rows]
    # another domain and a longer row (several permutations at rate 2)
    rows, jx, tx = _rows(rng, B, 2 * rate + 1)
    got = tpos.hash_batch(rate, tx, domain="T")
    _same(jpos.hash_batch(rate, jx, domain="T"), got)
    assert TF.decode(got).tolist() == [ref.hash_psd(rate, r, domain="T") for r in rows]
