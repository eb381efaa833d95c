"""The port's butterfly NTT (aleo_tpu_torch.ntt.ntt) on the CPU against
aleo_tpu.ntt.ntt and the host oracle. Tolerance 0 (field elements)."""

import random

import numpy as np
import pytest

from aleo_tpu import params
from aleo_tpu.fields import fr_lf as jlf
from aleo_tpu.ntt import ntt as jntt
from aleo_tpu.reference import polynomial as rpoly
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.ntt import ntt as tntt

R = params.R
SHIFT = params.FR_GENERATOR


def _both(xs):
    return jlf.encode(xs), tlf.encode(xs, device="cpu")


def _same(j, t):
    assert [int(v) for v in jlf.decode(j)] == tlf.decode(t)


@pytest.mark.parametrize("logn", [4, 5, 6, 7, 8, 9, 10])
def test_ntt_lf_and_intt_lf_match_jax(logn):
    n = 1 << logn
    rng = random.Random(logn)
    xs = [rng.randrange(R) for _ in range(n)]
    ja, ta = _both(xs)
    _same(jntt.ntt_lf(ja), tntt.ntt_lf(ta))
    _same(jntt.intt_lf(ja), tntt.intt_lf(ta))
    assert tlf.decode(tntt.intt_lf(tntt.ntt_lf(ta))) == xs


@pytest.mark.parametrize("logn", [4, 7, 10])
def test_coset_pair_matches_jax(logn):
    n = 1 << logn
    rng = random.Random(50 + logn)
    xs = [rng.randrange(R) for _ in range(n)]
    ja, ta = _both(xs)
    _same(jntt.coset_ntt_lf(ja, SHIFT), tntt.coset_ntt_lf(ta, SHIFT))
    _same(jntt.coset_intt_lf(ja, SHIFT), tntt.coset_intt_lf(ta, SHIFT))
    assert tlf.decode(tntt.coset_intt_lf(tntt.coset_ntt_lf(ta, SHIFT), SHIFT)) == xs


def test_ntt_above_the_references_four_step_threshold():
    """The reference switches to its 4-step form at 2^13; the port has one
    transform, which must give the same values there."""
    n = jntt.FOUR_STEP_MIN
    rng = random.Random(13)
    xs = [rng.randrange(R) for _ in range(n)]
    ja, ta = _both(xs)
    _same(jntt.ntt_lf(ja), tntt.ntt_lf(ta))


@pytest.mark.parametrize("n", [1, 2, 64])
def test_ntt_matches_host_oracle(n):
    rng = random.Random(200 + n)
    xs = [rng.randrange(R) for _ in range(n)]
    ta = tlf.encode(xs, device="cpu")
    assert tlf.decode(tntt.ntt_lf(ta)) == rpoly.ntt(xs)
    assert tlf.decode(tntt.coset_ntt_lf(ta, SHIFT)) == rpoly.coset_ntt(xs, SHIFT)


def test_limbs_last_intt_is_canonical_and_matches_jax():
    n = 64
    rng = random.Random(3)
    xs = [rng.randrange(R) for _ in range(n)]
    ja, ta = _both(xs)
    j = np.asarray(jntt.intt(ja.T)).astype(np.int64)
    t = tntt.intt(ta.T.contiguous())
    assert t.shape == (n, 16)
    assert np.array_equal(j, t.numpy().astype(np.int64))
    assert np.array_equal(np.asarray(jntt.ntt(ja.T)).astype(np.int64),
                          tntt.ntt(ta.T.contiguous()).numpy().astype(np.int64))


def test_domain_tables_match_jax():
    for n in (1, 8, 256):
        dj, dt = jntt.domain(n), tntt.domain(n)
        assert (dj.w, dj.w_inv, dj.n_inv) == (dt.w, dt.w_inv, dt.n_inv)
        assert np.array_equal(np.asarray(dj.wpow_np).astype(np.int64),
                              dt.wpow_np.astype(np.int64))
        assert np.array_equal(np.asarray(dj.bitrev_np).astype(np.int64), dt.bitrev_np)
