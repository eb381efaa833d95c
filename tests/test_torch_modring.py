"""The port's limbs-last `ModRing` (aleo_tpu_torch.fields.modring) against the
JAX package's (aleo_tpu.fields.modring), for Fr and Fq, on the CPU.

The same host ints go into both; every op's limbs must be equal, bit for
bit (the reference returns canonical limbs, so the port must too), and
equal to host integers. Tolerance 0. The JAX ops run under `jax.jit`: op by
op, XLA compiles each of their primitives for every new shape, which costs
seconds a call on the CPU.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu.fields import modring as jmr
from aleo_tpu_torch.fields import modring as tmr

RINGS = ["Fr", "Fq"]


def _rings(name):
    return {"Fr": (jmr.FR_RING, tmr.FR_RING), "Fq": (jmr.FQ_RING, tmr.FQ_RING)}[name]


@functools.lru_cache(maxsize=None)
def _jit(name, op, *static):
    """The JAX ring's op, jitted once per (ring, op, static arguments)."""
    fn = getattr(_rings(name)[0], op)
    return jax.jit(lambda *a: fn(*a, *static))


def _ints(rng, p, n, zeros=()):
    xs = [rng.randrange(p) for _ in range(n)]
    xs[:4] = [1, p - 1, 2, p - 2][: min(4, n)]
    for i in zeros:
        xs[i] = 0
    return xs


def _both(j, t, xs):
    return j.encode(xs), t.encode(xs, device="cpu")


def _same(jv, tv, p):
    """Equal limbs, canonical (< p) on every lane."""
    a = np.asarray(jv).astype(np.int64)
    b = tv.numpy().astype(np.int64)
    assert a.shape == b.shape and np.array_equal(a, b)
    flat = tmr.limbs_to_ints(tv.numpy()).reshape(-1)
    assert all(v < p for v in flat)


@pytest.mark.parametrize("name", RINGS)
def test_constants_and_host_helpers_match_jax(name):
    j, t = _rings(name)
    assert (t.p, t.L, t.R_mont, t.R_mod, t.R2, t.nprime) == (
        j.p, j.L, j.R_mont, j.R_mod, j.R2, j.nprime)
    for k in ("p_limbs", "np_limbs", "r2_limbs", "one_mont", "zero"):
        assert np.array_equal(np.asarray(getattr(j, k)).astype(np.int64),
                              getattr(t, k).astype(np.int64)), k
    xs = _ints(random.Random(1), t.p, 9)
    assert np.array_equal(jmr.ints_to_limbs(xs, t.L).astype(np.int64),
                          tmr.ints_to_limbs(xs, t.L).astype(np.int64))
    assert np.array_equal(jmr.int_to_limbs(xs[5], t.L).astype(np.int64),
                          tmr.int_to_limbs(xs[5], t.L).astype(np.int64))
    a3 = tmr.ints_to_limbs(xs[:6], t.L).reshape(2, 3, t.L)
    assert tmr.limbs_to_ints(a3).tolist() == jmr.limbs_to_ints(a3).tolist()
    assert np.array_equal(j.to_mont_host(xs).astype(np.int64), t.to_mont_host(xs).astype(np.int64))


@pytest.mark.parametrize("name", RINGS)
def test_encode_decode_const_match_jax(name):
    j, t = _rings(name)
    xs = _ints(random.Random(2), t.p, 11, zeros=(7,))
    ja, ta = _both(j, t, xs)
    _same(ja, ta, t.p)
    dec = t.decode(ta)
    assert isinstance(dec, np.ndarray) and dec.dtype == object and dec.shape == (11,)
    assert dec.tolist() == j.decode(ja).tolist() == xs
    one = t.decode(ta[3])                               # (L,) -> one int
    assert isinstance(one, int) and one == j.decode(ja[3]) == xs[3]
    assert t.decode(ta.reshape(1, 11, t.L)).shape == (1, 11)
    _same(j.const(t.p - 7), t.const(t.p - 7, device="cpu"), t.p)
    assert t.from_mont_host(t.to_mont_host(xs)).tolist() == xs


@pytest.mark.parametrize("name", RINGS)
def test_add_sub_neg_double_match_jax(name):
    j, t = _rings(name)
    J = functools.partial(_jit, name)
    rng = random.Random(3)
    xs = _ints(rng, t.p, 33, zeros=(5, 6))
    ys = _ints(rng, t.p, 33, zeros=(6, 9))
    ys[10] = xs[10]
    (ja, ta), (jb, tb) = _both(j, t, xs), _both(j, t, ys)
    _same(J("add")(ja, jb), t.add(ta, tb), t.p)
    _same(J("sub")(ja, jb), t.sub(ta, tb), t.p)
    _same(J("neg")(ja), t.neg(ta), t.p)
    _same(J("double")(ja), t.double(ta), t.p)
    p = t.p
    assert t.decode(t.sub(ta, tb)).tolist() == [(x - y) % p for x, y in zip(xs, ys)]
    assert t.decode(t.neg(ta)).tolist() == [(-x) % p for x in xs]


@pytest.mark.parametrize("name", RINGS)
def test_mul_and_broadcast_shapes_match_jax(name):
    j, t = _rings(name)
    J = functools.partial(_jit, name)
    rng = random.Random(4)
    xs = _ints(rng, t.p, 24, zeros=(4,))
    ys = _ints(rng, t.p, 24)
    (ja, ta), (jb, tb) = _both(j, t, xs), _both(j, t, ys)
    _same(J("mul")(ja, jb), t.mul(ta, tb), t.p)
    _same(J("sq")(ja), t.sq(ta), t.p)
    assert t.decode(t.mul(ta, tb)).tolist() == [x * y % t.p for x, y in zip(xs, ys)]
    # (L,) against (N, L)
    _same(J("mul")(ja, jb[7]), t.mul(ta, tb[7]), t.p)
    # (t, t, L) against (B, 1, t, L), as poseidon's MDS product
    jm, tm = ja[:9].reshape(3, 3, -1), ta[:9].reshape(3, 3, -1)
    js, ts = jb[:12].reshape(4, 1, 3, -1), tb[:12].reshape(4, 1, 3, -1)
    _same(J("mul")(jm, js), t.mul(tm, ts), t.p)
    _same(J("add")(jm, js), t.add(tm, ts), t.p)


@pytest.mark.parametrize("name", RINGS)
def test_mul_small_and_pow_fixed_match_jax(name):
    j, t = _rings(name)
    J = functools.partial(_jit, name)
    xs = _ints(random.Random(5), t.p, 10, zeros=(8,))
    ja, ta = _both(j, t, xs)
    for k in (0, 3):
        _same(J("mul_small", k)(ja), t.mul_small(ta, k), t.p)
    for e in (2, 17):
        _same(J("pow_fixed", e)(ja), t.pow_fixed(ta, e), t.p)
    # more constants against host ints only (each is an XLA compile)
    for k in (1, 8):
        assert t.decode(t.mul_small(ta, k)).tolist() == [k * x % t.p for x in xs]
    for e in (1, 255):
        assert t.decode(t.pow_fixed(ta, e)).tolist() == [pow(x, e, t.p) for x in xs]


@pytest.mark.parametrize("name", RINGS)
def test_inv_with_zero_lanes_matches_jax(name):
    j, t = _rings(name)
    J = functools.partial(_jit, name)
    xs = _ints(random.Random(6), t.p, 6, zeros=(4,))
    ja, ta = _both(j, t, xs)
    got = t.inv(ta)
    _same(J("inv")(ja), got, t.p)
    assert t.decode(got).tolist() == [pow(x, t.p - 2, t.p) for x in xs]
    assert t.decode(got)[4] == 0
    # any number of lanes: a (2, 3, L) batch
    assert torch.equal(t.inv(ta.reshape(2, 3, -1)), got.reshape(2, 3, -1))


@pytest.mark.parametrize("name", RINGS)
def test_scans_and_batch_inv_match_jax(name):
    j, t = _rings(name)
    J = functools.partial(_jit, name)
    rng = random.Random(7)
    xs = _ints(rng, t.p, 7)
    zs = list(xs)
    zs[3] = 0                                   # a zero lane
    (ja, ta), (jz, tz) = _both(j, t, xs), _both(j, t, zs)
    _same(J("scan_mul")(ja), t.scan_mul(ta), t.p)
    _same(J("scan_mul", True)(ja), t.scan_mul(ta, reverse=True), t.p)
    got = t.batch_inv(ta)
    _same(J("batch_inv")(ja), got, t.p)
    assert t.decode(got).tolist() == [pow(x, -1, t.p) for x in xs]
    # the zero lane zeroes the whole batch, as in the reference
    got = t.batch_inv(tz)
    _same(J("batch_inv")(jz), got, t.p)
    assert t.decode(got).tolist() == [0] * 7
    _same(J("batch_inv")(ja[:1]), t.batch_inv(ta[:1]), t.p)


@pytest.mark.parametrize("name", RINGS)
def test_forms_and_predicates_match_jax(name):
    j, t = _rings(name)
    J = functools.partial(_jit, name)
    rng = random.Random(8)
    xs = _ints(rng, t.p, 9, zeros=(2,))
    raw_j = jnp.asarray(jmr.ints_to_limbs(xs, t.L))
    raw_t = torch.from_numpy(tmr.ints_to_limbs(xs, t.L))
    ja, ta = _both(j, t, xs)
    _same(J("to_mont")(raw_j), t.to_mont(raw_t), t.p)
    _same(J("from_mont")(ja), t.from_mont(ta), t.p)
    assert np.array_equal(t.from_mont(ta).numpy(), tmr.ints_to_limbs(xs, t.L))
    ys = list(xs)
    ys[5] = (ys[5] + 1) % t.p
    jb, tb = _both(j, t, ys)
    assert np.array_equal(np.asarray(j.eq(ja, jb)), t.eq(ta, tb).numpy())
    assert np.array_equal(np.asarray(j.is_zero(ja)), t.is_zero(ta).numpy())
    cond = [i % 3 == 0 for i in range(9)]
    _same(J("select")(jnp.asarray(cond), ja, jb), t.select(torch.tensor(cond), ta, tb), t.p)
