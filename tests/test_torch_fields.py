"""Plain limb arithmetic of the port (aleo_tpu_torch.fields) on the CPU,
held against host integers and against aleo_tpu.fields.fr_lf.

Tolerance 0 everywhere: every value is a field element.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.fields import fr_lf as jlf
from aleo_tpu_torch.fields import fr_lf as tlf
from aleo_tpu_torch.fields import limb_kernels as lk
from aleo_tpu_torch.fields import limbs

R, Q = params.R, params.Q


def _lazy_pair(rng, p, n):
    """Operands < 2p with the edges planted."""
    xs = [rng.randrange(2 * p) for _ in range(n)]
    ys = [rng.randrange(2 * p) for _ in range(n)]
    xs[:6] = [0, p, 2 * p - 1, p - 1, 1, p + 1]
    ys[:6] = [0, 2 * p - 1, 2 * p - 1, 1, p, p - 1]
    return xs, ys


def _raw(xs, L):
    return limbs.to_tensor(limbs.ints_to_limbs(xs, L).T, "cpu")


def _ints(t):
    return limbs.limbs_to_ints(limbs.to_numpy(t).T)


RINGS = [("Fr", lk.get_fr), ("Fq", lk.get_fq)]


@pytest.mark.parametrize("name,get", RINGS)
@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg", "mul3", "normalize", "is_zero"])
def test_plain_ops_match_host_ints_on_lazy_inputs(name, get, op):
    ring = get()
    p, L = ring.p, ring.L
    rng = random.Random(f"{name}-{op}")
    xs, ys = _lazy_pair(rng, p, 257)
    a, b = _raw(xs, L), _raw(ys, L)
    rinv = pow(ring.R, -1, p)
    if op == "mul":
        got = _ints(lk.mont_mul(ring, a, b))
        assert all(v < 2 * p and v % p == x * y * rinv % p for v, x, y in zip(got, xs, ys))
    elif op == "add":
        got = _ints(lk.add(ring, a, b))
        assert all(v < 2 * p and v % p == (x + y) % p for v, x, y in zip(got, xs, ys))
    elif op == "sub":
        got = _ints(lk.sub(ring, a, b))
        assert all(v < 2 * p and v % p == (x - y) % p for v, x, y in zip(got, xs, ys))
    elif op == "neg":
        got = _ints(lk.neg(ring, a))
        assert all(v <= 2 * p and v % p == (-x) % p for v, x in zip(got, xs))
    elif op == "mul3":
        got = _ints(lk.mul3(ring, a))
        assert all(v < 2 * p and v % p == 3 * x % p for v, x in zip(got, xs))
    elif op == "normalize":
        assert _ints(lk.normalize(ring, a)) == [x % p for x in xs]
    else:
        assert lk.is_zero_mod_p(ring, a)[0].tolist() == [x % p == 0 for x in xs]


def test_storage_dtype_and_layout():
    a = tlf.encode([1, 2, 3], device="cpu")
    assert a.dtype == torch.int32 and a.shape == (16, 3)
    assert tlf.mul(a, a).dtype == torch.int32
    assert int(a.max()) < 1 << 16


def _both(xs):
    """The same host ints, encoded by both packages."""
    return jlf.encode(xs), tlf.encode(xs, device="cpu")


def _same(j, t):
    """JAX (L, N) result vs port (L, N) result, as canonical host ints."""
    assert [int(v) for v in jlf.decode(j)] == tlf.decode(t)


@pytest.mark.parametrize("n", [1, 2, 37, 256])
def test_fr_lf_elementwise_matches_jax(n):
    rng = random.Random(n)
    xs = [rng.randrange(R) for _ in range(n)]
    ys = [rng.randrange(R) for _ in range(n)]
    ja, ta = _both(xs)
    jb, tb = _both(ys)
    _same(jlf.mul(ja, jb), tlf.mul(ta, tb))
    _same(jlf.sq(ja), tlf.sq(ta))
    _same(jlf.add(ja, jb), tlf.add(ta, tb))
    _same(jlf.sub(ja, jb), tlf.sub(ta, tb))
    _same(jlf.neg(ja), tlf.neg(ta))
    # encodings are bit-identical (same Montgomery radix, same limbs)
    assert np.array_equal(np.asarray(ja).astype(np.int64), ta.numpy().astype(np.int64))
    # from_mont may be lazy (< 2r) in the port: equal mod r
    jm = [int(v) for v in limbs.limbs_to_ints(np.asarray(jlf.from_mont(ja)).T)]
    tm = _ints(tlf.from_mont(ta))
    assert [v % R for v in tm] == jm == xs


@pytest.mark.parametrize("n", [1, 2, 5, 37, 64])
def test_fr_lf_composites_match_jax(n):
    rng = random.Random(100 + n)
    xs = [rng.randrange(1, R) for _ in range(n)]
    ja, ta = _both(xs)
    _same(jlf.scan_mul(ja), tlf.scan_mul(ta))
    _same(jlf.scan_mul(ja, reverse=True), tlf.scan_mul(ta, reverse=True))
    _same(jlf.batch_inv(ja), tlf.batch_inv(ta))
    _same(jlf.tree_sum(ja), tlf.tree_sum(ta))
    _same(jlf.powers(ja[:, :1], n + 3), tlf.powers(ta[:, :1], n + 3))
    _same(jlf.select(jnp.asarray([i % 2 == 0 for i in range(n)]), ja, jlf.sq(ja)),
          tlf.select(torch.tensor([i % 2 == 0 for i in range(n)]), ta, tlf.sq(ta)))
    assert tlf.decode(tlf.inv(ta)) == [pow(x, -1, R) for x in xs]


def test_fr_lf_constants_match_jax():
    _same(jlf.one(3), tlf.one(3, device="cpu"))
    _same(jlf.zero(3), tlf.zero(3, device="cpu"))
    _same(jlf.const(R - 5, 2), tlf.const(R - 5, 2, device="cpu"))


def test_ops_accept_lazy_results_of_each_other():
    """A chain of lazy ops decodes to the right value."""
    rng = random.Random(9)
    xs = [rng.randrange(R) for _ in range(50)]
    a = tlf.encode(xs, device="cpu")
    v = tlf.sub(tlf.mul(tlf.add(a, a), tlf.neg(a)), tlf.sq(a))
    assert tlf.decode(v) == [(-2 * x * x - x * x) % R for x in xs]


def test_fr_lf_inv_and_batch_inv_give_zero_on_zero_lanes_as_jax():
    """inv(0) = 0 (the reference's Fermat chain), and a row of batch_inv
    with a zero in it is all zeros, as in the reference."""
    ja, ta = _both([0, 5, R - 1])
    _same(jlf.inv(ja), tlf.inv(ta))
    assert tlf.decode(tlf.inv(ta)) == [0, pow(5, -1, R), R - 1]
    jb, tb = _both([3, 0, 5])
    _same(jlf.batch_inv(jb), tlf.batch_inv(tb))
    assert tlf.decode(tlf.batch_inv(tb)) == [0, 0, 0]
    # per batch row: only the row that holds the zero is zeroed
    rows = [[3, 0, 5], [2, 7, 11]]
    tk = torch.stack([tlf.encode(r, device="cpu") for r in rows], dim=1)
    out = tlf.batch_inv(tk)
    assert tlf.decode(out[:, 0]) == [0, 0, 0]
    assert tlf.decode(out[:, 1]) == [pow(x, -1, R) for x in rows[1]]


def test_fr_lf_layout_converters_match_jax():
    ja, ta = _both([1, 2, 3])
    assert np.array_equal(np.asarray(jlf.to_ll(ja)).astype(np.int64),
                          tlf.to_ll(ta).numpy().astype(np.int64))
    assert torch.equal(tlf.from_ll(tlf.to_ll(ta)), ta)
