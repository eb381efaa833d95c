"""The port's device ECDH (aleo_tpu_torch.curves.edwards_device) against the
JAX package's (aleo_tpu.curves.edwards_device) and the host oracle
(reference/edwards.py), on the CPU. Tolerance 0: equal affine points.

The JAX ladder compiles once for each length of its bit vector (~12 s of
XLA on the CPU), so the JAX side runs one length, 100 bits: its
`shared_secrets` for the 100-bit view scalar, and its ladder
(`scalar_mul_batch`) on the smaller scalars' bits with leading zeros.
"""

import random

import jax.numpy as jnp
import pytest

from aleo_tpu.curves import edwards_device as jed
from aleo_tpu_torch.curves import edwards_device as ted
from aleo_tpu_torch.reference import edwards as E
from aleo_tpu_torch.reference.field import FR

JAX_BITS = 100
SCALARS = {"one": 1, "two": 2, "100-bit": (1 << 99) | 0x5DEECE66D}


@pytest.fixture(scope="module")
def points():
    rng = random.Random(800)
    return [E.rand(rng) for _ in range(5)]


def test_encode_decode_and_unified_add_match_the_host(points):
    xy = ted.encode_points(points, device="cpu")
    assert ted.decode_points(xy) == points
    jxy = jed.encode_points(points)
    assert jed.decode_points(jxy) == points
    rev = (xy[0].flip(1), xy[1].flip(1))             # the points in reverse order
    got = ted.decode_points(ted._unified_add(xy, rev))
    assert got == [E.add(a, b) for a, b in zip(points, points[::-1])]
    dbl = ted.decode_points(ted._unified_add(xy, xy))
    assert dbl == [E.double(a) for a in points]


def _bits(k, nbits):
    return [(k >> (nbits - 1 - i)) & 1 for i in range(nbits)]


def _jax_shared(k, points):
    if k.bit_length() == JAX_BITS:
        return jed.shared_secrets(k, points)
    xs, ys = jed.encode_points(points)
    bits = jnp.asarray(_bits(k, JAX_BITS), dtype=jnp.uint32)
    return jed.decode_points(jed.scalar_mul_batch(bits, xs, ys))


@pytest.mark.parametrize("name", list(SCALARS))
def test_shared_secrets_match_jax_and_host(points, name):
    k = SCALARS[name]
    got = ted.shared_secrets(k, points, device="cpu")
    assert got == _jax_shared(k, points)
    assert got == [E.mul(k, p) for p in points]
    if k.bit_length() < JAX_BITS:
        # the port's ladder on the same zero-led bits
        xy = ted.encode_points(points, device="cpu")
        assert ted.decode_points(ted.scalar_mul_batch(_bits(k, 8), *xy)) == got


def _f5_point(rng):
    """An off-curve point P with 1 + d*t = 0 in the ladder's second step,
    add(2P, P): for a random u, s = (d^2 u^4 - 1) / (2 d u^2), and x^2, y^2
    the roots of z^2 - s z + u^2 with x y = u."""
    R, D = E.R, E.D
    while True:
        u = rng.randrange(1, R)
        s = (D * D * pow(u, 4, R) - 1) * pow(2 * D * u * u, -1, R) % R
        disc = (s * s - 4 * u * u) % R
        if not FR.is_square(disc):
            continue
        x2 = (s + FR.sqrt(disc)) * pow(2, -1, R) % R
        if x2 == 0 or not FR.is_square(x2):
            continue
        x = FR.sqrt(x2)
        return (x, u * pow(x, -1, R) % R)


def test_an_off_curve_point_leaves_the_other_lanes_right():
    """F5: one off-curve ephemeral point among honest ones. The bare ladder
    inverts a zero denominator in the whole batch and gets every honest lane
    wrong; shared_secrets equals the host ECDH on every lane."""
    rng = random.Random(805)
    bad = _f5_point(rng)
    assert not E.is_on_curve(bad)
    pts = [E.rand(rng) for _ in range(3)] + [bad]
    # 16 bits, the top two set; even, since the host's ladder (low bit
    # first) would meet the same zero denominator adding P to 2P
    view = (0b11 << 14) | (rng.randrange(1 << 13) << 1)
    want = [E.mul(view, p) for p in pts]
    ladder = ted.decode_points(
        ted.scalar_mul_batch(_bits(view, 16), *ted.encode_points(pts, device="cpu")))
    assert all(ladder[i] != want[i] for i in range(3))
    assert ted.shared_secrets(view, pts, device="cpu") == want
