"""The port's batch-affine MSM (aleo_tpu_torch.msm.msm) on the CPU against
the host oracle: the cases of tests/test_msm.py at N=17 with c=8 and c=4,
plus N=300 at auto_c. Tolerance 0 (group elements)."""

import random

import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.msm import msm as jmsm
from aleo_tpu.reference.curve import G1
from aleo_tpu.reference.msm import msm_naive
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.msm import msm as tmsm

N = 17
R = params.R
GEN = G1.generator()


def _pad(scalars, pts):
    return scalars + [0] * (N - len(scalars)), pts + [None] * (N - len(pts))


def _random_case():
    rng = random.Random(300)
    pts = [G1.mul(rng.randrange(1, 10_000), GEN) for _ in range(N)]
    scalars = [rng.randrange(R) for _ in range(N)]
    scalars[3] = 0          # zero scalar
    pts[5] = None           # identity point
    return scalars, pts


def _duplicate_case():
    return _pad([1, 1, 1, 2, 2, 3, 255, 256, R - 1], [GEN] * 9)


def _complete_law_case():
    """Duplicate points in one bucket (tangent), P and -P (cancellation),
    zero scalar, identity point, r - 1."""
    return _pad([1, 1, 1, 2, R - 1, 7, 255, 256], [GEN] * 5 + [None, GEN, GEN])


def _opposite_points_case():
    p = G1.mul(12345, GEN)
    return _pad([5, 5, 9, R - 9, 0, 1], [p, G1.neg(p), p, p, p, None])


CASES = {
    "random": _random_case,
    "duplicates": _duplicate_case,
    "complete_law": _complete_law_case,
    "opposite_points": _opposite_points_case,
}


@pytest.mark.parametrize("c", [8, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_msm_matches_oracle(case, c):
    scalars, pts = CASES[case]()
    assert tmsm.msm_host(scalars, pts, c=c, device="cpu") == msm_naive(scalars, pts)


def test_msm_300_points_at_auto_c():
    rng = random.Random(301)
    p = G1.mul(rng.randrange(1, R), GEN)
    pts = []
    for _ in range(300):
        pts.append(p)
        p = G1.add(p, GEN)
    scalars = [rng.randrange(R) for _ in range(300)]
    scalars[0], scalars[1], pts[2] = 0, R - 1, None
    assert tmsm.auto_c(300) == jmsm.auto_c(300)
    assert tmsm.msm_host(scalars, pts, device="cpu") == msm_naive(scalars, pts)


def test_lazy_scalars_give_the_same_point():
    """from_mont may hand the MSM k + r: the digits cover 254 bits."""
    scalars, pts = _random_case()
    lazy = [s + R if s + R < (1 << 254) else s for s in scalars]
    raw = limbs.to_tensor(limbs.ints_to_limbs(lazy, 16), "cpu")
    from aleo_tpu_torch.curves import g1

    table = tmsm.make_table(g1.encode_points(pts, device="cpu"))
    assert tmsm.msm_fast_host(raw, table, c=8) == msm_naive(scalars, pts)


@pytest.mark.parametrize("c", [3, 4, 8, 12, 13, 16])
def test_signed_digits_match_jax(c):
    import jax.numpy as jnp

    rng = random.Random(c)
    xs = [rng.randrange(R) for _ in range(40)] + [0, 1, R - 1, (1 << 254) - 1]
    raw = limbs.ints_to_limbs(xs, 16)
    t = tmsm.signed_digits(torch.from_numpy(raw.copy()), c)
    j = jmsm.signed_digits(jnp.asarray(raw.astype(np.uint32)), c)
    assert np.array_equal(t.numpy(), np.asarray(j))
    w = np.arange(t.shape[0])
    for col, x in enumerate(xs):
        assert sum(int(d) << (c * int(k)) for d, k in zip(t[:, col], w)) == x


@pytest.mark.parametrize("c", [4, 8, 12])
def test_lane_layout_matches_jax(c):
    w = tmsm._nwin(c)
    assert w == jmsm._nwin(c)
    assert tmsm._top_window_split(c, w) == jmsm._top_window_split(c, w)
    tl, jl = tmsm._lane_layout_np(c, w), jmsm._lane_layout_np(c, w)
    for a, b in zip(tl, jl):
        if isinstance(a, list):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))
