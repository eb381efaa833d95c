"""The shared-table multi-MSM of the port (`msm_windows_batch`,
`msm_batch_host`) on the CPU, tolerance 0: the k-fold lane layout and bucket
grid against the reference's arrays, and k MSMs over one table in both MSM
modes against `aleo_tpu.msm.msm.msm_batch_host`, against k calls of the
port's `msm_fast_host` and against the host Pippenger."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.curves import g1 as jg1
from aleo_tpu.msm import msm as jmsm
from aleo_tpu.reference.curve import G1
from aleo_tpu.reference.msm import msm_pippenger_jac
from aleo_tpu_torch import config
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.curves import g1_fused as gf
from aleo_tpu_torch.fields import limbs
from aleo_tpu_torch.msm import msm as tmsm

R = params.R
GEN = G1.generator()
N, K, C = 64, 3, 6          # the shape of tests/test_msm.py's batch case

MODES = [("1", "affine"), ("0", "projective")]


@pytest.fixture(scope="module")
def case():
    rng = random.Random(404)
    pts, cur = [], GEN
    for _ in range(N):
        pts.append(cur)
        cur = G1.add(cur, GEN)
    pts[7] = None                                   # an identity point
    scal = [[rng.randrange(R) for _ in range(N)] for _ in range(K)]
    scal[0][0], scal[1][1], scal[2][2] = 0, R - 1, 1
    scal[1][8:12] = scal[0][8:12]                   # equal digits in two MSMs
    raw = np.stack([limbs.ints_to_limbs(s, 16) for s in scal])      # (K, N, 16)
    want = [msm_pippenger_jac(s, pts, c=8) for s in scal]
    return pts, scal, raw, want


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("c", [4, 6, 12])
def test_lane_layout_matches_jax_for_k_msms(c, k):
    w = tmsm._nwin(c)
    tl, jl = tmsm._lane_layout_np(c, w, k), jmsm._lane_layout_np(c, w, k)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        if isinstance(a, list):
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert tl[0].shape == (k * w * (1 << (c - 1)),)


@pytest.mark.parametrize("k", [1, 3])
def test_bucket_grid_matches_jax_for_k_msms(case, k):
    _, _, raw, _ = case
    raw = raw[:k]
    c, w = C, tmsm._nwin(C)
    digits = tmsm.signed_digits(torch.from_numpy(raw.copy()), c)            # (k, W, N)
    jd = np.stack([np.asarray(jmsm.signed_digits(jnp.asarray(r.astype(np.uint32)), c))
                   for r in raw])
    assert np.array_equal(digits.numpy(), jd)
    ids = torch.arange(k * w, dtype=torch.int64).repeat_interleave(N)
    keys = tmsm._sort_keys(ids // w, ids % w, digits.abs().to(torch.int64).reshape(-1), c)
    # the reference's own packing of the same entries (uint32)
    mag = np.abs(jd).astype(np.uint32).reshape(-1)
    proof = np.repeat(np.arange(k, dtype=np.uint32), w * N)
    win = np.tile(np.repeat(np.arange(w, dtype=np.uint32), N), k)
    jkeys = (win << c) | mag if k == 1 else (proof << (c + 8)) | (win << c) | mag
    assert np.array_equal(keys.numpy(), jkeys.astype(np.int64))
    sk, _ = torch.sort(keys, stable=True)
    got = tmsm._bucket_grid(sk, c, w, k)
    ref = jmsm._bucket_grid(jnp.asarray(np.sort(jkeys, kind="stable")), c, w, k, k * w * N)
    for a, b in zip(got[:3], ref[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    assert got[6] == ref[6]
    assert int(got[2].sum()) == int((digits != 0).sum())        # every entry in one lane


@pytest.mark.parametrize("mode,name", MODES)
def test_msm_batch_host_matches_single_msms_and_oracle(case, mode, name, monkeypatch):
    pts, scal, raw, want = case
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", mode)
    table = tmsm.make_table(tg1.encode_points(pts, device="cpu"))
    t_raw = torch.from_numpy(raw.copy())
    calls = {"af": 0, "lf": 0}
    real_af, real_lf = tmsm._accumulate_buckets_af, tmsm._accumulate_buckets
    monkeypatch.setattr(tmsm, "_accumulate_buckets_af",
                        lambda *a: (calls.__setitem__("af", calls["af"] + 1), real_af(*a))[1])
    monkeypatch.setattr(tmsm, "_accumulate_buckets",
                        lambda *a: (calls.__setitem__("lf", calls["lf"] + 1), real_lf(*a))[1])
    got = tmsm.msm_batch_host(t_raw, table, c=C)
    assert calls == ({"af": 1, "lf": 0} if mode == "1" else {"af": 0, "lf": 1})
    assert got == want
    singles = [tmsm.msm_fast_host(t_raw[p], table, c=C) for p in range(K)]
    assert got == singles


def test_msm_batch_host_matches_jax(case):
    pts, _, raw, want = case
    jtable = jmsm.make_table(jg1.encode_points(pts))
    ref = jmsm.msm_batch_host(jnp.asarray(raw.astype(np.uint32)), jtable, c=C)
    table = tmsm.make_table(tg1.encode_points(pts, device="cpu"))
    assert tmsm.msm_batch_host(torch.from_numpy(raw.copy()), table, c=C) == ref == want


@pytest.mark.parametrize("mode,name", MODES)
def test_window_totals_of_a_batch_equal_the_single_msms(case, mode, name, monkeypatch):
    """Lane p * W + w of the batch holds MSM p's window-w total."""
    pts, _, raw, _ = case
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", mode)
    table = tmsm.make_table(tg1.encode_points(pts, device="cpu"))
    t_raw = torch.from_numpy(raw.copy())
    w = tmsm._nwin(C)
    batch = gf.decode_lf(tmsm.msm_windows_batch(t_raw, table, C))
    assert len(batch) == K * w
    for p in range(K):
        assert batch[p * w : (p + 1) * w] == gf.decode_lf(tmsm.msm_windows(t_raw[p], table, C))


@pytest.mark.parametrize("mode,name", MODES)
def test_batch_of_one_and_auto_c(case, mode, name, monkeypatch):
    pts, scal, raw, want = case
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", mode)
    table = tmsm.make_table(tg1.encode_points(pts, device="cpu"))
    one = torch.from_numpy(raw[:1].copy())
    assert tmsm.msm_batch_host(one, table, c=C) == want[:1]
    assert tmsm.auto_c(N) == jmsm.auto_c(N)
    assert tmsm.msm_batch_host(one, table) == want[:1]          # c = auto_c(N) = 5


def test_round_count_is_read_once_for_the_whole_batch(case, monkeypatch):
    """One device->host read of max(count) for k MSMs, and about a single
    MSM's rounds (the tail of the occupancy is shared)."""
    pts, _, raw, _ = case
    table = tmsm.make_table(tg1.encode_points(pts, device="cpu"))
    t_raw = torch.from_numpy(raw.copy())
    rounds = []
    real = gf.add_sel_lf
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", "0")
    monkeypatch.setattr(gf, "add_sel_lf", lambda *a: (rounds.append(a[0].x.shape[1]), real(*a))[1])
    tmsm.msm_windows_batch(t_raw, table, C)
    batch_rounds = len(rounds)
    assert set(rounds) == {K * tmsm._nwin(C) * (1 << (C - 1))}
    rounds.clear()
    single = []
    for p in range(K):
        tmsm.msm_windows(t_raw[p], table, C)
        single.append(len(rounds))
        rounds.clear()
    assert batch_rounds == max(single)


def test_key_packing_assertion():
    table = torch.zeros((4, 48), dtype=torch.int32)
    with pytest.raises(AssertionError, match="sort key packing"):
        tmsm.msm_batch_host(torch.zeros((1 << 12, 4, 16), dtype=torch.int32), table, c=12)
    # 12 + 8 + bits(2047) = 31 fits
    assert 12 + 8 + (2047).bit_length() <= 32 < 12 + 8 + (1 << 12).bit_length()
