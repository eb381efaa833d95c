"""The port's bench entry point (aleo_tpu_torch/bench.py) on the CPU at small
sizes, held against the JAX package's root `bench.py` (its input makers), the
JAX reference MSM (`msm_naive`) and the JAX NTTs.

Tolerance 0: equal points, scalar and point limbs bit for bit, transforms
equal after normalize; where both packages run MatNTT, raw limbs and the
bench's checksum equal too. (Below MatNTT's threshold the two butterfly
networks keep different lazy representatives of the same values, so there
the values are compared after normalize.)"""

import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aleo_tpu import params
from aleo_tpu.curves import g1 as jg1
from aleo_tpu.fields import fr_lf as jlf
from aleo_tpu.ntt import matntt as jmat
from aleo_tpu.ntt import ntt as jntt
from aleo_tpu.reference.msm import msm_naive
from aleo_tpu_torch import bench, config
from aleo_tpu_torch.curves import g1 as tg1
from aleo_tpu_torch.fields import fr_lf as tlf

torch.set_num_threads(2)        # several test workers share the machine

ROOT = pathlib.Path(__file__).resolve().parent.parent
MODES = {"affine": "1", "projective": "0"}


@pytest.fixture(scope="module")
def jax_bench():
    """The JAX package's root bench.py as a module (its sections do not run)."""
    spec = importlib.util.spec_from_file_location("jax_root_bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _oracle(*limb_arrays):
    return bench.tiled_oracle(bench.class_sums(*limb_arrays))


# -- inputs --------------------------------------------------------------------------


def test_tiled_points_match_the_jax_bench(jax_bench):
    got = bench._tiled_points(256, "cpu")
    want = jax_bench._tiled_points(256)
    for t, j in zip(got, want):
        assert np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))
    pts = tg1.decode_points(got)
    assert pts == jg1.decode_points(want)
    assert pts == bench.host_points() * 4 and len(set(pts[:64])) == 64


@pytest.mark.parametrize("seed", [0xBE7C, 100, 7003])
def test_rand_scalars_match_the_jax_bench(jax_bench, seed):
    got = bench._rand_scalars(1024, seed, "cpu")
    assert got.dtype == torch.int32 and got.shape == (1024, 16)
    want = np.asarray(jax_bench._rand_scalars(1024, seed)).astype(np.int64)
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert np.array_equal(bench._rand_limbs(1024, seed).astype(np.int64), want)


def test_tiled_oracle_matches_msm_naive():
    a = bench._rand_limbs(128, 5)
    scalars = [sum(int(v) << (16 * k) for k, v in enumerate(row)) for row in a]
    want = msm_naive(scalars, bench.host_points() * 2)
    assert want is not None and _oracle(a) == want
    # the class sums of chunks add up to those of the whole
    assert np.array_equal(bench.class_sums(a[:64], a[64:]), bench.class_sums(a))


# -- the MSM sections ----------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_bench_msm_matches_the_oracle(monkeypatch, mode):
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", MODES[mode])
    detail = {}
    pps, out, outs = bench.bench_msm(detail, "cpu", n=256, iters=1, k=1)
    assert out == _oracle(bench._rand_limbs(256, 0xBE7C))
    assert outs == [_oracle(bench._rand_limbs(256, 100))]
    assert pps > 0
    assert {"msm_2e8_ms", "msm_compile_s", "msm_u32_mul_g_per_s", "msm_batch1_2e8_ms",
            "msm_batch1_pts_per_s"} == set(detail)


@pytest.mark.parametrize("mode", MODES)
def test_chunked_msm_matches_the_oracle(monkeypatch, mode):
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", MODES[mode])
    detail = {}
    acc, parts = bench.bench_msm_2e24(detail, "cpu", chunk=128, n_chunks=4)
    chunks = [bench._rand_limbs(128, 7000 + i) for i in range(4)]
    assert parts == [_oracle(c) for c in chunks]
    assert acc == _oracle(*chunks)
    assert set(detail) == {"msm_2e9_s", "msm_2e9_pts_per_s"}


# -- the NTT section -----------------------------------------------------------------


SHIFTS = {"ntt_2e12": None, "coset_ntt_2e12": params.FR_GENERATOR}


@pytest.fixture(scope="module")
def jax_chains():
    """The JAX chains of 10 transforms on the first 4096 values of the JAX
    bench's draw: `ntt_lf` / `coset_ntt_lf`, and the MatNTT entry points."""
    rng = np.random.default_rng(0xA1E0)
    vals = [int.from_bytes(rng.bytes(31), "little") % params.R for _ in range(1 << 12)]
    data = jlf.encode(vals)
    out = {"data": data}
    for name, shift in SHIFTS.items():
        plain, mat = data, data
        for _ in range(10):
            if shift is None:
                plain, mat = jntt.ntt_lf(plain), jmat.ntt_lf16(mat)
            else:
                plain, mat = jntt.coset_ntt_lf(plain, shift), jmat.coset_ntt_lf16(mat, shift)
        out[name] = (plain, mat)
    return out


@pytest.mark.parametrize("threshold", ["default", "matntt"])
def test_bench_ntt_chain_matches_jax(monkeypatch, jax_chains, threshold):
    """bench_ntt's chains at 2^12 (10 transforms, plain and coset) on the
    first 4096 values of the JAX bench's draw. At the default threshold the
    port runs its butterfly; lowered, MatNTT, which is also held against the
    JAX MatNTT (what the JAX `ntt_lf` takes at the bench's sizes on its
    accelerator) raw and by the bench's checksum. Both against the JAX
    `ntt_lf` / `coset_ntt_lf` after normalize."""
    matntt = threshold == "matntt"
    if matntt:
        monkeypatch.setattr(config, "MATNTT_MIN_N", 256)
    assert bench.NTT_VALUES == 1 << 12
    data = bench._ntt_values(np.random.default_rng(0xA1E0), "cpu")
    assert np.array_equal(data.numpy().astype(np.int64),
                          np.asarray(jax_chains["data"]).astype(np.int64))

    seen = []                   # the chains' outputs, as bench_ntt reads them back
    checksum = bench._checksum
    monkeypatch.setattr(bench, "_checksum", lambda v: seen.append(v) or checksum(v))
    detail = {}
    sums = bench.bench_ntt(detail, "cpu", logns=(12,), coset_logns=(12,))
    assert set(sums) == set(SHIFTS)
    assert {"ntt_2e12_ms", "ntt_2e12_mbfly_s", "ntt_2e12_vs_baseline",
            "coset_ntt_2e12_ms"} == set(detail)
    assert len(seen) == 4       # a first and a timed chain of each
    for name, got in zip(SHIFTS, seen[1::2]):
        plain, mat = jax_chains[name]
        assert sums[name] == checksum(got)
        assert np.array_equal(tlf.normalize(got).numpy().astype(np.int64),
                              np.asarray(jlf.normalize(plain)).astype(np.int64))
        if matntt:
            assert np.array_equal(got.numpy().astype(np.int64), np.asarray(mat).astype(np.int64))
            assert sums[name] == int(jnp.sum(mat.astype(jnp.uint32)))


# -- main ----------------------------------------------------------------------------


def _small_sections(monkeypatch):
    """The NTT section at 2^12; the MSM sections (held by the tests above)
    and the proof sections as stubs that write their keys."""
    def msm(detail, device):
        detail["msm_2e16_ms"] = 4.0
        return 2.0e6, None, None

    monkeypatch.setattr(bench, "bench_msm", msm)
    monkeypatch.setattr(bench, "bench_msm_2e24",
                        lambda detail, device: detail.update(msm_2e24_s=0.0))
    monkeypatch.setattr(bench, "bench_ntt",
                        functools.partial(bench.bench_ntt, logns=(12,), coset_logns=()))
    monkeypatch.setattr(bench, "bench_proof", lambda detail, device: ("keys", "reg", 1, 2))

    def batch(detail, keys, reg, sender, receiver):
        assert (keys, reg, sender, receiver) == ("keys", "reg", 1, 2)
        detail["batch_best_s_per_proof"] = 0.0

    monkeypatch.setattr(bench, "bench_batch_proof", batch)


def _lines(capsys):
    out, err = capsys.readouterr()
    details = [ln for ln in err.splitlines() if ln.startswith("BENCH_DETAIL ")]
    assert len(details) == 1
    return out.splitlines(), json.loads(details[0][len("BENCH_DETAIL "):]), err


def test_main_prints_the_bench_lines(monkeypatch, capsys):
    _small_sections(monkeypatch)
    assert bench.main("cpu") == 0
    out, detail, _ = _lines(capsys)
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "msm_g1_2e16_points_per_sec" and line["unit"] == "points/s"
    assert line["value"] == 2.0e6 and line["vs_baseline"] == 4.0
    for key in ("msm_2e16_ms", "msm_2e24_s", "ntt_2e12_ms", "batch_best_s_per_proof"):
        assert key in detail
    assert "msm_vpu_util_pct" not in detail


def test_main_fails_when_a_section_raises(monkeypatch, capsys):
    _small_sections(monkeypatch)

    def broken(detail, device):
        raise ValueError("planted")

    monkeypatch.setattr(bench, "bench_msm", broken)
    monkeypatch.setattr(bench, "bench_msm_2e24", lambda detail, device: None)
    monkeypatch.setattr(bench, "bench_ntt", lambda detail, device: None)
    assert bench.main("cpu") == 1
    out, detail, err = _lines(capsys)
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["metric"] == "msm_g1_2e16_points_per_sec" and line["value"] is None
    assert line["vs_baseline"] is None
    assert detail == {"batch_best_s_per_proof": 0.0}
    assert "MSM bench failed" in err and "ValueError: planted" in err
    assert "failed sections: ['MSM bench']" in err
