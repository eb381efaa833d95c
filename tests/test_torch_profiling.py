"""`aleo_tpu_torch.utils.profiling`: `trace`, the twin of the JAX package's
XLA trace context (a torch.profiler trace written as Chrome JSON into the
directory given, or into ALEO_TORCH_TRACE_DIR, and nothing without one), and
the stages and counters of the MSM pipeline (`msm/setup`, `msm/rounds`,
`msm/reduce`, `msm/combine_host`; `msm/adds`, `msm/lane_rounds`) in both MSM
modes, timed with profiling on and marked in a trace's file with it off."""

import json
import random

import pytest
import torch

from aleo_tpu_torch import config, params
from aleo_tpu_torch.curves import g1
from aleo_tpu_torch.fields import fr_lf, limbs
from aleo_tpu_torch.msm import msm
from aleo_tpu_torch.pcs.srs import Srs
from aleo_tpu_torch.reference.curve import G1
from aleo_tpu_torch.snark import indexer, prover
from aleo_tpu_torch.snark.r1cs import LC, ConstraintSystem
from aleo_tpu_torch.utils import profiling

R = params.R
N, K = 256, 3
MSM_STAGES = ("msm/setup", "msm/rounds", "msm/reduce", "msm/combine_host")
REMOVED_COUNTERS = ("count/prove/r1_quotients_s", "count/prove/constraints",
                    "count/kzg/commit_points")


def _traced_work():
    a = fr_lf.encode([3, 5, 7], device="cpu")
    return fr_lf.normalize(fr_lf.mul(a, a))


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("ALEO_TORCH_TRACE_DIR", raising=False)
    with profiling.trace(str(tmp_path / "given")):
        _traced_work()
    monkeypatch.setenv("ALEO_TORCH_TRACE_DIR", str(tmp_path / "env"))
    with profiling.trace():
        _traced_work()
    for sub in ("given", "env"):
        files = list((tmp_path / sub).glob("*.pt.trace.json"))
        assert len(files) == 1, sub
        events = json.loads(files[0].read_text())["traceEvents"]
        assert any(ev.get("name", "").startswith("aten::") for ev in events)


def test_trace_does_nothing_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("ALEO_TORCH_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiling.trace():
        assert torch.equal(_traced_work(), _traced_work())
    assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def msm_case():
    """N host points (one the identity) as the gather table, and K sets of
    scalars (a zero and r - 1 among them) as raw limbs."""
    rng = random.Random(1919)
    pts, cur = [], G1.generator()
    for _ in range(N):
        pts.append(cur)
        cur = G1.add(cur, G1.double(cur))
    pts[5] = None
    scal = [[rng.randrange(R) for _ in range(N)] for _ in range(K)]
    scal[0][0], scal[1][1] = 0, R - 1
    raw = torch.stack([limbs.to_tensor(limbs.ints_to_limbs(s, params.FR_LIMBS), "cpu")
                       for s in scal])
    return msm.make_table(g1.encode_points(pts, device="cpu")), scal, raw


@pytest.fixture
def profiled():
    """Profiling on and a clean report for the test; the former state after."""
    was = profiling.enabled()
    profiling.reset()
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(was)
        profiling.reset()


def _nonzero_digits(scalars, c):
    """Non-zero signed c-bit window digits of the scalars, on host ints: a
    window above half the radix borrows one from the next."""
    count = 0
    for s in scalars:
        carry, w = 0, 0
        while s >> (c * w) or carry:
            d = ((s >> (c * w)) & ((1 << c) - 1)) + carry
            carry = int(d > 1 << (c - 1))
            count += d - (carry << c) != 0
            w += 1
    return count


def _run(path, table, raw):
    if path == "single":
        return [msm.msm_fast_host(raw[0], table)]
    return msm.msm_batch_host(raw, table)


@pytest.mark.parametrize("mode", ["1", "0"])
@pytest.mark.parametrize("path", ["single", "batch"])
def test_msm_reports_its_stages_and_counters(msm_case, path, mode, monkeypatch):
    table, scal, raw = msm_case
    monkeypatch.setattr(config, "MSM_AFFINE_MODE", mode)
    k = 1 if path == "single" else K
    c = msm.auto_c(N)
    profiling.reset()
    off = _run(path, table, raw)
    assert profiling.report() == {}                 # profiling off: nothing kept
    profiling.enable(True)
    try:
        rounds0 = msm.ROUNDS["rounds"]
        on = _run(path, table, raw)
        rounds = msm.ROUNDS["rounds"] - rounds0
        report = profiling.report()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert on == off
    for name in MSM_STAGES:
        assert report[name]["calls"] == 1, name
    lanes = k * msm._nwin(c) << (c - 1)
    if mode == "1":
        lanes += lanes // msm.OVERFLOW_FRAC         # the spare lanes
    assert report["count/msm/lane_rounds"]["total"] == lanes * rounds > 0
    assert report["count/msm/adds"]["total"] == _nonzero_digits(
        [s for row in scal[:k] for s in row], c)


def test_a_trace_file_marks_the_msm_stages(msm_case, tmp_path):
    table, _, raw = msm_case
    assert not profiling.enabled()
    with profiling.trace(str(tmp_path)):
        msm.msm_fast_host(raw[0], table)
    (path,) = tmp_path.glob("*.pt.trace.json")
    stages = [ev for ev in json.loads(path.read_text())["traceEvents"]
              if ev.get("ph") == "X" and ev.get("name") in MSM_STAGES]
    assert {ev["name"] for ev in stages} == set(MSM_STAGES)
    # host ranges of the operator kind: a user annotation would also be
    # mirrored onto the device's timeline as a span over its kernels
    assert {ev["cat"] for ev in stages} == {"cpu_op"}
    assert profiling.report() == {}


def _cubic(x):
    cs = ConstraintSystem()
    out = cs.alloc_input((pow(x, 3, R) + x + 5) % R)
    v = cs.alloc_witness(x)
    v2 = cs.mul(LC.of(v), LC.of(v))
    v3 = cs.mul(LC.of(v2), LC.of(v))
    cs.enforce_eq(LC.of(v3) + LC.of(v) + LC.constant(5), LC.of(out))
    return cs


def test_a_proof_reports_no_removed_counter(profiled):
    """A proof's report has the MSM's stages and counters, and none of the
    counters that no reader took (a constraint count, a host clock without a
    sync, the commitments' points). Each bucket pipeline has its one host
    combine, and the grouped commitments share pipelines: fewer pipelines
    than MSMs in `kzg/pipelines` / `kzg/msms`."""
    index = indexer.index_r1cs(_cubic(3), srs=Srs.generate(17, seed=b"profiling", device="cpu"))
    profiling.reset()
    prover.prove(index, _cubic(3), rng=random.Random(7))
    report = profiling.report()
    assert not set(REMOVED_COUNTERS) & set(report)
    assert set(MSM_STAGES) | {"count/msm/adds", "count/msm/lane_rounds", "kzg/commit"} <= set(report)
    assert report["msm/combine_host"]["calls"] == report["msm/setup"]["calls"]
    assert 0 < report["count/kzg/pipelines"]["total"] < report["count/kzg/msms"]["total"]
