"""The MSM pipeline's per-layer metrics (`round_occupancy_pct.*`,
`idle_in_rounds_pct.*`, `combine_host_s_per_proof`) read from the tiny steps
of test_proofbench_runs.py with `trace=True` on the CPU, and the idle reader
on traces made by hand: a value where the program marks `msm/rounds` and the
device ran, nothing where either is missing."""

import pytest

from proofbench import run
from proofbench.tests.test_proofbench_runs import CREDITS, MSM_CELLS, _run, bench  # noqa: F401
from proofbench.trace import Trace

REMOVED_COUNTERS = ("count/prove/r1_quotients_s", "count/prove/constraints",
                    "count/kzg/commit_points")


def _named(bench, cell, prefix):
    (name,) = [m["name"] for m in run.resolve(bench, cell)["per_layer"]
               if m["name"].startswith(prefix)]
    return name


@pytest.mark.parametrize("cell", MSM_CELLS)
def test_msm_steps_report_round_occupancy(bench, cell):
    res = _run(bench, cell, trace=True)
    assert res["correct"]
    assert 0 < res["metrics"][_named(bench, cell, "round_occupancy_pct.")]["value"] <= 100
    # no device operation on the CPU: nothing to read
    assert _named(bench, cell, "idle_in_rounds_pct.") not in res["metrics"]


def test_credits_step_reports_occupancy_and_host_combine(bench):
    res = _run(bench, CREDITS, trace=True)
    assert res["correct"]
    assert 0 < res["metrics"]["round_occupancy_pct.prove"]["value"] <= 100
    assert res["metrics"]["combine_host_s_per_proof"]["value"] > 0
    assert "idle_in_rounds_pct.prove" not in res["metrics"]
    assert not set(REMOVED_COUNTERS) & set(res["ctx"]["stages"])


@pytest.mark.parametrize("ops,ranges,want", [
    # a 500 ns gap that begins inside msm/rounds, over a 1000 ns step
    ([("k", 0, 100), ("k", 600, 700)], [("kzg/commit", 0, 900), ("msm/rounds", 50, 800)], 50.0),
    # the gap begins in another stage: the rounds kept the card busy
    ([("k", 0, 100), ("k", 600, 700)], [("msm/setup", 0, 300), ("msm/rounds", 300, 800)], 0.0),
    # no msm/rounds stage (a program without the span): nothing to read
    ([("k", 0, 100), ("k", 600, 700)], [("kzg/commit", 0, 900)], None),
    # no device operation: nothing to read
    ([], [("msm/rounds", 0, 900)], None),
])
def test_idle_in_rounds_reads_the_gaps_begun_in_the_rounds(ops, ranges, want):
    tr = Trace(window_s=1e-6, device_ops=ops, ranges=ranges)
    got = run.metric_reader("idle_in_rounds_pct.prove")({"trace": tr})
    assert got == pytest.approx(want) if want is not None else got is None
