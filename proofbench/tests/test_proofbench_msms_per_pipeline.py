"""The commitments' per-layer metric `msms_per_pipeline.prove` read from the
tiny credits step of test_proofbench_runs.py on the CPU, and from counters
made by hand: MSMs over bucket pipelines where the program counts both,
nothing where it does not."""

import pytest

from proofbench import run
from proofbench.tests.test_proofbench_runs import CREDITS, _run, bench  # noqa: F401


def test_credits_step_reports_msms_per_pipeline(bench):
    res = _run(bench, CREDITS, trace=True)
    assert res["correct"]
    # each of the step's commitment stacks is one size group of k = 2
    assert res["metrics"]["msms_per_pipeline.prove"]["value"] == 2.0


@pytest.mark.parametrize("stages,want", [
    ({"count/kzg/msms": {"total": 176}, "count/kzg/pipelines": {"total": 22}}, 8.0),
    # one MSM a pipeline, as where a group's MSMs run one after another
    ({"count/kzg/msms": {"total": 12}, "count/kzg/pipelines": {"total": 12}}, 1.0),
    # a program without the counters: nothing to read
    ({"count/msm/adds": {"total": 5}}, None),
    (None, None),
])
def test_msms_per_pipeline_reads_the_commitment_counters(stages, want):
    got = run.metric_reader("msms_per_pipeline.prove")({"stages": stages})
    assert got == want
