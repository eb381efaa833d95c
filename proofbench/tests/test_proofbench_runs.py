"""Each driver runs through the harness on the CPU at a tiny size (the look
for a card skipped, `device="cpu"`, test-only), and `correct` comes out
false when the timed path is broken underneath: a step that returns its
state unchanged, half of the batch left out, an answer altered where it is
produced, and each configuration's control.

The MSM cells run over 2^8 bases (2^6 distinct); the credits cells over a
function whose circuit is a single constraint (n = m = 2), since a proof of
credits.aleo's own circuits takes minutes on the CPU.
"""

import copy
import json

import pytest
import torch

from proofbench import faults, run
from proofbench.drivers import credits_batch
from proofbench.inputs import srs as srs_inputs
from proofbench.reference import curve, marlin, transitions

CPU = torch.device("cpu")
SEED = 2**31 + 99
TINY_PROGRAM = "program credits.aleo;\n\nfunction nothing:\n    add 1field 2field into r0;\n"


@pytest.fixture
def bench(tmp_path, monkeypatch):
    monkeypatch.setattr(srs_inputs, "CACHE_DIR", str(tmp_path / "cache"))
    b = copy.deepcopy(run.load_bench())
    files = {}
    zp = json.load(open(f"{run.ROOT}/proofbench/configs/zprize_msm.json"))
    zp.update(bases=256, distinct_bases=64, srs_max_degree=64)
    files["zprize_msm"] = zp
    cr = json.load(open(f"{run.ROOT}/proofbench/configs/credits.json"))
    (tmp_path / "tiny.aleo").write_text(TINY_PROGRAM)
    cr.update(program_file=str(tmp_path / "tiny.aleo"), srs_max_degree=16,
              functions={"nothing": {"n": 2, "m": 2, "ell": 2}},
              verifying_keys=str(tmp_path / "vk.json"))
    files["credits"] = cr
    for c in b["configs"]:
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(files[c["name"]]))
        c["file"] = str(path)
    (tmp_path / "vk.json").write_text(json.dumps({"nothing": _tiny_key(16)}))
    tiny_traffic = {"driver": "credits_batch", "rate": "proofs_per_s", "function": "nothing",
                    "k": 2, "microcredits": [10, 1000], "new_records": 0}
    real_json = run._json
    monkeypatch.setattr(run, "_json", lambda rel: tiny_traffic if rel.endswith(
        "transfer_public_b8.json") else real_json(rel))
    monkeypatch.setitem(transitions.IDS, "nothing", lambda t: [])
    monkeypatch.setattr(credits_batch.Driver, "_program_inputs", lambda self, t: [])
    return b


def _tiny_key(max_degree):
    """The tiny circuit's key as the reference works it out (the stand-in for
    the JAX package's keys, which exist only for credits.aleo's circuits)."""
    from aleo_tpu_torch.program.interpreter import Registry
    from aleo_tpu_torch.program.parser import parse_program
    from aleo_tpu_torch.program.synthesizer import synthesize_execution

    reg = Registry()
    reg.add(parse_program(TINY_PROGRAM))
    cs = synthesize_execution(reg, "credits.aleo", "nothing", []).cs
    vk = marlin.index_key(cs.matrices(), cs.num_inputs, cs.num_constraints, cs.num_variables,
                          srs_inputs.trapdoor(), max_degree)
    return {"n": vk.n, "m": vk.m, "ell": vk.ell,
            "index_commitments": [curve.to_bytes(p).hex() for p in vk.index_commitments]}


def _run(bench, cell, trace=False):
    return run.run_cell(bench, cell, SEED, 0.0, trace, CPU)


MSM_CELLS = ["zprize_msm.b4_2e22", "zprize_msm.s1_2e22"]
CREDITS = "credits.transfer_public_b8"


@pytest.mark.parametrize("cell", MSM_CELLS)
def test_msm_driver_runs_a_tiny_step(bench, cell):
    res = _run(bench, cell, trace=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    part = run.resolve(bench, cell)["traffic"]["path"]
    assert res["metrics"][f"msm_rounds_per_step.{part}"]["value"] > 0


def test_credits_driver_runs_a_tiny_step(bench):
    res = _run(bench, CREDITS)
    assert res["correct"], [(c.name, c.value, c.note) for c in res["checks"]]
    assert res["attempted"] == 4 and res["failed"] == 0
    assert set(res["metrics"]) == {"proofs_per_s", "setup_s"}


def _with_fault(driver_cls, fault, monkeypatch):
    init = driver_cls.__init__

    def with_fault(self, *a, **k):
        init(self, *a, **k)
        self.fault = fault
    monkeypatch.setattr(driver_cls, "__init__", with_fault)


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "control"])
def test_msm_faults_come_out_not_correct(bench, fault, monkeypatch):
    from proofbench.drivers import msm as msm_driver

    if fault == "control":
        _with_fault(msm_driver.Driver, faults.CONTROLS["points"], monkeypatch)
        res = _run(bench, "zprize_msm.b4_2e22")
    else:
        with faults.planted(fault, "points"):
            res = _run(bench, "zprize_msm.b4_2e22")
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "control"])
def test_credits_faults_come_out_not_correct(bench, fault, monkeypatch):
    if fault == "control":
        _with_fault(credits_batch.Driver, faults.CONTROLS["proofs"], monkeypatch)
        res = _run(bench, CREDITS)
    else:
        with faults.planted(fault, "proofs"):
            res = _run(bench, CREDITS)
    assert not res["correct"]
    # the tiny circuit's transitions share one statement, so a stale step is
    # caught by its repeated proofs; the others fail verification
    failing = {c.name for c in res["checks"] if not c.holds}
    assert failing == ({"proofs_repeated"} if fault == "stale" else {"proofs_rejected"})


def test_control_script_reads_sound_and_control(bench):
    from proofbench import control

    sound = control.reading(bench, "zprize_msm.s1_2e22", SEED, "sound", 2, CPU)
    ctl = control.reading(bench, "zprize_msm.s1_2e22", SEED, "control", 2, CPU)
    assert sound["correct"] and sound["checks"]["points_wrong"]["value"] == 0
    assert not ctl["correct"] and ctl["checks"]["points_wrong"]["value"] == 3


@pytest.mark.card
def test_control_reads_on_the_card_at_the_cells_size(card):
    """The single-MSM cell's sound run and control on the card, at 2^22
    points (python -m pytest proofbench -m card, on the chip)."""
    from proofbench import control

    bench = run.load_bench()
    sound = control.reading(bench, "zprize_msm.s1_2e22", SEED, "sound", 1, card)
    ctl = control.reading(bench, "zprize_msm.s1_2e22", SEED, "control", 1, card)
    assert sound["correct"] and not ctl["correct"]
