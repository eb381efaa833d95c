"""Key synthesis through the port's pipeline on the CPU: keys synthesised by
aleo_tpu_torch for micro.aleo/bump have the same (n, m, ell) and the same
index commitments as the JAX package's, over one SRS carried across; the
port's key cache reloads them. Tolerance 0 (group elements)."""

import pickle

import numpy as np
import pytest
import torch

from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.program.interpreter import Registry as JRegistry
from aleo_tpu.program.parser import parse_program as jparse
from aleo_tpu.snark import pipeline as jpipe
from aleo_tpu_torch.pcs.srs import srs_from_numpy
from aleo_tpu_torch.program.interpreter import Registry as TRegistry
from aleo_tpu_torch.program.parser import parse_program as tparse
from aleo_tpu_torch.program.values import Value as TValue
from aleo_tpu_torch.snark import pipeline as tpipe

torch.set_num_threads(2)        # several test workers share the machine

MICRO = """
program micro.aleo;

function bump:
    input r0 as u64.private;
    add r0 1u64 into r1;
    output r1 as u64.private;
"""


@pytest.fixture(scope="module")
def both_keys(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("srs")
    jsrs = JSrs.generate(8193, seed=b"test-torch-pipeline")
    jsrs.save(str(tmp / "srs.pkl"))
    with open(tmp / "srs.pkl", "rb") as f:
        tsrs = srs_from_numpy(pickle.load(f), device="cpu")
    jreg = JRegistry()
    jreg.add(jparse(MICRO))
    treg = TRegistry()
    treg.add(tparse(MICRO))
    jkeys = jpipe.synthesize_keys(jreg, "micro.aleo", "bump", srs=jsrs)
    tkeys = tpipe.synthesize_keys(treg, "micro.aleo", "bump", srs=tsrs)
    return jkeys, tkeys, treg


def test_port_keys_have_the_same_shape_and_commitments(both_keys):
    jkeys, tkeys, _ = both_keys
    ji, ti = jkeys.index, tkeys.index
    assert (ti.n, ti.m, ti.ell) == (ji.n, ji.m, ji.ell)
    assert ti.num_inputs == ji.num_inputs
    assert ti.index_commitments() == ji.index_commitments()
    assert tkeys.vk.index_commitments == jkeys.vk.index_commitments
    assert tkeys.constraint_counts == jkeys.constraint_counts
    assert np.array_equal(ti.var_pos, ji.var_pos)


def test_port_index_tables_equal_the_jax_tables(both_keys):
    jkeys, tkeys, _ = both_keys
    for jm, tm in zip(jkeys.index.matrices, tkeys.index.matrices):
        assert tm.name == jm.name
        for attr in ("row_poly", "col_poly", "cval_poly", "rcp_poly",
                     "row_evals", "col_evals", "cval_evals", "rcp_evals"):
            assert np.array_equal(
                getattr(tm, attr).numpy().astype(np.int64),
                np.asarray(getattr(jm, attr)).astype(np.int64),
            ), (tm.name, attr)
        for side in ("by_row", "by_col"):
            jt, tt = getattr(jm, side), getattr(tm, side)
            assert tt.out_size == jt.out_size
            for attr in ("vals", "gather_idx", "flags", "ends", "out_idx"):
                assert np.array_equal(
                    getattr(tt, attr).numpy().astype(np.int64),
                    np.asarray(getattr(jt, attr)).astype(np.int64),
                ), (tm.name, side, attr)


def test_key_blob_round_trip(both_keys, tmp_path):
    _, tkeys, _ = both_keys
    path = tmp_path / "keys.pkl"
    with open(path, "wb") as f:
        pickle.dump(tpipe.keys_to_numpy(tkeys), f)
    with open(path, "rb") as f:
        back = tpipe.keys_from_numpy(pickle.load(f), tkeys.index.srs, device="cpu")
    assert back.index.index_commitments() == tkeys.index.index_commitments()
    assert back.vk.index_commitments == tkeys.vk.index_commitments
    assert back.constraint_counts == tkeys.constraint_counts
    assert torch.equal(back.index.matrices[0].by_row.gather_idx,
                       tkeys.index.matrices[0].by_row.gather_idx)


def test_synthesis_under_the_keys_checks_the_shape(both_keys):
    _, tkeys, treg = both_keys
    syn = tpipe.synthesize_and_check(tkeys, treg, [TValue("u64", 41)], rng_nonce=lambda: 5)
    assert syn.transition.outputs[0].data == 42
    assert syn.cs.is_satisfied()
    inputs = tpipe.burner_inputs(treg.get("micro.aleo"), "bump")
    assert [v.type_ for v in inputs] == ["u64"]
