"""The vector file tests/torch_vectors/jax_reference.json, which chip_smoke.py
holds the port's full-size results on the GPU against: that it is well formed,
that its inputs are those of its generator (scripts/torch_make_jax_vectors.py),
and, cheaply, that its outputs are the JAX package's: the stored transfer proof
round-trips through both packages' byte codecs and verifies under the JAX
package's own verifier (and the port's), a changed public input is rejected,
the same for the three credits.aleo proofs (the join, at m/n = 8, under both
verifiers), the stored MSM equals the host oracle of the tiled points,
sampled transform values and the limbs-last API's evaluations equal host
Horner evaluations, and the sampled ECDH lanes equal the host ladder. The
inputs are held against chip_smoke.py's constants too, read from its source
(it cannot be imported without CUDA).

The `slow` test reruns the generator with the JAX package and compares every
entry with the file: that is how the file is renewed and audited (a full JAX
proof on the CPU takes minutes, so it is not part of the quick tier).

Tolerance 0: proofs, points and digests are bytes."""

import ast
import dataclasses
import hashlib
import importlib
import json
import pathlib
import sys

import numpy as np
import pytest

from aleo_tpu import params
from aleo_tpu.pcs.srs import Srs as JSrs
from aleo_tpu.reference import edwards as jedwards
from aleo_tpu.reference.curve import G2 as JG2
from aleo_tpu.snark import serialize as jser
from aleo_tpu.snark import verifier as jver
from aleo_tpu_torch import bench
from aleo_tpu_torch.pcs.srs import Srs as TSrs
from aleo_tpu_torch.reference import polynomial as rpoly
from aleo_tpu_torch.reference.curve import G2 as TG2
from aleo_tpu_torch.reference.field import fr_root_of_unity
from aleo_tpu_torch.snark import serialize as tser
from aleo_tpu_torch.snark import verifier as tver

ROOT = pathlib.Path(__file__).resolve().parent.parent
VECTORS = ROOT / "tests" / "torch_vectors" / "jax_reference.json"
R = params.R
ENTRIES = ("srs", "transfer", "batch", "ntt", "msm", "poseidon", "credits", "ecdh",
           "limbs_last")
CREDITS_FNS = ("transfer_private", "join", "transfer_public")


@pytest.fixture(scope="module")
def doc():
    return json.loads(VECTORS.read_text())


@pytest.fixture(scope="module")
def gen():
    """The generator as a module, importable by name while the module's
    tests run (its spawned MSM worker imports it so)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        yield importlib.import_module("torch_make_jax_vectors")
    finally:
        sys.path.remove(str(ROOT / "scripts"))


def _srs_g2(pkg_srs, g2, entry):
    """An SRS with no G1 powers: the G2 side and the degree the verifier
    reads, from the entry's seed."""
    seed = entry["inputs"]["seed"].encode()
    tau = int.from_bytes(hashlib.sha512(seed).digest(), "little") % R
    h = g2.generator()
    return pkg_srs(None, h, g2.mul(tau, h), entry["inputs"]["max_degree"], None, seed)


@pytest.fixture(scope="module")
def chip():
    """chip_smoke.py's module-level constants: each top-level assignment
    that evaluates without its imports (literals and earlier constants)."""
    ns = {}
    for node in ast.parse((ROOT / "chip_smoke.py").read_text()).body:
        if isinstance(node, ast.Assign):
            try:
                exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), ns)
            except Exception:   # needs torch or the port: not a constant
                pass
    return ns


@pytest.fixture(scope="module")
def ecdh(gen):
    return gen.ecdh_inputs()


@pytest.fixture(scope="module")
def limbs_last(gen):
    return gen.limbs_last_inputs()


def _vk(pkg_srs, g2, deser, verifier, doc, v=None):
    e = doc["entries"]
    v = v or e["transfer"]["vk"]
    return verifier.VerifyingKey(
        n=v["n"], m=v["m"], ell=v["ell"],
        index_commitments=[deser.point_from_bytes(bytes.fromhex(c)) for c in v["index_commitments"]],
        srs=_srs_g2(pkg_srs, g2, e["srs"]))


def _public(entry):
    return [int(v) for v in entry["public_inputs"]]


# -- the file ------------------------------------------------------------------------


def test_file_names_its_generator_and_jax_version(doc):
    assert doc["generator"] == "scripts/torch_make_jax_vectors.py"
    assert doc["jax_version"] and len(doc["commit"]) == 40
    assert VECTORS.stat().st_size < 200_000
    assert list(doc["entries"]) == list(ENTRIES)


@pytest.mark.parametrize("name", ENTRIES)
def test_entry_holds_its_inputs_and_outputs(doc, gen, name):
    e = doc["entries"][name]
    assert e["seconds"] > 0
    if name == "srs":
        assert e["inputs"] == {"seed": "aleo-tpu-srs", "max_degree": gen.SRS_DEGREE}
        assert len(bytes.fromhex(e["g1_powers_sha256"])) == 32
    elif name == "transfer":
        assert e["inputs"] == gen.TRANSFER
        assert (e["vk"]["n"], e["vk"]["m"]) == (8192, 32768)
        assert len(e["vk"]["index_commitments"]) == 12
        assert hashlib.sha256(bytes.fromhex(e["proof"])).hexdigest() == e["proof_sha256"]
        assert len(e["public_inputs"]) <= e["vk"]["ell"]
    elif name == "batch":
        assert e["inputs"]["amounts"] == gen.BATCH_AMOUNTS == [100, 101, 102, 103]
        assert len(e["proofs"]) == 4 and len({p["proof"] for p in e["proofs"]}) == 4
        assert len({tuple(p["public_inputs"]) for p in e["proofs"]}) == 4
    elif name == "ntt":
        assert sorted(e) == sorted(str(1 << logn) for logn in gen.NTT_LOGNS) + ["seconds"]
        for logn in gen.NTT_LOGNS:
            t = e[str(1 << logn)]
            assert {k: v for k, v in t["inputs"].items() if k != "input_sha256"} == \
                {"logn": logn, "seed": gen.SEED + logn, "shift": params.FR_GENERATOR}
            for name_ in ("ntt", "coset_ntt"):
                assert len(t[name_]["samples"]) == gen.NTT_SAMPLES
                assert all(0 <= i < 1 << logn and int(v) < R for i, v in t[name_]["samples"])
    elif name == "msm":
        assert e["inputs"] == {"n": 1 << 16, "scalar_seed": 0xBE7C, "tile": 64}
        assert len(bytes.fromhex(e["point"])) == 48
    elif name == "credits":
        assert e["inputs"] == gen.CREDITS
        assert list(e["functions"]) == list(CREDITS_FNS)
        for fn, f in e["functions"].items():
            spec = gen.CREDITS["functions"][fn]
            assert (f["vk"]["n"], f["vk"]["m"]) == (spec["n"], spec["m"])
            assert len(f["vk"]["index_commitments"]) == 12
            assert hashlib.sha256(bytes.fromhex(f["proof"])).hexdigest() == f["proof_sha256"]
            assert len(f["public_inputs"]) <= f["vk"]["ell"]
        assert (e["functions"]["join"]["vk"]["n"], e["functions"]["join"]["vk"]["m"]) == \
            (4096, 32768)
    elif name == "ecdh":
        i = e["inputs"]
        assert (i["seed"], i["points"], i["lanes"]) == \
            (gen.RS_SEED, gen.ECDH_POINTS, gen.ECDH_LANES) == (gen.SEED + 11, 16384, 16383)
        assert 0 <= i["planted"] < i["points"]
        assert len(e["samples"]) == gen.ECDH_SAMPLES
        assert all(lane != i["planted"] for lane, _, _ in e["samples"])
    elif name == "limbs_last":
        assert {k: v for k, v in e["inputs"].items() if k != "input_sha256"} == \
            {"seed": gen.SEED + 10, "lanes": 1 << 16, "sample": 64, "m": 32768, "n": 8192,
             "mul": 16384, "vanish": 40960, "open": 4}
        for ring in ("Fq", "Fr"):
            assert sorted(e[ring]) == sorted(["mul", "add", "sub", "neg", "batch_inv", "inv"])
        assert len(e["batch_open_at"]["ys"]) == 4
        assert all(len(bytes.fromhex(pt)) == 48 for pt in
                   (e["commit"]["point"], e["open_at"]["w"], e["batch_open_at"]["w"]))
    else:
        assert {k: v for k, v in e["inputs"].items() if k != "rows_sha256"} == \
            {"seed": gen.SEED + 11, "rows": 16384, "inputs_per_row": 4, "rates": [2, 4, 8]}
        assert sorted(e["sha256"]) == sorted(e["inputs"]["rows_sha256"]) == ["2", "4", "8"]


def test_input_digests_are_the_generators_draws(doc, gen):
    """The digests of the inputs chip_smoke.py checks before it compares:
    the transforms' numpy limbs and the record scan's rows."""
    e = doc["entries"]
    for logn in gen.NTT_LOGNS:
        t = e["ntt"][str(1 << logn)]["inputs"]
        assert hashlib.sha256(gen.ntt_input(logn, t["seed"]).tobytes()).hexdigest() == \
            t["input_sha256"]
    rows = gen.poseidon_rows()
    for rate, digest in e["poseidon"]["inputs"]["rows_sha256"].items():
        assert gen.sha256(gen.int_bytes(v for row in rows[int(rate)] for v in row)) == digest


@pytest.mark.parametrize("name", ["credits", "ecdh", "limbs_last"])
def test_inputs_are_chip_smokes_constants(doc, gen, chip, name):
    """The entries of this round against chip_smoke.py's own constants."""
    e = doc["entries"][name]["inputs"]
    if name == "credits":
        assert e == chip["CREDITS"] == gen.CREDITS
    elif name == "ecdh":
        assert (e["seed"], e["points"], e["lanes"]) == \
            (chip["SEED"] + 11, chip["RS_POINTS"], chip["RS_ECDH_LANES"])
    else:
        assert {k: v for k, v in e.items() if k != "input_sha256"} == \
            {"seed": chip["SEED"] + 10, "lanes": chip["LL_LANES"], "sample": chip["SAMPLE"],
             "m": chip["LL_M"], "n": chip["LL_N"], "mul": chip["LL_MUL"],
             "vanish": chip["LL_VANISH"], "open": chip["LL_OPEN"]}


def test_scan_and_limbs_last_digests_are_the_generators_draws(doc, gen, ecdh, limbs_last):
    """The ECDH's view scalar, points and planted lane, and the limbs-last
    phase's operands, as the generator draws them."""
    view, pts, planted = ecdh
    e = doc["entries"]["ecdh"]["inputs"]
    assert planted == e["planted"] and not jedwards.is_on_curve(pts[planted])
    assert gen.ecdh_digest(view, pts) == e["input_sha256"]
    assert gen.limbs_last_input_digests(limbs_last) == \
        doc["entries"]["limbs_last"]["inputs"]["input_sha256"]


def test_ecdh_samples_are_the_host_ladder(doc, ecdh):
    view, pts, _ = ecdh
    for lane, x, y in doc["entries"]["ecdh"]["samples"]:
        assert jedwards.mul(view, pts[lane]) == (int(x), int(y))


def test_limbs_last_evaluations_are_horner(doc, gen, limbs_last):
    """eval_coeffs and the y of divide_by_linear at m coefficients, the
    openings' evaluations at n, against host Horner at z."""
    e, ins = doc["entries"]["limbs_last"], limbs_last
    z = ins["z"]
    y = rpoly.evaluate(ins["coeffs"][: gen.LL_M], z)
    assert int(e["eval_coeffs"]) == int(e["divide_by_linear"]["y"]) == y
    ys = [rpoly.evaluate(p, z) for p in ins["open"]]
    assert int(e["open_at"]["y"]) == ys[0]
    assert [int(v) for v in e["batch_open_at"]["ys"]] == ys


# -- the stored proofs -------------------------------------------------------------------


@pytest.mark.parametrize("which", ["transfer", "batch"])
def test_stored_proof_round_trips_through_both_packages(doc, which):
    """The transfer proof and the batch's first."""
    e = doc["entries"][which]
    data = bytes.fromhex(e["proof"] if which == "transfer" else e["proofs"][0]["proof"])
    v = doc["entries"]["transfer"]["vk"]
    for ser in (jser, tser):
        proof, n, m, ell = ser.proof_from_bytes(data)
        assert (n, m, ell) == (v["n"], v["m"], v["ell"])
        assert ser.proof_to_bytes(proof, n, m, ell) == data
    # the two packages read the same proof
    assert dataclasses.asdict(jser.proof_from_bytes(data)[0]) == \
        dataclasses.asdict(tser.proof_from_bytes(data)[0])


def test_stored_transfer_proof_verifies_under_the_jax_verifier(doc):
    vk = _vk(JSrs, JG2, jser, jver, doc)
    e = doc["entries"]["transfer"]
    proof = jser.proof_from_bytes(bytes.fromhex(e["proof"]))[0]
    assert jver.verify(vk, _public(e), proof, debug=True)


def test_changed_public_input_is_rejected_by_the_jax_verifier(doc):
    vk = _vk(JSrs, JG2, jser, jver, doc)
    e = doc["entries"]["transfer"]
    proof = jser.proof_from_bytes(bytes.fromhex(e["proof"]))[0]
    bad = _public(e)
    bad[2] = (bad[2] + 1) % R
    assert not jver.verify(vk, bad, proof)


def test_stored_transfer_proof_verifies_under_the_port_verifier(doc):
    vk = _vk(TSrs, TG2, tser, tver, doc)
    e = doc["entries"]["transfer"]
    proof = tser.proof_from_bytes(bytes.fromhex(e["proof"]))[0]
    assert tver.verify(vk, _public(e), proof)


def _credits(doc, fn):
    f = doc["entries"]["credits"]["functions"][fn]
    return f, bytes.fromhex(f["proof"])


@pytest.mark.parametrize("fn", CREDITS_FNS)
def test_credits_proof_round_trips_through_both_packages(doc, fn):
    f, data = _credits(doc, fn)
    v = f["vk"]
    for ser in (jser, tser):
        proof, n, m, ell = ser.proof_from_bytes(data)
        assert (n, m, ell) == (v["n"], v["m"], v["ell"])
        assert ser.proof_to_bytes(proof, n, m, ell) == data
    assert dataclasses.asdict(jser.proof_from_bytes(data)[0]) == \
        dataclasses.asdict(tser.proof_from_bytes(data)[0])


@pytest.mark.parametrize("fn", CREDITS_FNS)
def test_stored_credits_proof_verifies_under_the_jax_verifier(doc, fn):
    f, data = _credits(doc, fn)
    vk = _vk(JSrs, JG2, jser, jver, doc, f["vk"])
    assert jver.verify(vk, _public(f), jser.proof_from_bytes(data)[0], debug=True)


def test_changed_join_input_is_rejected_by_the_jax_verifier(doc):
    f, data = _credits(doc, "join")
    vk = _vk(JSrs, JG2, jser, jver, doc, f["vk"])
    bad = _public(f)
    bad[2] = (bad[2] + 1) % R
    assert not jver.verify(vk, bad, jser.proof_from_bytes(data)[0])


def test_stored_join_proof_verifies_under_the_port_verifier(doc):
    """The join (n = 4096, m = 32768) under the port's verifier, and not
    under a changed public input."""
    f, data = _credits(doc, "join")
    vk = _vk(TSrs, TG2, tser, tver, doc, f["vk"])
    proof = tser.proof_from_bytes(data)[0]
    assert tver.verify(vk, _public(f), proof)
    bad = _public(f)
    bad[2] = (bad[2] + 1) % R
    assert not tver.verify(vk, bad, proof)


# -- the bench's MSM and transforms ------------------------------------------------------


def test_msm_entry_is_the_tiled_oracle(doc, gen):
    e = doc["entries"]["msm"]
    limbs = gen.msm_scalars(e["inputs"]["n"], e["inputs"]["scalar_seed"])
    assert np.array_equal(limbs.astype(np.int64),
                          bench._rand_limbs(bench.MSM_N, 0xBE7C).astype(np.int64))
    want = bench.tiled_oracle(bench.class_sums(limbs))
    assert jser.point_from_bytes(bytes.fromhex(e["point"])) == want


@pytest.mark.parametrize("name", ["ntt", "coset_ntt"])
def test_ntt_sample_is_a_horner_evaluation(doc, gen, name):
    """The first sampled value of each 2^20 transform against host Horner
    on the input's raw limbs (the Montgomery factor applied once, after)."""
    logn = 20
    t = doc["entries"]["ntt"][str(1 << logn)]
    raw = gen.ntt_input(logn, t["inputs"]["seed"]).astype("<u2").tobytes()
    coeffs = [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]
    shift = t["inputs"]["shift"] if name == "coset_ntt" else 1
    i, v = t[name]["samples"][0]
    x = shift * pow(fr_root_of_unity(1 << logn), i, R) % R
    assert rpoly.evaluate(coeffs, x) * pow(1 << 256, -1, R) % R == int(v)


# -- renewal -------------------------------------------------------------------------------


def _without_times(obj):
    """The entry without what a rerun may change: seconds, and the MSM's
    note of how it was computed."""
    if isinstance(obj, dict):
        return {k: _without_times(v) for k, v in obj.items()
                if not k.endswith("seconds") and k != "method"}
    return obj


@pytest.mark.slow
def test_renewal_reproduces_every_entry(doc, gen, tmp_path):
    """Reruns the generator with the JAX package (about two and a half hours
    on 8 CPU cores, most of it the batch, the credits proofs, the transforms,
    the ECDH ladder, Poseidon and the MSMs; each group of entries in a
    process of its own) into a new file and compares every entry with the
    stored one."""
    out = tmp_path / "jax_reference.json"
    gen.make_each(list(doc["entries"]), out)
    again = json.loads(out.read_text())
    assert list(again["entries"]) == list(doc["entries"])
    for name, entry in doc["entries"].items():
        assert _without_times(again["entries"][name]) == _without_times(entry), name
