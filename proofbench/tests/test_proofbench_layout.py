"""BENCHMARK.json resolves by name, and the benchmark's files import neither
JAX nor the JAX package, nor does its reference import the program."""

import ast
import json
import os

import pytest

from proofbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = run.load_bench()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _py_files(root):
    for d, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    r = run.resolve(BENCH, cell)
    assert r["config"]["name"] == r["cell"]["config"]
    assert hasattr(r["driver"], "Driver") and r["driver"].UNIT in ("proofs", "points")
    names = {m["name"] for m in r["end_to_end"]}
    assert "setup_s" in names and r["traffic"]["rate"] in names
    assert r["per_layer"], "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(run.metric_reader(metric))


def test_configs_name_their_files_and_sources():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(run.ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("proofbench/")
    assert BENCH["paths"] == ["proofbench"]


def test_no_file_imports_jax_or_the_jax_package():
    for path in _py_files(HERE):
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax", "aleo_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files(os.path.join(HERE, "reference")):
        assert "aleo_tpu_torch" not in set(_imports(path)), path


def test_a_loaded_jax_package_is_found():
    import sys
    import types

    sys.modules["aleo_tpu.fake"] = types.ModuleType("aleo_tpu.fake")
    try:
        assert "aleo_tpu.fake" in run._forbidden_modules()
    finally:
        del sys.modules["aleo_tpu.fake"]
    assert not [m for m in run._forbidden_modules() if m.startswith("aleo_tpu_torch")]
