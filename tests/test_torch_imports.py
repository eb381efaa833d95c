"""The port stands apart from the JAX package: it imports neither `jax` nor
anything of `aleo_tpu`, and its entry points default to the GPU and raise
without one."""

import ast
import importlib.util
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "aleo_tpu")
# the one script beside the port that runs the JAX package: it writes the
# vector file chip_smoke.py reads (tests/torch_vectors/jax_reference.json)
BRIDGE = ROOT / "scripts" / "torch_make_jax_vectors.py"


def _port_files():
    files = sorted((ROOT / "aleo_tpu_torch").rglob("*.py"))
    scripts = sorted((ROOT / "scripts").glob("torch_*.py")) + sorted((ROOT / "tools").glob("torch_*.py"))
    return files + [p for p in scripts if p != BRIDGE] + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_file_imports_nothing_of_jax_or_the_jax_package(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {mod}"


def test_chip_smoke_source_names_neither_jax_nor_the_jax_package():
    """chip_smoke.py cannot be imported without CUDA, so its text is read:
    no import statement, import_module or __import__ names jax or aleo_tpu."""
    text = (ROOT / "chip_smoke.py").read_text()
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(?:jax|jaxlib|aleo_tpu)\b"
        r"|(?:import_module|__import__)\(\s*[\"'](?:jax|jaxlib|aleo_tpu)\b",
        re.MULTILINE)
    assert not pattern.findall(text)
    assert re.search(r"^from aleo_tpu_torch import", text, re.MULTILINE)


def _imports_the_jax_package(path):
    return any(m.split(".")[0] in FORBIDDEN for m in _imports(path))


def test_only_the_vector_generator_runs_the_jax_package():
    """The generator imports the JAX package; nothing of the port imports
    the generator, and it is the one such script beside the port."""
    assert _imports_the_jax_package(BRIDGE)
    for path in _port_files():
        assert not any("torch_make_jax_vectors" in m for m in _imports(path)), path
    beside = sorted((ROOT / "scripts").glob("torch_*.py")) + sorted((ROOT / "tools").glob("torch_*.py"))
    assert [p for p in beside if _imports_the_jax_package(p)] == [BRIDGE]


def test_importing_the_port_does_not_load_jax():
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in _port_files()
        if p.name != "__init__.py" and p.is_relative_to(ROOT / "aleo_tpu_torch")
    ]
    assert "aleo_tpu_torch.bench" in mods and "aleo_tpu_torch.graft_entry" in mods
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'aleo_tpu')]\n"
        "assert not bad, bad\n"
    )
    # -S -E: skip site customisation, which may import jax on its own
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True
    )
    if proc.returncode and "No module named" in proc.stderr and "torch" in proc.stderr:
        pytest.fail(proc.stderr)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch

    from aleo_tpu_torch import bench, graft_entry
    from aleo_tpu_torch.curves import edwards_device, g1, g1_affine, g1_fused
    from aleo_tpu_torch.fields import fr_lf
    from aleo_tpu_torch.fields.modring import FQ_RING, FR_RING
    from aleo_tpu_torch.msm import msm
    from aleo_tpu_torch.parallel import mesh
    from aleo_tpu_torch.pcs.srs import Srs
    from aleo_tpu_torch.program.interpreter import Registry
    from aleo_tpu_torch.reference import edwards
    from aleo_tpu_torch.sdk.account import PrivateKey
    from aleo_tpu_torch.sdk.api_client import HttpAPIClient, LocalAPIClient
    from aleo_tpu_torch.sdk.ledger import Ledger
    from aleo_tpu_torch.sdk.program_manager import ProgramManager
    from aleo_tpu_torch.snark import batch, indexer, pipeline
    from aleo_tpu_torch.snark.r1cs import ConstraintSystem
    from aleo_tpu_torch.snark.snarkvm_bytes import UniversalSrsBlob

    def tool(name):
        # the stand-alone scripts around fields/proto_mul.py: its wrappers
        # take tensors and create none, the scripts are what asks for a device
        spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    calls = [
        lambda: fr_lf.encode([1, 2]),
        lambda: fr_lf.one(4),
        lambda: g1_affine.identity_af(8),
        lambda: g1_fused.identity_lf(8),
        lambda: g1_fused.encode_lf([None]),
        lambda: g1.identity((2,)),
        lambda: msm.msm_host([1], [None]),
        lambda: msm.msm(torch.zeros((1, 16), dtype=torch.int32),
                        g1.encode_points([None], device="cpu"), c=4),
        lambda: Srs.generate(4),
        lambda: indexer.index_r1cs(ConstraintSystem()),
        lambda: pipeline.synthesize_keys(Registry(), "x.aleo", "f"),
        lambda: batch._const_b([1, 2]),
        lambda: tool("torch_proto_mul").main(["--log2n", "6"]),
        lambda: tool("torch_microbench_fr_mul").main(["6"]),
        lambda: FR_RING.encode([1]),
        lambda: FQ_RING.const(3),
        lambda: edwards_device.shared_secrets(5, [edwards.generator()]),
        lambda: UniversalSrsBlob(0, [None], None, None).to_srs(),
        lambda: mesh.init_distributed(),
        lambda: mesh.make_mesh(),
        lambda: graft_entry.entry(),
        lambda: bench.main(),
        lambda: bench.bench_msm({}),
        lambda: bench._tiled_points(64),
        lambda: LocalAPIClient(Ledger()),
        lambda: HttpAPIClient("http://localhost:3030"),
        lambda: ProgramManager(None, private_key=PrivateKey(seed=1)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
