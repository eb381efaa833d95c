"""`aleo_tpu_torch.utils.profiling.trace`, the twin of the JAX package's
XLA trace context: a torch.profiler trace written as Chrome JSON into the
directory given, or into ALEO_TORCH_TRACE_DIR, and nothing without one."""

import json

import torch

from aleo_tpu_torch.fields import fr_lf
from aleo_tpu_torch.utils import profiling


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
