"""The port's entry points (`aleo_tpu_torch.graft_entry`) on the CPU:
`entry` against the JAX package's root `entry()` under `jax.jit` (the
evaluations h after normalize, limb for limb; the MSM as an affine point),
and `dryrun_multichip` inside two and four gloo ranks, where it holds its
sharded MSM and NTT against the host oracles itself and raises on a
mismatch. How the ranks run: tests/test_torch_mesh.py.
"""

import numpy as np
import pytest

from aleo_tpu_torch import graft_entry
from aleo_tpu_torch.curves import g1
from test_torch_mesh import run_ranks


def dryrun_worker(rank, n_devices):
    graft_entry.dryrun_multichip(n_devices, device="cpu")
    return "ok"


def test_entry_matches_the_jax_entry():
    import jax

    import __graft_entry__ as jentry
    from aleo_tpu.curves import g1 as jg1

    step, args = graft_entry.entry(device="cpu")
    h, x, y, z = step(*args)
    jfn, jargs = jentry.entry()
    jh, jx, jy, jz = jax.jit(jfn)(*jargs)
    assert h.shape == (512, 16)
    assert np.array_equal(h.numpy().astype(np.int64), np.asarray(jh).astype(np.int64))
    got = g1.decode_points(g1.G1Points(x, y, z))
    want = jg1.decode_points(jg1.G1Points(jx[None], jy[None], jz[None]))
    assert got == want and got[0] is not None


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multichip_passes_its_checks(tmp_path, n_devices):
    assert run_ranks(tmp_path, n_devices, dryrun_worker, n_devices) == ["ok"] * n_devices


def test_dryrun_multichip_needs_its_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        graft_entry.dryrun_multichip(2, device="cpu")
