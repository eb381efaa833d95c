"""The port's `parallel.mesh` over four gloo ranks as (dp, field) = (1, 4),
against the JAX package's functions on four virtual CPU devices and the host
oracles, tolerance 0. At four shards a transposed block order of the
all-to-all would no longer pass, where at two it still could.

How the ranks run, and why the sharded MSM is held against the JAX
package's host oracle rather than its `sharded_msm`: tests/test_torch_mesh.py,
whose helpers this file uses.
"""

import pytest

from test_torch_mesh import check_mesh_results, jax_sharded_ntt, mesh_worker, run_ranks


@pytest.fixture(scope="module")
def jax_ntt_four():
    return jax_sharded_ntt(4)


def test_sharded_ntt_and_msm_match_jax_and_host_1x4(tmp_path, jax_ntt_four):
    check_mesh_results(run_ranks(tmp_path, 4, mesh_worker, 1), 1, jax_ntt_four)
