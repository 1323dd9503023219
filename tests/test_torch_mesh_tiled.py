"""The x-tiled kernel (tpulbm/ops/step_pallas_tiled.py::
make_local_step_tiled, row 5) at each blocking depth: the kernel module on
a mesh against tpulbm's Pallas kernel in interpret mode, as
tests/test_torch_mesh_pallas.py compares them (f32, two chunks from a
seeded ±10% perturbed state, rtol 2e-5 / atol 1e-7, the cylinder across
the shard edges): N = 1, 2, 3 on (1, 2) and N = 4 on (2, 2), where the
extended ring rows carry the diagonal neighbours' corners.
"""
import pytest

from test_torch_mesh_pallas import compare_tiled


@pytest.mark.parametrize("mesh_shape,n_sub", [
    ((1, 2), 1), ((1, 2), 2), ((1, 2), 3), ((2, 2), 4)],
    ids=["1x2-n1", "1x2-n2", "1x2-n3", "2x2-n4"])
def test_tiled_depths_match_pallas(monkeypatch, mesh_shape, n_sub):
    compare_tiled(monkeypatch, mesh_shape, n_sub, {})
