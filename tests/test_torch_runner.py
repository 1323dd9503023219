"""The slice as a whole: the port's Runner on the CPU against tpulbm's
Runner (backend="jax") on the same tiny cylinder (tests/test_runner_io.py's
tiny_params: 64x32, 60 steps, output every 20, no VTK).

Tolerances: forces rtol 1e-4 / atol 5e-6 (tpulbm's own jax-vs-pallas
runner gate; the raw forces are sums over the obstacle's links, summed in
another order by each framework). Final fields and the run record rtol
1e-5 / atol 5e-6: after 60 f32 steps tpulbm's own pallas and jax tiers
differ by up to 1.7e-6 in u on this case (velocities near zero make rtol
alone meaningless), and the port is as close to each tier as they are to
each other (1.9e-6 from the jax tier, 1.1e-6 from the pallas tier).
"""
import numpy as np
import pytest

from tpulbm.config import SimulationParams
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch.runner import Runner
from test_torch_compat import port_params


def tiny_params(tmp, **kw):
    defaults = dict(nx=64, ny=32, tau=0.6, inlet_velocity=0.05,
                    num_timesteps=60, output_frequency=20,
                    output_dir=str(tmp), backend="jax", precision="f32",
                    enable_vtk=False)
    defaults.update(kw)
    return SimulationParams(**defaults)


def _csv(path):
    lines = open(path).read().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


@pytest.mark.parametrize("backend", ["pallas", "jax"])
def test_runner_artifacts_match_tpulbm(tmp_path, backend):
    ref = JaxRunner(tiny_params(tmp_path / "ref"), verbose=False).run()
    got = Runner(port_params(tiny_params(tmp_path / "port", backend=backend)),
                 device="cpu", verbose=False).run()
    assert ref.success and got.success
    assert got.final_step == ref.final_step == 60

    h_ref, rows_ref = _csv(tmp_path / "ref" / "forces.csv")
    h_got, rows_got = _csv(tmp_path / "port" / "forces.csv")
    assert h_got == h_ref
    assert [r[0] for r in rows_got] == [r[0] for r in rows_ref] == \
        ["0", "20", "40"]
    np.testing.assert_allclose([[float(v) for v in r[1:3]] for r in rows_got],
                               [[float(v) for v in r[1:3]] for r in rows_ref],
                               rtol=1e-4, atol=5e-6)

    for name in ("velocity_field.csv", "simulation_params.csv"):
        h_ref, rows_ref = _csv(tmp_path / "ref" / name)
        h_got, rows_got = _csv(tmp_path / "port" / name)
        assert h_got == h_ref
        assert len(rows_got) == len(rows_ref)
        # same keys / cell coordinates in the same order
        assert [r[:2] if name.startswith("velocity") else r[0]
                for r in rows_got] == \
               [r[:2] if name.startswith("velocity") else r[0]
                for r in rows_ref]
        np.testing.assert_allclose(
            np.array([[float(v) for v in r[1:]] for r in rows_got]),
            np.array([[float(v) for v in r[1:]] for r in rows_ref]),
            rtol=1e-5, atol=5e-6, err_msg=name)


def test_runner_aborts_on_instability(tmp_path):
    # tau barely above 0.5 with a large impulsive velocity blows up; the run
    # must report failure and write no final CSVs
    params = tiny_params(tmp_path, tau=0.501, inlet_velocity=0.3,
                         num_timesteps=2000, output_frequency=100,
                         backend="pallas")
    result = Runner(port_params(params), device="cpu", verbose=False).run()
    assert not result.success
    assert result.final_step < 2000
    assert not (tmp_path / "velocity_field.csv").exists()
    assert not (tmp_path / "simulation_params.csv").exists()
