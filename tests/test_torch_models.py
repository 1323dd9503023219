"""The port's Problem against tpulbm's, byte for byte, and the state
conversions between the two packages."""
import re

import numpy as np
import pytest
import torch

from tpulbm.config import PRESETS
from tpulbm.config import validate_params as jax_validate
from tpulbm.models import make_problem as jax_problem
from tpulbm.utils import checkpoint
from tpulbm_torch.config import validate_params
from tpulbm_torch.convert import (load_tpulbm_checkpoint, state_from_numpy,
                                  state_to_numpy)
from tpulbm_torch.models import make_problem
from test_torch_compat import port_params, port_problem


@pytest.mark.parametrize("preset", ["reference-default", "cylinder-small",
                                    "re100", "re200"])
@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_problem_arrays_match_tpulbm_bytewise(preset, precision):
    params = PRESETS[preset].replace(precision=precision)
    mine, ref = port_problem(params), jax_problem(params)
    for got, want in ((mine.solid, ref.solid),
                      (mine.ghost_ring_values(), ref.ghost_ring_values()),
                      (mine.initial_state(), ref.initial_state())):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


# the periodic boxes run in 2-D (tests/test_torch_periodic.py) and 3-D
# (tests/test_torch_3d_periodic.py), the 3-D boxes on a mesh too
# (tests/test_torch_mesh3d.py), the passive scalar on a mesh since its
# ring build (tests/test_torch_mesh_thermal.py): error None, the Problem
# builds; what stays refused: tpulbm's own ValueError for a 3-D shear
# layer
@pytest.mark.parametrize("problem,override,error,item", [
    ("kolmogorov", dict(nz=8, mesh_shape=(2, 1)), None, None),
    ("passive-scalar", dict(thermal_tau=0.6, mesh_shape=(2, 1)), None,
     None),
    ("taylor-green", dict(nz=8, lattice3d="d3q27", mesh_shape=(1, 2)),
     None, None),
    ("shear-layer", dict(nz=8), ValueError, "2-D only")])
def test_unported_problems_name_their_roadmap_item(problem, override, error,
                                                   item):
    params = PRESETS["cylinder-small"].replace(problem=problem, **override)
    if error is None:
        mine, ref = port_problem(params), jax_problem(params)
        assert (mine.lattice.Q, mine.lattice.D, mine.state_q) == \
            (ref.lattice.Q, ref.lattice.D, ref.state_q)
        assert mine.params.mesh_shape == override["mesh_shape"]
        return
    if error is ValueError:
        with pytest.raises(error, match=item):
            jax_problem(params)
    with pytest.raises(error, match=item):
        port_problem(params)


def test_cylinder3d_without_nz_raises_tpulbm_error():
    params = PRESETS["cylinder-small"].replace(problem="cylinder3d")
    with pytest.raises(ValueError, match="nz > 0"):
        jax_problem(params)
    with pytest.raises(ValueError, match="nz > 0"):
        port_problem(params)


_SPHERE = dict(problem="cylinder3d", nz=8)


# D3Q27 runs (tests/test_torch_d3q27.py), on a mesh too
# (tests/test_torch_mesh3d.py), the Bouzidi obstacle included (error None:
# the Problem is tpulbm's); the 2-D cylinder on a 3-D grid raises a
# ValueError naming cylinder3d, where tpulbm's step fails on the mismatched
# mask (an IndexError)
@pytest.mark.parametrize("override,error", [
    (dict(nz=16), "cylinder3d"),
    (dict(_SPHERE, lattice3d="d3q27", obstacle_bc="bouzidi"), None),
    (dict(_SPHERE, lattice3d="d3q27", obstacle_bc="bouzidi",
          mesh_shape=(2, 1)), None)])
def test_unported_options_name_their_roadmap_item(override, error):
    params = PRESETS["cylinder-small"].replace(**override)
    if error is None:
        mine, ref = port_problem(params), jax_problem(params)
        assert mine.lattice.Q == ref.lattice.Q == 27
        assert mine.obstacle_bc == ref.obstacle_bc == "bouzidi"
        assert mine.solid.tobytes() == ref.solid.tobytes()
        return
    with pytest.raises(ValueError, match=re.escape(error)):
        port_problem(params)
    from tpulbm.ops.step_jax import make_step_rolled
    ref = jax_problem(params)
    with pytest.raises(IndexError):
        make_step_rolled(ref)(ref.initial_state())


# the Bouzidi obstacle, once refused with item 14: the Problem carries
# tpulbm's fields, and its analytic surface (and the spinning cylinder's
# wall velocity) the values of tpulbm's at the same points
@pytest.mark.parametrize("override", [
    dict(obstacle_bc="bouzidi"), dict(_SPHERE, obstacle_bc="bouzidi"),
    dict(obstacle_bc="bouzidi", cylinder_omega=0.01)],
    ids=["cylinder", "sphere", "spinning"])
def test_bouzidi_problems_match_tpulbm(override):
    params = PRESETS["cylinder-small"].replace(**override)
    mine, ref = port_problem(params), jax_problem(params)
    assert mine.obstacle_bc == ref.obstacle_bc == "bouzidi"
    assert mine.solid.tobytes() == ref.solid.tobytes()
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()
    pts = np.random.default_rng(3).uniform(
        0.0, 16.0, (50, mine.lattice.D))
    assert mine.obstacle_sdf(pts).tobytes() == ref.obstacle_sdf(pts).tobytes()
    assert (mine.obstacle_velocity is None) == (ref.obstacle_velocity is None)
    if ref.obstacle_velocity is not None:
        assert (mine.obstacle_velocity(pts).tobytes()
                == ref.obstacle_velocity(pts).tobytes())


# the problems and options once refused with ROADMAP item 12: the Problem
# carries tpulbm's fields and initial state
@pytest.mark.parametrize("override", [
    dict(problem="poiseuille"), dict(problem="cavity", nx=64, ny=64),
    dict(obstacle_bc="bounce_back"), dict(body_force=(1e-5, 0.0)),
    dict(_SPHERE, obstacle_bc="bounce_back"),
    dict(_SPHERE, body_force=(1e-5, 0.0, 0.0))],
    ids=["poiseuille", "cavity", "bounce_back", "body_force",
         "sphere_bounce_back", "sphere_body_force"])
def test_item12_problems_match_tpulbm(override):
    params = PRESETS["cylinder-small"].replace(**override)
    mine, ref = port_problem(params), jax_problem(params)
    for name in ("obstacle_bc", "body_force", "walls_x", "walls_y",
                 "walls_z", "lid_u", "closed_box", "periodic_x",
                 "inlet_zou_he", "outlet_zou_he", "inlet_equilibrium",
                 "outlet_zero_grad", "init_u", "collision"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert (mine.solid is None) == (ref.solid is None)
    if ref.solid is not None:
        assert mine.solid.tobytes() == ref.solid.tobytes()
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()


# the sphere's operators, once refused: the Problem carries tpulbm's fields
@pytest.mark.parametrize("override", [
    dict(collision="trt"), dict(collision="regularized"),
    dict(smagorinsky=0.1), dict(collision="mrt"), dict(power_law_n=0.7)])
def test_sphere_operator_fields_match_tpulbm(override):
    params = PRESETS["cylinder-small"].replace(**_SPHERE, **override)
    mine, ref = port_problem(params), jax_problem(params)
    for name in ("collision", "trt_magic", "mrt_rates", "smagorinsky",
                 "power_law"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()


# the 2-D cylinder's operators and corner rule, once refused: the Problem
# carries tpulbm's fields
@pytest.mark.parametrize("override", [
    dict(collision="trt"), dict(smagorinsky=0.1), dict(power_law_n=0.7),
    dict(zou_he_corners="clean")])
def test_cylinder_operator_fields_match_tpulbm(override):
    params = PRESETS["cylinder-small"].replace(**override)
    mine, ref = port_problem(params), jax_problem(params)
    for name in ("collision", "clean_corners", "trt_magic", "mrt_rates",
                 "smagorinsky", "power_law"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.initial_state().tobytes() == ref.initial_state().tobytes()


@pytest.mark.parametrize("override", [
    dict(collision="trt"), dict(smagorinsky=0.17), dict(power_law_n=0.7)])
def test_multiphase_operators_raise_tpulbm_error(override):
    params = PRESETS["cylinder-small"].replace(
        problem="multiphase", shan_chen_g=-5.0, tau=1.0, **override)
    with pytest.raises(ValueError, match="BGK-only"):
        port_problem(params)


# the collision combinations tpulbm refuses: the port's validate_params and
# its problem builders share one check and give tpulbm's own message
_RB = dict(problem="rayleigh-benard", thermal_tau=0.5704, rayleigh=1e4,
           inlet_velocity=0.0, cylinder_radius=0.0)


@pytest.mark.parametrize("override", [
    dict(_SPHERE, collision="kbc"), dict(_RB, collision="trt"),
    dict(_RB, power_law_n=0.7), dict(collision="trt", smagorinsky=0.1),
    dict(collision="mrt", power_law_n=0.7),
    dict(smagorinsky=0.1, power_law_n=0.7),
    dict(problem="multiphase", shan_chen_g=-5.0, tau=1.0, collision="trt")],
    ids=["kbc_3d", "thermal_trt", "thermal_power_law", "les_trt",
         "power_law_mrt", "les_and_power_law", "multiphase_trt"])
def test_refused_collisions_give_tpulbms_message(override):
    params = PRESETS["cylinder-small"].replace(**override)
    with pytest.raises(ValueError) as want:
        jax_validate(params)
    for check in (validate_params, make_problem):
        with pytest.raises(ValueError) as got:
            check(port_params(params))
        assert str(got.value) == str(want.value), check.__name__


def test_state_round_trip_and_checks():
    params = PRESETS["cylinder-small"]
    problem = port_problem(params)
    f = problem.initial_state()
    t = state_from_numpy(f, problem, "cpu")
    assert t.dtype == torch.float32 and t.is_contiguous()
    back = state_to_numpy(t)
    assert back.tobytes() == f.tobytes()
    with pytest.raises(TypeError):
        state_from_numpy(f.astype(np.float64), problem, "cpu")
    with pytest.raises(ValueError):
        state_from_numpy(f[:, :, :-1], problem, "cpu")
    with pytest.raises(ValueError):
        state_to_numpy(t[:5])
    with pytest.raises(TypeError):
        state_to_numpy(t.to(torch.float16))


def test_load_tpulbm_checkpoint(tmp_path):
    params = PRESETS["cylinder-small"]
    rng = np.random.default_rng(7)
    f = (jax_problem(params).initial_state()
         * rng.uniform(0.9, 1.1, size=(9, params.ny, params.nx))
         ).astype(np.float32)
    path = checkpoint.save(str(tmp_path), 420, f, params)
    step, t = load_tpulbm_checkpoint(path, port_params(params), "cpu")
    assert step == 420
    assert state_to_numpy(t).tobytes() == f.tobytes()
    with pytest.raises(ValueError, match="tau"):
        load_tpulbm_checkpoint(path, port_params(params.replace(tau=0.7)),
                               "cpu")
