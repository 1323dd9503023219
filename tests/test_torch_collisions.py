"""The 2-D cylinder's collision operators (TRT, MRT, regularized, KBC,
Smagorinsky, power law) and the clean Zou-He corners against tpulbm.

* host arrays (the MRT basis, rates and rank-r correction, the KBC
  projectors and coefficient vectors, TRT's odd rate) equal tpulbm's bit
  for bit, and the kernels' mode coefficients carry the values tpulbm's
  Pallas configuration carries;
* each collide_* on random f64 populations against tpulbm's at rtol 1e-12;
* the plain step for each operator, and for BGK and TRT with the clean
  corners, against tpulbm's make_step_rolled in f64 on a 64x32 cylinder,
  60 steps, rtol 1e-12;
* the Runner's forces.csv and velocity_field.csv through the kernel module
  (its CPU path) against tpulbm's Runner, f32, on a 64x32 cylinder
  (forces rtol 1e-4 / atol 5e-6, fields rtol 1e-5 / atol 5e-6, the
  tolerances of tests/test_torch_runner.py);
* the CLI with --collision kbc, and checkpoints with collision settings
  moving both ways between the packages.

The kernel module against tpulbm's Pallas kernels in interpret mode is
tests/test_torch_collisions_pallas.py.
"""
import jax
import numpy as np
import pytest
import torch

from tpulbm import physics as jphys
from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9 as JD2Q9, D3Q19 as JD3Q19
from tpulbm.models import make_problem as jax_problem
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm.ops.step_pallas import _physics_cfg_fields
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import physics as tphys
from tpulbm_torch.convert import state_from_numpy, state_to_numpy
from tpulbm_torch.lattice import D2Q9, D3Q19
from tpulbm_torch.ops import step_cuda, step_torch
from tpulbm_torch.ops.step_torch import make_step_rolled
from tpulbm_torch.runner import Runner
from test_torch_compat import port_params, port_problem

F64_TOL = dict(rtol=1e-12, atol=0.0)
LATTICES = {"d2q9": (D2Q9, JD2Q9), "d3q19": (D3Q19, JD3Q19)}

# the ladder's operator cells (runs/bench_ladder_r05.jsonl) and the corner
# rule on its own: SimulationParams overrides
OPERATORS = {
    "trt": dict(collision="trt", zou_he_corners="clean"),
    "mrt": dict(collision="mrt", mrt_rates=(("e", 1.857),)),
    "regularized": dict(collision="regularized"),
    "kbc": dict(collision="kbc"),
    "les": dict(smagorinsky=0.17),
    "power_law": dict(power_law_n=0.7),
}
STEP_CASES = {**OPERATORS,
              "mrt_default": dict(collision="mrt"),
              "trt_reference_corners": dict(collision="trt"),
              "bgk_clean_corners": dict(zou_he_corners="clean")}
MODE_OF = {"trt": "trt", "mrt": "mrt", "regularized": "regularized",
           "kbc": "kbc", "les": "smagorinsky", "power_law": "power_law"}


def _params(**kw):
    d = dict(nx=64, ny=32, tau=0.55, inlet_velocity=0.05, precision="f64")
    d.update(kw)
    return SimulationParams(**d)


def _populations(lat, seed, shape=(12, 16)):
    # positive populations near a moving equilibrium, with structure
    rng = np.random.default_rng(seed)
    return (lat.w.reshape((-1,) + (1,) * len(shape))
            * rng.uniform(0.8, 1.2, (lat.Q,) + shape))


# ---- host arrays, bit for bit -------------------------------------------

MRT_OVERRIDES = [None, {"e": 1.857}, {"qx": 1.9, "qy": 1.9},
                 {"e": 1.2, "eps": 1.3, "qx": 1.4, "qy": 1.5}]


@pytest.mark.parametrize("overrides", MRT_OVERRIDES,
                         ids=["default", "e", "q", "all"])
@pytest.mark.parametrize("lat", ["d2q9", "d3q19"])
@pytest.mark.parametrize("tau", [0.5384, 0.6])
def test_mrt_host_arrays_equal_tpulbm(lat, overrides, tau):
    mine, ref = LATTICES[lat]
    got = (tphys._mrt_basis(mine)[0],
           tphys.mrt_rates(mine, 1 / tau, overrides),
           tphys.mrt_relax_matrix(mine, 1 / tau, overrides),
           *tphys.mrt_rank_correction(mine, 1 / tau, overrides))
    want = (jphys._mrt_basis(ref)[0],
            jphys.mrt_rates(ref, 1 / tau, overrides),
            jphys.mrt_relax_matrix(ref, 1 / tau, overrides),
            *jphys.mrt_rank_correction(ref, 1 / tau, overrides))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert tphys._mrt_basis(mine)[1] == jphys._mrt_basis(ref)[1]


def test_mrt_rates_refuse_unknown_moments_as_tpulbm():
    with pytest.raises(ValueError) as mine:
        tphys.mrt_rates(D2Q9, 1.8, {"bogus": 1.0})
    with pytest.raises(ValueError) as ref:
        jphys.mrt_rates(JD2Q9, 1.8, {"bogus": 1.0})
    assert str(mine.value) == str(ref.value)


def test_kbc_host_arrays_equal_tpulbm():
    for g, w in zip((*tphys.kbc_projectors(D2Q9), *tphys.kbc_coeffs(D2Q9)),
                    (*jphys.kbc_projectors(JD2Q9), *jphys.kbc_coeffs(JD2Q9))):
        assert g.tobytes() == w.tobytes()
    with pytest.raises(ValueError, match="D2Q9"):
        tphys.kbc_coeffs(D3Q19)


@pytest.mark.parametrize("tau,magic", [(0.5384, 3 / 16), (0.6, 3 / 16),
                                       (0.55, 0.25), (1.0, 1 / 12)])
def test_trt_odd_rate_equals_tpulbm(tau, magic):
    assert tphys.omega_minus_trt(1 / tau, magic) == \
        jphys.omega_minus_trt(1 / tau, magic)


def test_power_law_constants_equal_tpulbm():
    for name in ("PLAW_TAU_MIN", "PLAW_TAU_MAX", "PLAW_ITERS",
                 "PLAW_GAMMA_FLOOR"):
        assert getattr(tphys, name) == getattr(jphys, name)


@pytest.mark.parametrize("op", list(OPERATORS))
def test_mode_floats_carry_tpulbms_pallas_constants(op):
    # the kernels' coefficients (d2q9_common.cuh ModeConsts) hold the values
    # of tpulbm's Pallas configuration, before their one rounding to float
    params = _params(precision="f32", tau=0.5384, **OPERATORS[op])
    cfg = _physics_cfg_fields(jax_problem(params))
    consts = step_cuda.StepConstants.of(port_problem(params))
    assert consts.mode == MODE_OF[op]
    assert consts.clean_corners == cfg["clean_corners"]
    v = np.asarray(consts.modes)
    r = step_cuda.MRT_RANK
    trt, v = v[:2], v[2:]
    mrt_u, mrt_v, v = v[:9 * r].reshape(9, r), v[9 * r:18 * r].reshape(r, 9), \
        v[18 * r:]
    reg, kbc, smag, plaw = v[:28], v[28:86], v[86:89], v[89:]
    assert len(plaw) == 4
    inv_tau = cfg["inv_tau"]
    if op == "trt":
        assert tuple(trt) == (0.5 * inv_tau, 0.5 * cfg["omega_minus"])
    if op == "mrt":
        U, V = (np.array(a) for a in cfg["mrt_uv"])
        assert U.shape == (9, 2)
        np.testing.assert_array_equal(mrt_u[:, :2], U)
        np.testing.assert_array_equal(mrt_v[:2], V)
        assert not mrt_u[:, 2:].any() and not mrt_v[2:].any()
    if op == "regularized":
        assert reg[0] == 1.0 - inv_tau
        for i, ((cx, cy), w) in enumerate(zip(cfg["c"], cfg["w"])):
            assert reg[1 + i] == 4.5 * w * (cx * cx - 1.0 / 3.0)
            assert reg[10 + i] == 4.5 * w * (cy * cy - 1.0 / 3.0)
            assert reg[19 + i] == 9.0 * w * cx * cy
    if op == "kbc":
        np.testing.assert_array_equal(kbc[:54], np.ravel(cfg["kbc"]))
        beta = 0.5 * inv_tau
        assert tuple(kbc[54:]) == (1 / beta, 2 - 1 / beta, beta, 2 * beta)
    if op == "les":
        tau0 = 1 / inv_tau
        assert tuple(smag) == (tau0, tau0 * tau0,
                               18 * cfg["smag"] * cfg["smag"])
    if op == "power_law":
        k, n = cfg["plaw"]
        assert tuple(plaw) == (n - 1, np.log(3 * k),
                               np.log(jphys.PLAW_TAU_MIN - 0.5),
                               np.log(jphys.PLAW_TAU_MAX - 0.5))
    # the blocks of the modes the problem does not run are zero
    blocks = {"trt": trt, "mrt": np.concatenate([mrt_u.ravel(),
                                                 mrt_v.ravel()]),
              "regularized": reg, "kbc": kbc, "smagorinsky": smag,
              "power_law": plaw}
    for mode, block in blocks.items():
        assert block.any() == (mode == MODE_OF[op]), mode


# ---- the collisions on random populations, f64 --------------------------

COLLIDE_CASES = {
    "trt": lambda m, lat, f: m.collide_trt(lat, f, 1 / 0.5384),
    "trt_magic": lambda m, lat, f: m.collide_trt(lat, f, 1 / 0.55,
                                                 magic=0.25),
    "mrt": lambda m, lat, f: m.collide_mrt(lat, f, 1 / 0.5768),
    "mrt_e": lambda m, lat, f: m.collide_mrt(lat, f, 1 / 0.5384,
                                             overrides={"e": 1.857}),
    "regularized": lambda m, lat, f: m.collide_regularized(lat, f, 1 / 0.55),
    "les": lambda m, lat, f: m.collide_smagorinsky(lat, f, 1 / 0.503, 0.17),
    "power_law": lambda m, lat, f: m.collide_power_law(lat, f, 0.01, 0.7),
    "power_law_thick": lambda m, lat, f: m.collide_power_law(lat, f, 0.02,
                                                             1.3),
}


@pytest.mark.parametrize("lat", ["d2q9", "d3q19"])
@pytest.mark.parametrize("case", list(COLLIDE_CASES))
def test_collide_matches_tpulbm_f64(case, lat):
    mine, ref = LATTICES[lat]
    fn = COLLIDE_CASES[case]
    f = _populations(mine, seed=len(case))
    got = fn(tphys, mine, torch.from_numpy(f))
    want = fn(jphys, ref, jax.numpy.asarray(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_collide_kbc_matches_tpulbm_f64(seed):
    f = _populations(D2Q9, seed)
    got = tphys.collide_kbc(D2Q9, torch.from_numpy(f), 1 / 0.5384)
    want = jphys.collide_kbc(JD2Q9, jax.numpy.asarray(f), 1 / 0.5384)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


def test_power_law_solver_matches_tpulbm_f64():
    # gfac over twelve decades, through the floor and both clamps
    gfac = np.concatenate([[0.0, 1e-14], np.logspace(-10, 2, 40)])
    for k, n in ((0.01, 0.7), (0.05, 0.3), (0.001, 1.6)):
        got = tphys.power_law_inv_tau_from_gfac(torch.from_numpy(gfac), k, n)
        want = jphys.power_law_inv_tau_from_gfac(jax.numpy.asarray(gfac), k,
                                                 n)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


def test_collisions_refuse_a_body_force():
    # once refused (ROADMAP item 12): every collision now adds the body
    # force's source after relaxing, as tpulbm's do
    f = _populations(D2Q9, 3)
    force = (1e-5, -2e-6)
    for name in ("collide_kbc", "collide_regularized", "collide"):
        got = getattr(tphys, name)(D2Q9, torch.from_numpy(f), 1.8,
                                   force=force)
        want = getattr(jphys, name)(JD2Q9, jax.numpy.asarray(f), 1.8,
                                    force=force)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64_TOL)


# ---- the plain step against tpulbm's oracle step, f64 -------------------

@pytest.mark.parametrize("case", list(STEP_CASES))
def test_plain_step_matches_jax_rolled_f64(case):
    params = _params(**STEP_CASES[case])
    jstep = jax.jit(jax_step_rolled(jax_problem(params)))
    problem = port_problem(params)
    tstep = make_step_rolled(problem, "cpu")
    fj = problem.initial_state()
    ft = state_from_numpy(fj, problem, "cpu")
    for _ in range(60):
        fj = jstep(fj)
        ft = tstep(ft)
    np.testing.assert_allclose(state_to_numpy(ft), np.asarray(fj), **F64_TOL)


def test_collision_mode_follows_tpulbms_precedence():
    def mode(**kw):
        return step_torch.collision_mode(port_problem(_params(**kw)))
    assert mode() == "bgk"
    assert mode(smagorinsky=0.1) == "smagorinsky"
    assert mode(power_law_n=0.7) == "power_law"
    for name in ("trt", "mrt", "regularized", "kbc"):
        assert mode(collision=name) == name
    assert tuple(step_cuda.COLLISION_MODES) == (
        "bgk", "trt", "mrt", "regularized", "kbc", "smagorinsky",
        "power_law")


# ---- the Runner against tpulbm's -----------------------------------------

def _runner_params(tmp, **kw):
    d = dict(nx=64, ny=32, tau=0.55, inlet_velocity=0.05, num_timesteps=60,
             output_frequency=20, output_dir=str(tmp), backend="jax",
             precision="f32", enable_vtk=False)
    d.update(kw)
    return SimulationParams(**d)


def _table(path):
    return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)


@pytest.mark.parametrize("op", list(OPERATORS))
def test_runner_artifacts_match_tpulbm(tmp_path, op):
    kw = OPERATORS[op]
    ref = JaxRunner(_runner_params(tmp_path / "ref", **kw),
                    verbose=False).run()
    got = Runner(port_params(_runner_params(tmp_path / "port",
                                            backend="pallas", **kw)),
                 device="cpu", verbose=False).run()
    assert ref.success and got.success and got.final_step == 60
    fg, fr = (_table(tmp_path / d / "forces.csv") for d in ("port", "ref"))
    np.testing.assert_array_equal(fg[:, 0], [0, 20, 40])
    np.testing.assert_array_equal(fg[:, 0], fr[:, 0])
    np.testing.assert_allclose(fg[:, 1:3], fr[:, 1:3], rtol=1e-4, atol=5e-6)
    vg, vr = (_table(tmp_path / d / "velocity_field.csv")
              for d in ("port", "ref"))
    assert vg.shape == vr.shape == (64 * 32, 6)
    np.testing.assert_array_equal(vg[:, :2], vr[:, :2])
    np.testing.assert_allclose(vg, vr, rtol=1e-5, atol=5e-6)


def test_cli_runs_kbc_on_the_cpu(tmp_path, capsys):
    from tpulbm_torch.__main__ import main
    assert main(["--cpu", "--collision", "kbc", "--nx", "48", "--ny", "24",
                 "--num-timesteps", "40", "--output-frequency", "10",
                 "--no-vtk", "--output-dir", str(tmp_path)]) == 0
    forces = _table(tmp_path / "forces.csv")
    np.testing.assert_array_equal(forces[:, 0], [0, 10, 20, 30])
    assert np.isfinite(forces).all()
    field = _table(tmp_path / "velocity_field.csv")
    assert field.shape == (48 * 24, 6) and np.isfinite(field).all()


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_checkpoint_with_collision_settings_moves_between_packages(
        tmp_path, direction):
    # MRT with an overridden rate and the clean corners, plain tiers in
    # f64: the moved run agrees with the reader's straight run at round-off
    def run(which, params, **kw):
        if which == "port":
            return Runner(port_params(params), device="cpu",
                          verbose=False).run(**kw)
        return JaxRunner(params, verbose=False).run(**kw)

    writer, reader = (("port", "tpulbm") if direction == "port_to_tpulbm"
                      else ("tpulbm", "port"))
    kw = dict(precision="f64", nx=32, ny=16, num_timesteps=80,
              output_frequency=20, collision="mrt",
              mrt_rates=(("e", 1.857),), zou_he_corners="clean")
    run(reader, _runner_params(tmp_path / "straight", **kw))
    half = _runner_params(tmp_path / "moved",
                          **{**kw, "num_timesteps": 40}, checkpoint_every=1)
    run(writer, half)
    result = run(reader, half.replace(num_timesteps=80), resume=True)
    assert result.success and result.final_step == 80
    for name in ("forces.csv", "velocity_field.csv"):
        got = _table(tmp_path / "moved" / name)
        want = _table(tmp_path / "straight" / name)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                                   err_msg=name)
