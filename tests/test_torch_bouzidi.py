"""The Bouzidi curved wall (obstacle_bc="bouzidi", still and spinning)
against tpulbm, on the CPU.

* the link tables (ops/bouzidi.py) byte for byte against tpulbm's: the
  64x32 cylinder still and spinning, the 48x24x24 sphere at radius 0.23;
  the q table against the closed-form circle-line intersection
  (tests/test_bouzidi.py:37-67);
* the plain step against tpulbm's make_step_rolled in f64 at rtol 1e-12
  from a perturbed state: the cylinder under BGK and MRT and spinning,
  with the clean corners, the sphere, the hand-built channel whose walls
  sit at fractional positions;
* the kernel module (its CPU path) against tpulbm's Pallas bz kernel in
  interpret mode, one fast case (tpulbm's [single-2]);
* the momentum exchange over the cut links against tpulbm's fn, the
  staircase form at q = 1/2, zero at rest;
* the kernels' per-cell rewrite (csrc/d2q9_common.cuh, d3q19_common.cuh
  built for the host with g++) against apply_bouzidi in float32, bit for
  bit;
* the libraries, the kernel mask's link bits and the link table's checks;
* meshes: the mesh chunk (the ring wrapper's CPU path, the plain tier) on
  (2,1), (1,2), (2,2) and the overlap mode against one device from the
  perturbed state, with a shard table whose rings read -1 that must miss,
  tpulbm's dispatch for Bouzidi (depth 1 on meshes that cut x, no 1-step
  overlap), the force per shard against one device;
* the Runner's artifacts against tpulbm's Runner, checkpoints both ways,
  the CLI; tpulbm's slow gates (fractional walls, Couette) on the plain
  step, marked slow.
"""
import dataclasses
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from tpulbm.config import SimulationParams
from tpulbm.lattice import D2Q9 as JD2Q9
from tpulbm.models import make_problem as jax_problem
from tpulbm.models.base import Problem as JProblem
from tpulbm.ops import bouzidi as jbz
from tpulbm.ops import forces as jforces
from tpulbm.ops.step_jax import make_step_rolled as jax_step_rolled
from tpulbm.parallel.mesh import make_mesh as jax_mesh
from tpulbm.parallel.sharded_step import make_chunk_fn as jax_chunk_fn
from tpulbm.parallel.sharded_step import shard_state as jax_shard_state
from tpulbm.runner import Runner as JaxRunner
from tpulbm_torch import physics
from tpulbm_torch.lattice import D2Q9
from tpulbm_torch.models.base import Problem
from tpulbm_torch.ops import bouzidi, forces, step_cuda, step_torch
from tpulbm_torch.parallel import halo, sharded_step
from tpulbm_torch.parallel.mesh import make_mesh
from tpulbm_torch.runner import Runner
from tpulbm_torch.stepper import make_chunk_fn
from tpulbm_torch.utils import cuda_build
from test_torch_compat import port_params, port_problem
from test_torch_resume import _close

F64_TOL = dict(rtol=1e-12, atol=0.0)
F32_TOL = dict(rtol=5e-6, atol=1e-7)

CYL = dict(nx=64, ny=32, obstacle_bc="bouzidi")
SPHERE = dict(problem="cylinder3d", nx=48, ny=24, nz=24, tau=0.6,
              inlet_velocity=0.05, cylinder_radius=0.23,
              obstacle_bc="bouzidi")
TABLE_CASES = {"cylinder": CYL, "spinning": dict(CYL, cylinder_omega=0.02),
               "sphere": SPHERE}
STEP_CASES = {
    "cylinder_bgk": CYL,
    "cylinder_mrt": dict(CYL, collision="mrt"),
    "cylinder_spinning": dict(CYL, cylinder_omega=0.02),
    "cylinder_clean_corners_trt": dict(CYL, collision="trt",
                                       zou_he_corners="clean"),
    "sphere": SPHERE,
}


def _params(precision="f64", **kw):
    return SimulationParams(precision=precision, **kw)


def _noisy(problem, seed=5, spread=0.1):
    """The initial state times seeded noise in 1 ± spread, the solid cells
    back at rest equilibrium."""
    rng = np.random.default_rng(seed)
    f = problem.initial_state()
    f = f * rng.uniform(1 - spread, 1 + spread, f.shape)
    if problem.solid is not None:
        f[:, problem.solid] = problem.lattice.w.astype(f.dtype)[:, None]
    return f.astype(problem.initial_state().dtype)


# ---- the link tables --------------------------------------------------------

@pytest.mark.parametrize("case", TABLE_CASES)
def test_link_tables_match_tpulbm_bytewise(case):
    params = _params(**TABLE_CASES[case])
    mine, ref = port_problem(params), jax_problem(params)
    got, want = bouzidi.link_tables(mine), jbz.link_tables(ref)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.shape[0] == mine.lattice.Q * (2 if case == "spinning" else 1)
    assert got.tobytes() == want.tobytes()
    assert bouzidi.link_q(mine).tobytes() == jbz.link_q(ref).tobytes()
    assert bouzidi.active_directions(mine) == jbz.active_directions(ref)
    # memoized on the Problem, as tpulbm's
    assert bouzidi.link_tables(mine) is got


def test_link_q_matches_closed_form_circle():
    # bisection against the exact root of |p0 + t c_i - centre| = r
    params = _params(nx=128, ny=64, obstacle_bc="bouzidi")
    pr = port_problem(params)
    q = bouzidi.link_q(pr)
    lat = pr.lattice
    cx, cy = params.get_cylinder_x(), params.get_cylinder_y()
    r = float(params.get_cylinder_radius_cells())
    checked = 0
    for j in range(1, lat.Q):
        for (yy, xx) in np.argwhere(q[j] >= 0):
            ci = -lat.c[j].astype(np.float64)
            px, py = float(xx), float(yy)
            a = ci @ ci
            b = 2.0 * (ci[0] * (px - cx) + ci[1] * (py - cy))
            c0 = (px - cx) ** 2 + (py - cy) ** 2 - r * r
            t = (-b - np.sqrt(b * b - 4 * a * c0)) / (2 * a)
            got = float(q[j, yy, xx])
            if got == 0.5 and abs(t - 0.5) > 1e-6:
                continue  # the upstream-solid fallback
            assert abs(got - t) < 1e-6, (j, yy, xx, got, t)
            checked += 1
    assert checked > 30
    for j in range(1, lat.Q):
        src_solid = np.roll(pr.solid, (int(lat.c[j, 1]), int(lat.c[j, 0])),
                            (0, 1))
        np.testing.assert_array_equal(q[j] >= 0, ~pr.solid & src_solid)


def test_missing_sdf_raises_tpulbm_error():
    pr = dataclasses.replace(port_problem(_params(nx=32, ny=16,
                                                  obstacle_bc="bouzidi")),
                             obstacle_sdf=None)
    with pytest.raises(ValueError, match="obstacle_sdf"):
        bouzidi.link_q(pr)


def test_table_block_cuts_and_pads_the_table():
    pr = port_problem(_params(**dict(CYL, cylinder_omega=0.02)))
    table = bouzidi.link_tables(pr)
    block = bouzidi.table_block(pr, (10, -2), (12, 20))
    np.testing.assert_array_equal(block[:, :, 2:], table[:, 10:22, 0:18])
    assert (block[:9, :, :2] == -1.0).all()
    assert (block[9:, :, :2] == 0.0).all()
    whole = bouzidi.table_block(pr, (0, 0), pr.spatial_shape)
    assert whole.tobytes() == table.tobytes()


# ---- the plain step ---------------------------------------------------------

def _fractional_channel(qb, qt, bc, ny=24, nx=8, tau=0.8, force=2e-6,
                        moving=False, U=0.05):
    """tpulbm's hand-built channel (tests/test_bouzidi.py:70-91, 416-459):
    solid slabs whose walls sit at y = 2-qb and y = ny-3+qt; `moving`:
    the top wall translates at U. Returns (the port's Problem, tpulbm's)."""
    params = _params(nx=nx, ny=ny, tau=tau, problem="poiseuille",
                     periodic_x=True, inlet_velocity=0.0, obstacle_bc=bc,
                     body_force=(0.0, 0.0) if moving else (force, 0.0))
    solid = np.zeros((ny, nx), bool)
    solid[:2] = True
    solid[-2:] = True
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt

    def sdf(p):
        return np.minimum(p[..., 1] - y0, y1 - p[..., 1])

    def uw(p):
        mov = p[..., 1] > 0.5 * ny
        return np.stack([np.where(mov, U, 0.0),
                         np.zeros_like(p[..., 0])], axis=-1)

    kw = dict(solid=solid, obstacle_sdf=sdf, init_u=(0.0, 0.0),
              walls_y=False, periodic_x=True, obstacle_bc=bc,
              obstacle_velocity=uw if moving else None,
              body_force=() if moving else (force, 0.0))
    return (Problem(params=port_params(params), lattice=D2Q9, **kw),
            JProblem(params=params, lattice=JD2Q9, **kw))


@pytest.mark.parametrize("case", [*STEP_CASES, "fractional_channel",
                                  "couette"])
def test_plain_step_matches_jax_rolled_f64(case):
    if case in STEP_CASES:
        params = _params(**STEP_CASES[case])
        mine, ref = port_problem(params), jax_problem(params)
    else:
        mine, ref = _fractional_channel(0.25, 0.75, "bouzidi",
                                        moving=case == "couette")
    f = _noisy(ref)
    got = torch.from_numpy(f)
    want = f
    step, jstep = make_step_rolled_pair(mine, ref)
    for _ in range(3):
        got = step(got)
        want = np.asarray(jstep(want))
    np.testing.assert_allclose(got.numpy(), want, **F64_TOL)


def make_step_rolled_pair(mine, ref):
    return (step_torch.make_step_rolled(mine, "cpu"),
            jax.jit(jax_step_rolled(ref)))


def test_bouzidi_rewrite_reads_the_planes_of_before():
    # a cell cut along j and opp(j) (a one-cell gap between two solids)
    # reads, for both, the post-stream values as they stood on entry
    pr = port_problem(_params(nx=16, ny=8, obstacle_bc="bouzidi"))
    lat = pr.lattice
    rng = np.random.default_rng(2)
    planes = [torch.tensor(rng.uniform(0.1, 0.2, (8, 16))) for _ in range(9)]
    post = [torch.tensor(rng.uniform(0.1, 0.2, (8, 16))) for _ in range(9)]
    table = torch.full((9, 8, 16), -1.0, dtype=torch.float64)
    table[1, 3, 5], table[3, 3, 5] = 0.3, 0.2   # opposite links, q < 1/2
    before = [p.clone() for p in planes]
    bouzidi.apply_bouzidi(lat, planes, post, table)
    for j, i in ((1, 3), (3, 1)):
        q = float(table[j, 3, 5])
        want = 2 * q * post[i][3, 5] + (1 - 2 * q) * before[i][3, 5]
        assert float(planes[j][3, 5]) == pytest.approx(float(want), rel=1e-15)


# ---- the kernel module against tpulbm's Pallas kernel -----------------------

def test_kernel_module_matches_pallas_bz_blocked(monkeypatch):
    """tpulbm's [single-2] case (tests/test_bouzidi.py:292-315): the
    cylinder across ny/2 at ny = 64, 12 steps at N=2 (TPULBM_PALLAS_TY=4),
    tpulbm's N-step cascade in interpret mode against the port's N=2
    launches (their plain version on the CPU)."""
    monkeypatch.setenv("TPULBM_SUBSTEPS", "2")
    monkeypatch.setenv("TPULBM_PALLAS_TY", "4")
    params = _params(precision="f32", **dict(CYL, ny=64))
    ref_pr, mine = jax_problem(params), port_problem(params)
    mesh = jax_mesh((1, 1), devices=jax.devices()[:1])
    chunk = jax_chunk_fn(ref_pr, mesh, 12, backend="pallas")
    assert chunk.pallas_substeps == 2
    s, solid = jax_shard_state(mesh, ref_pr.initial_state(), ref_pr.solid)
    want = np.asarray(jax.device_get(chunk(s, solid)))
    port = make_chunk_fn(mine, "cpu", 12)
    assert port.plan == [(2, 6)]
    got = port(torch.from_numpy(mine.initial_state()))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


# ---- the force --------------------------------------------------------------

@pytest.mark.parametrize("case", ["cylinder", "spinning", "sphere"])
def test_bouzidi_force_matches_tpulbm(case):
    params = _params(**TABLE_CASES[case])
    mine, ref = port_problem(params), jax_problem(params)
    f = _noisy(ref)
    want = np.asarray(jax.jit(jforces.forces_fn(ref))(
        f, jbz.link_tables(ref)))
    got = forces.forces_fn(mine, "cpu")(torch.from_numpy(f))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_bouzidi_force_reduces_to_staircase_at_half():
    # every q = 1/2: f_j^new = f̂_i, so the cut-link sum is the voxel form
    mine, _ = _fractional_channel(0.5, 0.5, "bouzidi")
    f = torch.from_numpy(_noisy(mine))
    post = step_torch.collide_block(mine, f)
    table = torch.as_tensor(bouzidi.link_tables(mine))
    fb = forces.bouzidi_momentum_exchange(mine, post, table)
    fv = forces.momentum_exchange(mine, post, torch.from_numpy(mine.solid))
    np.testing.assert_allclose(fb.numpy(), fv.numpy(), atol=1e-14)


def test_bouzidi_force_zero_at_rest():
    pr = port_problem(_params(**CYL))
    f0 = physics.uniform_equilibrium(pr.lattice, 1.0, (0.0, 0.0),
                                     dtype=np.float64)
    f0 = np.ascontiguousarray(np.broadcast_to(
        f0[:, None, None], (9,) + pr.spatial_shape))
    got = forces.forces_fn(pr, "cpu")(torch.from_numpy(f0))
    np.testing.assert_allclose(got.numpy(), 0.0, atol=1e-15)


# ---- the kernels' per-cell rewrite on the host ------------------------------

# apply_bouzidi of csrc/d2q9_common.cuh or d3q19_common.cuh for the host
# (the CUDA qualifiers defined away, g++ without contraction, as nvcc's
# -fmad=false): per cell, its post-stream g, its post-collision values and
# its entries of the link table's planes in, the rewritten g out
_HOST_BZ = r"""
#define __device__
#define __forceinline__ inline
#define TPULBM_BOUZIDI 1
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <vector>
#include "HEADER"
#if Q3
namespace k_ = tpulbm3d;
#else
namespace k_ = tpulbm;
#endif
int main(int argc, char** argv) {
  const int n = atoi(argv[1]), planes = atoi(argv[2]);
  const int q = k_::kQ;
  std::vector<float> g(q * n), post(q * n), tab(planes * n);
  FILE* fp = fopen(argv[3], "rb");
  if (fread(g.data(), 4, q * n, fp) != (size_t)(q * n) ||
      fread(post.data(), 4, q * n, fp) != (size_t)(q * n) ||
      fread(tab.data(), 4, planes * n, fp) != (size_t)(planes * n))
    return 2;
  fclose(fp);
  for (int c = 0; c < n; ++c) {
#if Q3
    k_::apply_bouzidi(&g[c * q], &tab[c], n, planes == 2 * q,
                      [&](auto i) {
                        return post[c * q + decltype(i)::value];
                      });
#else
    k_::apply_bouzidi(&g[c * q], &tab[c], n, planes == 2 * q,
                      [&](int i, int, int) { return post[c * q + i]; });
#endif
  }
  FILE* out = fopen(argv[4], "wb");
  fwrite(g.data(), 4, q * n, out);
  fclose(out);
  return 0;
}
"""


@pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")
@pytest.mark.parametrize("q,moving", [(9, False), (9, True), (19, False),
                                      (19, True)],
                         ids=["d2q9", "d2q9_moving", "d3q19",
                              "d3q19_moving"])
def test_kernel_rewrite_matches_apply_bouzidi(tmp_path, q, moving):
    from tpulbm_torch.lattice import D3Q19
    lat = D2Q9 if q == 9 else D3Q19
    header = "d2q9_common.cuh" if q == 9 else "d3q19_common.cuh"
    src = tmp_path / "bz.cc"
    src.write_text(_HOST_BZ.replace("HEADER", header))
    exe = tmp_path / "bz"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    f"-DQ3={int(q == 19)}", "-I", str(cuda_build.SOURCE_DIR),
                    str(src), "-o", str(exe)], check=True)
    rng = np.random.default_rng(11)
    n = 400
    g = rng.uniform(0.01, 0.3, (q, n)).astype(np.float32)
    post = rng.uniform(0.01, 0.3, (q, n)).astype(np.float32)
    # every direction cut somewhere, opposite pairs and the values q = 1e-4,
    # 1/2 and 1 included; half of the entries -1 (no link)
    qs = rng.uniform(1e-4, 1.0, (q, n))
    special = rng.uniform(size=(q, n)) < 0.2
    qs[special] = rng.choice([1e-4, 0.5, 1.0], int(special.sum()))
    qs[rng.uniform(size=(q, n)) < 0.5] = -1.0
    qs[0] = -1.0
    qs = qs.astype(np.float32)
    tab = qs
    if moving:
        tab = np.concatenate([qs, rng.uniform(-1e-3, 1e-3, (q, n))
                              .astype(np.float32)])
    (tmp_path / "in.bin").write_bytes(
        np.ascontiguousarray(g.T).tobytes()
        + np.ascontiguousarray(post.T).tobytes()
        + np.ascontiguousarray(tab).tobytes())
    subprocess.run([str(exe), str(n), str(tab.shape[0]),
                    str(tmp_path / "in.bin"), str(tmp_path / "out.bin")],
                   check=True)
    got = np.frombuffer((tmp_path / "out.bin").read_bytes(),
                        np.float32).reshape(n, q).T
    planes = [torch.from_numpy(g[i].copy()) for i in range(q)]
    bouzidi.apply_bouzidi(lat, planes, [torch.from_numpy(p) for p in post],
                          torch.from_numpy(tab))
    want = torch.stack(planes).numpy()
    assert (qs[1:] >= 0).any(axis=1).all()
    np.testing.assert_array_equal(got, want)


# ---- the libraries ----------------------------------------------------------

@pytest.mark.parametrize("case,library", [
    ("cylinder", "bgk+bouzidi"), ("spinning", "bgk+bouzidi"),
    ("sphere", "bgk+bouzidi"), ("mrt", "mrt+bouzidi")])
def test_step_constants_pick_the_bouzidi_library(case, library):
    params = _params(precision="f32", **(dict(CYL, collision="mrt")
                                         if case == "mrt"
                                         else TABLE_CASES[case]))
    pr = port_problem(params)
    consts = step_cuda.kernel_constants(pr, pr.lattice.Q)
    assert consts.library == library
    assert consts.variant == step_cuda.BOUZIDI
    assert step_cuda.variant_defines(consts.variant) == (
        "-DTPULBM_BOUZIDI=1",)


def test_kernel_mask_marks_the_link_cells():
    pr = port_problem(_params(**CYL))
    mask = step_cuda.kernel_mask(pr)
    table = bouzidi.link_tables(pr)
    np.testing.assert_array_equal(mask & step_cuda.SOLID_BIT, pr.solid)
    links = (mask & step_cuda.LINK_BIT) != 0
    np.testing.assert_array_equal(links, (table[:9] >= 0).any(axis=0))
    assert links.sum() >= 8 and not (links & pr.solid).any()
    # the equilibrium obstacle's mask carries no link bit
    eq = port_problem(_params(nx=64, ny=32))
    assert step_cuda.kernel_mask(eq).max() == step_cuda.SOLID_BIT


def test_link_table_is_checked_before_a_launch():
    pr = port_problem(_params(precision="f32", **CYL))
    consts = step_cuda.kernel_constants(pr)
    f = torch.zeros((9, 32, 64))
    table = torch.as_tensor(bouzidi.link_tables(pr))
    assert step_cuda.link_args(consts, table, (32, 64), f)[1] == 9
    with pytest.raises(ValueError, match="no link table"):
        step_cuda.link_args(consts, None, (32, 64), f)
    with pytest.raises(ValueError, match="contiguous float32"):
        step_cuda.link_args(consts, table[:, :16], (32, 64), f)
    with pytest.raises(ValueError, match="contiguous float32"):
        step_cuda.link_args(consts, table.double(), (32, 64), f)
    bare = dataclasses.replace(consts, variant=0)
    with pytest.raises(ValueError, match="a link table"):
        step_cuda.link_args(bare, table, (32, 64), f)
    assert step_cuda.link_args(bare, None, (32, 64), f) == (None, 0)


def test_the_kernels_read_the_table_where_the_mask_says():
    # the sources: each kernel tests the link bit before it reads the table
    for name in ("step_d2q9.cu", "step_d2q9_blocked.cu", "step_d3q19.cu",
                 "step_d3q19_blocked.cu"):
        text = (cuda_build.SOURCE_DIR / name).read_text()
        assert "kLinkBit" in text and "links.q" in text, name
    # the N-step D3Q19 kernel keeps a cell's own class-0 populations (cz =
    # -1, pulled from the plane above) a plane longer under kBouzidi
    text = (cuda_build.SOURCE_DIR / "step_d3q19_blocked.cu").read_text()
    assert "kRingFloats == 43" in text and "kBouzidi && c == 0" in text


# ---- meshes -----------------------------------------------------------------

def _cpu_mesh(shape):
    return make_mesh(shape, devices=[torch.device("cpu")] * (shape[0]
                                                             * shape[1]))


# (mesh, switches, chunk length) -> tpulbm's (mode, depth) for Bouzidi: the
# x-tiled kernel at depth 1 only (step_pallas_tiled.py:137-142), the
# overlap mode's ranged N-step launches but never its 1-step kernel
# (sharded_step.py:326-327: a chunk no N divides takes the full-width
# 1-step kernel)
@pytest.mark.parametrize("shape,env,chunk_len,mode,depth", [
    ((2, 1), {}, 12, "rows", 4), ((2, 1), {}, 9, "rows", 3),
    ((1, 2), {}, 12, "tiled", 1), ((2, 2), {}, 12, "tiled", 1),
    ((4, 1), {"TPULBM_HALO_OVERLAP": "1"}, 14, "overlap", 2),
    ((2, 1), {"TPULBM_HALO_OVERLAP": "1"}, 7, "rows", 1),
    ((2, 2), {"TPULBM_SUBSTEPS": "2"}, 12, "tiled", 1),
    ((1, 1), {"TPULBM_FORCE_TILED": "1"}, 12, "tiled", 1)],
    ids=["rows", "rows-n3", "x-cut", "2x2", "overlap", "overlap-1step",
         "tiled-forced", "force-tiled"])
def test_mesh_plan_follows_tpulbm_for_bouzidi(monkeypatch, shape, env,
                                              chunk_len, mode, depth):
    for k in ("TPULBM_HALO_OVERLAP", "TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2",
              "TPULBM_FORCE_TILED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pr = port_problem(_params(precision="f32", **dict(CYL, nx=64, ny=64)))
    assert sharded_step.plan(pr, _cpu_mesh(shape), chunk_len) == (mode, depth)


@pytest.mark.parametrize("shape,env", [
    ((2, 1), {}), ((1, 2), {}), ((2, 2), {}),
    ((4, 1), {"TPULBM_HALO_OVERLAP": "1"}),
    ((2, 1), {"TPULBM_SUBSTEPS": "3"})],
    ids=["rows", "x-cut", "2x2", "overlap", "rows-n3"])
def test_mesh_chunk_matches_one_device(monkeypatch, shape, env):
    # the ring wrapper's CPU path on each mesh from the perturbed state,
    # the spinning cylinder across the y cut at ny/2
    for k in ("TPULBM_HALO_OVERLAP", "TPULBM_SUBSTEPS", "TPULBM_NO_FUSED2"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    pr = port_problem(_params(precision="f32",
                              **dict(CYL, ny=64, cylinder_omega=0.02)))
    f0 = torch.from_numpy(_noisy(pr))
    want = step_torch.make_step_rolled(pr, "cpu")
    ref = f0.clone()
    for _ in range(12):
        ref = want(ref)
    mesh = _cpu_mesh(shape)
    chunk = sharded_step.make_chunk_fn(pr, mesh, 12)
    got = sharded_step.gather(chunk(sharded_step.split(mesh, f0)))
    torch.testing.assert_close(got, ref, rtol=5e-6, atol=1e-7)
    diag = sharded_step.Diagnostics(pr, mesh)
    one = forces.forces_fn(pr, "cpu")(ref)
    torch.testing.assert_close(diag.force(sharded_step.split(mesh, ref)),
                               one, rtol=0.0, atol=0.0)


def test_shard_table_without_its_rings_misses():
    # a shard stepped at N=4 with its table's rings at -1 (the neighbours'
    # links dropped) misses the plain ring step by many tolerances
    pr = port_problem(_params(precision="f32", **dict(CYL, ny=64)))
    f0 = torch.from_numpy(_noisy(pr))
    mesh = _cpu_mesh((2, 1))
    blocks = sharded_step.split(mesh, f0)
    rings = halo.exchange(blocks, eq_ring=pr.ghost_ring_values(), depth=4,
                          periodic_x=False, x_rings=False)
    o = sharded_step.origin(mesh, (32, 64), 0, 0)
    local = (32, 64)
    good = _ring_step(pr, o, local, None)
    table = bouzidi.table_block(pr, (o[0] - 4, o[1] - 4), (40, 72))
    bad_table = table.copy()
    bad_table[:9, 36:] = -1.0                  # the rows above the shard
    bad = _ring_step(pr, o, local, bad_table)
    rb, rt, rl, rr = rings[0][0]
    want = good(blocks[0][0], rb, rt, rl, rr)
    miss = bad(blocks[0][0], rb, rt, rl, rr)
    sep = ((miss - want).abs() / (4 * 1e-7 + 4 * 5e-6 * want.abs())).max()
    assert float(sep) > 100


def _ring_step(pr, origin, local, table):
    from tpulbm_torch.ops import step_rings_torch
    masks = halo.pad_mask(sharded_step.shard_mask(_cpu_mesh((2, 1)),
                                                  pr.solid),
                          periodic_x=False, depth=4)
    return step_rings_torch.make_ring_step(pr, origin, local, 4,
                                           masks[0][0], "cpu", table)


def test_kernel_shards_carry_the_table_and_link_bits():
    pr = port_problem(_params(precision="f32", **dict(CYL, ny=64)))
    mesh = _cpu_mesh((2, 2))
    grid = sharded_step.kernel_shards(pr, mesh, 1, True)
    for iy, ix in mesh.shards():
        shard = grid[iy][ix]
        o = sharded_step.origin(mesh, (32, 32), iy, ix)
        table = bouzidi.table_block(pr, (o[0] - 1, o[1] - 1), (34, 34))
        assert shard.links.numpy().tobytes() == table.tobytes()
        links = (shard.mask.numpy() & step_cuda.LINK_BIT) != 0
        np.testing.assert_array_equal(links, (table[:9] >= 0).any(axis=0))


# ---- the Runner, checkpoints and the CLI ------------------------------------

def _runner_params(tmp, **kw):
    d = dict(CYL, num_timesteps=60, output_frequency=5, output_dir=str(tmp),
             backend="jax", precision="f32", enable_vtk=False, tau=0.6,
             inlet_velocity=0.05)
    d.update(kw)
    return SimulationParams(**d)


@pytest.mark.parametrize("spin", [0.0, 0.02], ids=["still", "spinning"])
def test_runner_artifacts_match_tpulbm(tmp_path, spin):
    ref = _runner_params(tmp_path / "ref", cylinder_omega=spin)
    assert JaxRunner(ref, verbose=False).run().success
    got = _runner_params(tmp_path / "port", cylinder_omega=spin,
                         backend="pallas")
    result = Runner(port_params(got), device="cpu", verbose=False).run()
    assert result.success and result.final_step == 60
    _close(tmp_path / "port", tmp_path / "ref")


@pytest.mark.parametrize("direction", ["port_to_tpulbm", "tpulbm_to_port"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    writer, reader = ((Runner, JaxRunner) if direction == "port_to_tpulbm"
                      else (JaxRunner, Runner))

    def run(cls, params, **kw):
        if cls is Runner:
            return Runner(port_params(params.replace(backend="pallas")),
                          device="cpu", verbose=False).run(**kw)
        return JaxRunner(params, verbose=False).run(**kw)

    kw = dict(output_frequency=20, cylinder_omega=0.02)
    run(reader, _runner_params(tmp_path / "straight", num_timesteps=80, **kw))
    half = _runner_params(tmp_path / "moved", num_timesteps=40,
                          checkpoint_every=1, **kw)
    run(writer, half)
    result = run(reader, half.replace(num_timesteps=80), resume=True)
    assert result.success and result.final_step == 80
    _close(tmp_path / "moved", tmp_path / "straight")


@pytest.mark.parametrize("argv", [
    ["--nx", "48", "--ny", "24", "--obstacle-bc", "bouzidi"],
    ["--nx", "48", "--ny", "24", "--obstacle-bc", "bouzidi",
     "--cylinder-omega", "0.01"],
    ["--problem", "cylinder3d", "--nx", "24", "--ny", "12", "--nz", "12",
     "--obstacle-bc", "bouzidi", "--cylinder-radius", "0.23"]],
    ids=["cylinder", "spinning", "sphere"])
def test_cli_runs_bouzidi_on_the_cpu(tmp_path, argv):
    from tpulbm_torch.__main__ import main
    assert main([*argv, "--cpu", "--num-timesteps", "20",
                 "--output-frequency", "10", "--no-vtk", "--output-dir",
                 str(tmp_path)]) == 0
    rows = np.loadtxt(tmp_path / "forces.csv", delimiter=",", skiprows=1,
                      ndmin=2)
    assert rows.shape[0] == 2 and np.isfinite(rows).all()


# ---- tpulbm's slow gates on the plain step ----------------------------------

def _steady(problem, steps):
    step = step_torch.make_step_rolled(problem, "cpu")
    f = torch.from_numpy(problem.initial_state())
    for _ in range(steps):
        f = step(f)
    _, u = physics.moments(problem.lattice, f)
    return u.numpy()


@pytest.mark.slow
@pytest.mark.parametrize("qb,qt", [(0.25, 0.75), (0.9, 0.1)])
def test_fractional_wall_position_recovered(qb, qt):
    # tests/test_bouzidi.py:112-119: the parabola's roots at the true walls
    ny, F, tau = 24, 2e-6, 0.8
    mine, _ = _fractional_channel(qb, qt, "bouzidi", ny=ny, force=F, tau=tau)
    ux = _steady(mine, 6000)[0][:, 0]
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt
    nu = (tau - 0.5) / 3.0
    yy = np.arange(ny, dtype=np.float64)
    ana = np.where((yy > y0) & (yy < y1),
                   F / (2 * nu) * (yy - y0) * (y1 - yy), 0.0)
    fl = slice(2, ny - 2)
    rel = np.sqrt(np.mean((ux[fl] - ana[fl]) ** 2)) / ana.max()
    roots = np.sort(np.roots(np.polyfit(yy[4:-4], ux[4:-4], 2)))
    assert rel < 0.01, rel
    assert abs(roots[0] - y0) < 0.05 and abs(roots[1] - y1) < 0.05, roots


@pytest.mark.slow
@pytest.mark.parametrize("qb,qt", [(0.25, 0.75), (0.9, 0.1)])
def test_moving_wall_couette_exact(qb, qt):
    # tests/test_bouzidi.py:462-470: the linear profile to 1e-6 of U
    ny, U = 20, 0.05
    mine, _ = _fractional_channel(qb, qt, "bouzidi", ny=ny, moving=True, U=U)
    ux = _steady(mine, 8000)[0][:, 0]
    y0, y1 = 2.0 - qb, (ny - 3.0) + qt
    yy = np.arange(ny, dtype=np.float64)
    fl = slice(2, ny - 2)
    err = np.max(np.abs(ux[fl] - U * (yy[fl] - y0) / (y1 - y0))) / U
    co = np.polyfit(yy[fl], ux[fl], 1)
    assert err < 1e-6, err
    assert abs(-co[1] / co[0] - y0) < 1e-3
    assert abs((U - co[1]) / co[0] - y1) < 1e-3


def test_device_table_is_copied_once_a_problem():
    pr = port_problem(_params(**CYL))
    table = bouzidi.device_table(pr, "cpu")
    assert bouzidi.device_table(pr, torch.device("cpu")) is table
    assert table.numpy().tobytes() == bouzidi.link_tables(pr).tobytes()
    # the kernel chunks of a run share it
    pr32 = port_problem(_params(precision="f32", **CYL))
    assert (step_cuda._kernel_operands(pr32, "cpu")[4]
            is step_cuda._kernel_operands(pr32, "cpu")[4]
            is bouzidi.device_table(pr32, "cpu"))
