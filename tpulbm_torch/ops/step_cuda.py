"""The fused collide-stream steps as hand-written CUDA kernels.

Ports of tpulbm/ops/step_pallas.py (D2Q9):
* make_local_step_pallas (one step per launch): csrc/step_d2q9.cu;
* make_local_step_pallasN (N = 3, 4) and make_local_step_pallas2 (N = 2),
  temporal blocking, N steps per launch: csrc/step_d2q9_blocked.cu; the
  depths 5-8 that only TPULBM_SUBSTEPS asks for in its deep build (DEEP).
Both sources run one design, the row march of csrc/d2q9_march.cuh (at
N = 1 in the first). Both hold every collision of tpulbm's D2Q9 kernels
(COLLISION_MODES), the clean Zou-He corners, the body-force source, the
force profile (tpulbm's
force_fn along one axis: a table of its source per coordinate), the
bounce-back and the Bouzidi obstacles and four domains (DOMAINS: the
cylinder, the periodic channel, the lid-driven cavity, the periodic box),
the channel also without its y walls, its walls solid slabs of the mask
(SLAB);
the mode's coefficients are computed here on the host, as tpulbm's
_physics_cfg_fields computes them.
Port of tpulbm/ops/step_pallas3d.py (D3Q19 and D3Q27):
* make_local_step_pallas3d and make_local_step_pallas3d_tiled at n_sub=1
  (one step per launch): csrc/step_d3q19.cu;
* make_local_step_pallas3d_tiled at n_sub 2 and 3 (temporal blocking, N
  steps per launch): csrc/step_d3q19_blocked.cu; n_sub 4-8 in its deep
  build (DEEP), D3Q27 at 8 with its rings in a scratch buffer.
Both hold every collision of tpulbm's 3-D kernels (COLLISION_MODES_3D: all
but KBC, which tpulbm runs in 2-D only; MRT on D3Q19 only, as tpulbm's
basis), the source, the force profile along z (3-D Kolmogorov), the
bounce-back obstacle, the Bouzidi obstacle and three domains
(DOMAINS_3D: the sphere in a duct, the periodic duct, the fully periodic
box), on either velocity set (D3Q27: -DTPULBM_Q=27); the mode's
coefficients are computed here as tpulbm's 3-D builders compute them.
A library is built for one collision, domain, source, force profile,
obstacle rule and 3-D velocity set (build_defines; the cylinder's BGK
library with the
equilibrium obstacle and no force takes no define and is the one every
earlier build ran), at its first use. The Bouzidi build (BOUZIDI,
tpulbm's `bz` mode) takes the link table (ops/bouzidi.link_tables, 9 or
18 planes in 2-D, 19 or 38 on D3Q19, 27 or 54 on D3Q27; a moving wall's
scalars in the second half) as an operand and reads it only at the cells
whose mask byte carries LINK_BIT (kernel_mask): the cut-link rewrite is
cell-local, every term of it sits at the boundary cell.
Both D2Q9 sources also build with rings (-DTPULBM_RINGS=1), for one shard
of a mesh (parallel/sharded_step.py): collide_stream_rings steps a shard's
block from the rings its neighbours sent, over a range of its rows. That
build of step_d2q9.cu serves make_local_step_pallas with its ring inputs,
make_local_step_pallas_ranged and make_local_step_tiled at depth 1; that
of step_d2q9_blocked.cu make_local_step_pallasN (ranged too) and
make_local_step_pallas2 with their ring inputs and make_local_step_tiled
at depths 2-4. Its plain version is ops/step_rings_torch.py.
Both D3Q19 sources build with rings too (-DTPULBM_RINGS=1): through
collide_stream_rings_3d they step one shard of a 3-D mesh, the whole
block (z is never cut), from its ring rows and, on a mesh that cuts x,
its ring columns: make_local_step_pallas3d_tiled with its ring inputs and
x_halo, at n_sub 1 (step_d3q19.cu) and 2, 3 (step_d3q19_blocked.cu), with
the same plain version.
The thermal and multiphase kernels' wrappers are ops/step_thermal_cuda.py
and ops/step_multiphase_cuda.py, on the same build and binding helpers.
Each kernel is built with nvcc at first use and called through ctypes on
PyTorch's current stream. Their plain version is
ops/step_torch.py::make_step_rolled, once per step.

Dispatch follows the tensor: for a CPU tensor the wrapper runs the plain
version; for a CUDA tensor it launches the kernel or raises. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import numpy as np
import torch

from .. import physics
from ..models.base import Problem
from ..utils import cuda_build
from . import step_torch

KERNEL_SOURCE = "tpulbm_torch/csrc/step_d2q9.cu"
REPLACES = "tpulbm/ops/step_pallas.py:1093"   # make_local_step_pallas
BLOCKED_SOURCE = "tpulbm_torch/csrc/step_d2q9_blocked.cu"
# the N-step kernels' depths: the default libraries', and the deep build's
# (DEEP), which only TPULBM_SUBSTEPS asks for; MAX_DEPTH is the port's cap
# in 2-D (tpulbm's TPU build takes deeper ones while VMEM holds them) and
# tpulbm's halo height H in 3-D, above which its dispatch plans no depth
BLOCKED_DEPTHS = (2, 3, 4)
DEEP_DEPTHS = (5, 6, 7, 8)
MAX_DEPTH = 8
# the deepest x-tiled depth: tpulbm's make_local_step_tiled asserts
# 1 <= n_sub <= 4
TILED_MAX_DEPTH = 4
TILED_ASSERT = "tpulbm/ops/step_pallas_tiled.py:133"
# depth -> the Pallas function it replaces
BLOCKED_REPLACES = {
    2: "tpulbm/ops/step_pallas.py:1442",      # make_local_step_pallas2
    **{n: "tpulbm/ops/step_pallas.py:1679"    # make_local_step_pallasN
       for n in BLOCKED_DEPTHS[1:] + DEEP_DEPTHS}}
SOURCE_3D = "tpulbm_torch/csrc/step_d3q19.cu"
REPLACES_3D = ("tpulbm/ops/step_pallas3d.py:370 (make_local_step_pallas3d), "
               "tpulbm/ops/step_pallas3d.py:745 at n_sub=1 "
               "(make_local_step_pallas3d_tiled)")
SOURCE_3D_BLOCKED = "tpulbm_torch/csrc/step_d3q19_blocked.cu"
REPLACES_3D_BLOCKED = "tpulbm/ops/step_pallas3d.py:745 at n_sub 2, 3"
REPLACES_3D_DEEP = "tpulbm/ops/step_pallas3d.py:745 at n_sub 4-8"
BLOCKED_DEPTHS_3D = (2, 3)
DEEP_DEPTHS_3D = (4, 5, 6, 7, 8)
# the Pallas functions the ring builds replace, by the chunk's mode
# (parallel/sharded_step.plan) and depth
_RINGS_REPLACES = {
    ("rows", 1): "tpulbm/ops/step_pallas.py:1093",    # make_local_step_pallas
    ("rows", 2): "tpulbm/ops/step_pallas.py:1442",    # make_local_step_pallas2
    ("rows", 3): "tpulbm/ops/step_pallas.py:1679",    # make_local_step_pallasN
    ("rows", 4): "tpulbm/ops/step_pallas.py:1679",
    ("overlap", 1): "tpulbm/ops/step_pallas.py:1254",  # ..._pallas_ranged
    ("overlap", 2): "tpulbm/ops/step_pallas.py:1679",  # pallasN ranged=True
    ("overlap", 3): "tpulbm/ops/step_pallas.py:1679",
    ("overlap", 4): "tpulbm/ops/step_pallas.py:1679",
    **{(mode, n): "tpulbm/ops/step_pallas.py:1679"
       for mode in ("rows", "overlap") for n in DEEP_DEPTHS}}


def rings_replaces(mode: str, depth: int) -> str:
    """file:line of the Pallas function a ring launch in `mode` ("rows",
    "overlap", "tiled") at `depth` replaces."""
    if mode == "tiled":
        return "tpulbm/ops/step_pallas_tiled.py:103"  # make_local_step_tiled
    return _RINGS_REPLACES[mode, depth]


RINGS_DEPTHS = (1,) + BLOCKED_DEPTHS
RINGS_DEPTHS_3D = (1,) + BLOCKED_DEPTHS_3D
# the Pallas function the 3-D ring builds replace, at every depth
REPLACES_3D_RINGS = ("tpulbm/ops/step_pallas3d.py:745 "
                     "(make_local_step_pallas3d_tiled, ring inputs, x_halo)")
# populations per cell -> the state's rank and layout, per kernel lattice
_STATE_LAYOUT = {9: (3, "(9, ny, nx)"), 14: (3, "(14, ny, nx)"),
                 19: (4, "(19, nz, ny, nx)"), 27: (4, "(27, nz, ny, nx)")}
# the collisions of the D2Q9 kernels, in the order of d2q9_common.cuh's
# tpulbm::Collision; step_torch.collision_mode names a problem's
COLLISION_MODES = ("bgk", "trt", "mrt", "regularized", "kbc", "smagorinsky",
                   "power_law")
MRT_RANK = 4               # d2q9_common.cuh kMrtRank: U, V zero-padded
_Q = 9
# floats of d2q9_common.cuh's ModeConsts: TRT, MRT's U and V, regularized,
# KBC, Smagorinsky, power law
MODE_FLOATS = 2 + 2 * _Q * MRT_RANK + (1 + 3 * _Q) + (6 * _Q + 4) + 3 + 4
# the collisions of the D3Q19 kernels (tpulbm has no 3-D KBC)
COLLISION_MODES_3D = tuple(m for m in COLLISION_MODES if m != "kbc")
# the kernels' domains (collision_modes.cuh's tpulbm::Domain, its index):
# 2-D the cylinder (Zou-He inlet and outlet, y walls, a voxel obstacle),
# the Poiseuille channel (periodic x, y walls), the lid-driven cavity and
# the periodic box (periodic x and y: Taylor-Green, the shear layer,
# Kolmogorov); 3-D the sphere in a duct (equilibrium inlet, zero-gradient
# outlet, y and z walls, a voxel obstacle), the Poiseuille duct (periodic
# x) and the periodic box (periodic x, y and z: the 3-D Taylor-Green vortex
# and Kolmogorov flow); index 2, the cavity, is 2-D only
DOMAINS = ("cylinder", "channel", "cavity", "box")
DOMAINS_3D = ("sphere", "duct", None, "box")
# the bits of a library's variant (collision_modes.cuh's
# tpulbm_build_variant): the domain's index in DOMAINS or DOMAINS_3D, the
# body-force source, the bounce-back obstacle, the force profile and the
# 3-D velocity set; 0 is the cylinder's (or the D3Q19 sphere's) library
# with the equilibrium obstacle and no force
DOMAIN_BITS = 3
SOURCE = 4
BOUNCE_BACK = 8
RINGS = 16      # a D2Q9 library built for one shard of a mesh
FORCE = 32      # the force profile's table (along x or y in 2-D, z in 3-D)
BOUZIDI = 64    # the Bouzidi obstacle: the link table (ops/bouzidi.py)
D3Q27 = 128     # a 3-D library of the D3Q27 velocity set (else D3Q19)
SLAB = 256      # the channel without y walls, its walls solid slabs of the
                # mask under the obstacle rule (2-D)
DEEP = 512      # an N-step library of the deep depths (DEEP_DEPTHS,
                # DEEP_DEPTHS_3D) instead of the default ones
# the bits of a cell's byte in the uint8 mask the kernels read
# (collision_modes.cuh's kSolidBit, kLinkBit): solid, and under the
# Bouzidi obstacle at least one cut link
SOLID_BIT = 1
LINK_BIT = 4
MRT_RANK_3D = 10           # d3q19_common.cuh kMrtRank: the ten ghost moments


def mode_floats_3d(q: int) -> int:
    """The floats of d3q19_common.cuh's ModeConsts for a q-population set:
    TRT, MRT's U and V (zeros on D3Q27), regularized (1 - 1/tau and the six
    Pi_ab weights a population), Smagorinsky, power law."""
    return 2 + 2 * q * MRT_RANK_3D + (1 + 6 * q) + 3 + 4


MODE_FLOATS_3D = mode_floats_3d(19)


def mode_floats(problem: Problem) -> tuple[float, ...]:
    """The kernels' mode coefficients for `problem`, in the order of the
    ModeConsts of d2q9_common.cuh (D2Q9) or d3q19_common.cuh (D3Q19), each
    computed in double precision as tpulbm's builders compute it (2-D:
    _physics_cfg_fields and the Pallas branches, step_pallas.py:183-396,
    919-934; 3-D: step_pallas3d.py:160-321, 408-434, 912-964); the kernel
    rounds them to float. Every mode's block is there (KBC's in 2-D only,
    as tpulbm's); the ones the problem does not run are zero."""
    lat = problem.lattice
    q, d = lat.Q, lat.D
    rank = MRT_RANK if d == 2 else MRT_RANK_3D
    inv_tau = 1.0 / problem.params.tau
    mode = step_torch.collision_mode(problem)
    # the Pi_ab of the regularized projection: the diagonal, then a < b
    pairs = [(a, a) for a in range(d)] + list(
        itertools.combinations(range(d), 2))
    z = np.zeros
    trt, mrt_u, mrt_v = z(2), z((q, rank)), z((rank, q))
    reg, kbc, smag, plaw = z(1 + len(pairs) * q), z(6 * q + 4), z(3), z(4)
    if mode == "trt":
        trt[:] = (0.5 * inv_tau,
                  0.5 * physics.omega_minus_trt(inv_tau, problem.trt_magic))
    elif mode == "mrt":
        U, V = physics.mrt_rank_correction(
            lat, inv_tau, overrides=dict(problem.mrt_rates) or None)
        r = V.shape[0]
        if r > rank:
            raise ValueError(f"MRT rank {r} exceeds the kernels' {rank}")
        mrt_u[:, :r], mrt_v[:r] = U, V
    elif mode == "regularized":
        c, w = lat.c, lat.w
        reg[0] = 1.0 - inv_tau
        reg[1:] = np.concatenate([
            [4.5 * w[i] * (c[i, a] * c[i, a] - 1.0 / 3.0) if a == b
             else 9.0 * w[i] * c[i, a] * c[i, b] for i in range(q)]
            for a, b in pairs])
    elif mode == "kbc":
        beta = 0.5 * inv_tau     # kbc_coeffs raises off D2Q9, as tpulbm's
        kbc[:] = np.concatenate([*physics.kbc_coeffs(lat),
                                 [1.0 / beta, 2.0 - 1.0 / beta, beta,
                                  2.0 * beta]])
    elif mode == "smagorinsky":
        tau0, cs = 1.0 / inv_tau, problem.smagorinsky
        smag[:] = (tau0, tau0 * tau0, 18.0 * cs * cs)
    elif mode == "power_law":
        k, n = problem.power_law
        plaw[:] = (float(n) - 1.0, np.log(3.0 * k),
                   np.log(physics.PLAW_TAU_MIN - 0.5),
                   np.log(physics.PLAW_TAU_MAX - 0.5))
    blocks = [trt, mrt_u.ravel(), mrt_v.ravel(), reg,
              *([kbc] if d == 2 else []), smag, plaw]
    return tuple(float(v) for v in np.concatenate(blocks))


def kernel_domain(problem: Problem) -> int:
    """The kernels' domain for `problem`'s boundary layout, an index of
    DOMAINS (D2Q9) or DOMAINS_3D (D3Q19, D3Q27): the channel also for the
    slab (is_slab); raises NotImplementedError for a layout no kernel
    holds."""
    p = problem
    d3 = p.lattice.D == 3
    walls = (p.walls_y and (p.walls_z or not d3) and not p.periodic_y
             and not p.periodic_z)
    inlet, outlet = ((p.inlet_equilibrium, p.outlet_zero_grad) if d3
                     else (p.inlet_zou_he, p.outlet_zou_he))
    obstacle = p.solid is not None and bool(np.any(p.solid))
    if (p.periodic_x and p.periodic_y and p.periodic_z == d3
            and not (p.walls_y or p.walls_z)
            and not (inlet or outlet or obstacle or p.walls_x or p.lid_u
                     or p.clean_corners)):
        return 3
    if walls and inlet and outlet and not (p.periodic_x or p.walls_x
                                           or p.lid_u):
        return 0
    if walls and not (inlet or outlet or obstacle or p.clean_corners):
        if p.periodic_x and not (p.walls_x or p.lid_u):
            return 1
        if not d3 and p.walls_x and not p.periodic_x:
            return 2
    if is_slab(p):
        return 1
    raise NotImplementedError(
        f"no kernel holds the boundary layout of problem "
        f"{p.params.problem!r} (the kernels' domains: {DOMAINS} in 2-D, "
        f"{[d for d in DOMAINS_3D if d]} in 3-D)")


def is_slab(p: Problem) -> bool:
    """Whether `p` is the slab: a 2-D channel, periodic along x, with no y
    walls, no inlet, outlet, x walls or lid, whose walls are solid cells
    of its mask (tpulbm's fractional-wall, staircase and Couette
    channels, tests/test_bouzidi.py:68-91, 416-459)."""
    return (p.lattice.D == 2 and p.periodic_x and not p.periodic_y
            and not (p.walls_y or p.walls_x or p.lid_u or p.inlet_zou_he
                     or p.outlet_zou_he or p.clean_corners)
            and p.solid is not None and bool(np.any(p.solid)))


def variant_defines(variant: int) -> tuple[str, ...]:
    """nvcc's defines for a library's domain (variant & DOMAIN_BITS),
    SLAB, SOURCE, FORCE, BOUNCE_BACK, BOUZIDI, RINGS, D3Q27 and DEEP; ()
    for 0."""
    defines = []
    if variant & DOMAIN_BITS:
        defines.append(f"-DTPULBM_DOMAIN={variant & DOMAIN_BITS}")
    if variant & SLAB:
        defines.append("-DTPULBM_SLAB=1")
    if variant & SOURCE:
        defines.append("-DTPULBM_SOURCE=1")
    if variant & FORCE:
        defines.append("-DTPULBM_FORCE=1")
    if variant & BOUNCE_BACK:
        defines.append("-DTPULBM_BOUNCE_BACK=1")
    if variant & BOUZIDI:
        defines.append("-DTPULBM_BOUZIDI=1")
    if variant & RINGS:
        defines.append("-DTPULBM_RINGS=1")
    if variant & D3Q27:
        defines.append("-DTPULBM_Q=27")
    if variant & DEEP:
        defines.append("-DTPULBM_DEEP=1")
    return tuple(defines)


def deep_bit(n_sub: int, three_d: bool = False) -> int:
    """DEEP for a depth that the deep build of the 2-D (or 3-D) N-step
    kernel holds, else 0."""
    return DEEP if n_sub in (DEEP_DEPTHS_3D if three_d else DEEP_DEPTHS) else 0


def build_defines(mode: str, variant: int = 0) -> tuple[str, ...]:
    """nvcc's defines for a library of collision `mode` and `variant`."""
    return mode_defines(mode) + variant_defines(variant)


@dataclasses.dataclass(frozen=True)
class StepConstants:
    """The physics constants the kernel takes as arguments. `mode` and
    `variant` pick the library: the collision (COLLISION_MODES) and the
    domain, the source, the force profile and the obstacle rule
    (variant_defines); `modes` are the collision's coefficients
    (mode_floats), `src` the body force's source per direction (zeros
    without one), `lid` the moving lid's 6 w_i (c_i·u_lid) for i = 7, 8
    (the cavity), `force_axis` the force profile's axis (0 x, 1 y, 2 z;
    -1 without one) and `force_table` its (Q, n) source per coordinate
    (ForceProfile.table in float32, row by row), which a launch reads from
    a copy on the state's device. The 3-D kernels read inv_tau, eq_in, w,
    modes, src and the force table along z."""
    inv_tau: float
    u_in: float
    eq_in: tuple[float, ...]   # frozen ghost equilibrium per direction
    w: tuple[float, ...]       # weights: the solid cells' rest equilibrium
    mode: str = "bgk"
    clean_corners: bool = False
    modes: tuple[float, ...] = ()
    variant: int = 0
    src: tuple[float, ...] = ()
    lid: tuple[float, float] = (0.0, 0.0)
    force_axis: int = -1
    force_table: tuple[float, ...] = ()

    @property
    def library(self) -> str:
        """The library's name in the launch counts: the collision, then the
        domain, "slab", "source", "force", "bounce_back", "bouzidi" and
        "d3q27" where the build has them, as "mrt+channel+source",
        "bgk+bouzidi", "trt+box+force+d3q27" or
        "bgk+channel+slab+source+bouzidi"."""
        domains = DOMAINS if len(self.w) == 9 else DOMAINS_3D
        parts = [self.mode]
        if self.variant & DOMAIN_BITS:
            parts.append(domains[self.variant & DOMAIN_BITS])
        if self.variant & SLAB:
            parts.append("slab")
        if self.variant & SOURCE:
            parts.append("source")
        if self.variant & FORCE:
            parts.append("force")
        if self.variant & BOUNCE_BACK:
            parts.append("bounce_back")
        if self.variant & BOUZIDI:
            parts.append("bouzidi")
        if self.variant & D3Q27:
            parts.append("d3q27")
        return "+".join(parts)

    @functools.cached_property
    def _force_tables(self) -> dict:
        return {}

    def force_args(self, device: torch.device,
                   grid: tuple[int, int]) -> tuple[int, int | None]:
        """(force_axis, the table's device pointer or None) as the D2Q9
        launchers take them for a launch on the global `grid` (ny, nx), the
        3-D launchers the pointer alone for (nz, ny, nx); the table is
        copied to `device` once and kept. Raises unless a library built
        with the profile gets a table of the grid's extent along its axis,
        and one built without it none."""
        if bool(self.variant & FORCE) != bool(self.force_table):
            raise ValueError(f"library {self.library} and a force table of "
                             f"{len(self.force_table)} floats")
        if not self.force_table:
            return self.force_axis, None
        n = grid[::-1][self.force_axis]
        q = len(self.w)
        if len(self.force_table) != q * n:
            raise ValueError(f"the force table holds {len(self.force_table)}"
                             f" floats, not {q} x {n} for the grid {grid}")
        table = self._force_tables.get(device)
        if table is None:
            table = torch.tensor(self.force_table, dtype=torch.float32,
                                 device=device)
            self._force_tables[device] = table
        return self.force_axis, table.data_ptr()

    def _src(self) -> ctypes.Array:
        return _floats(self.src or (0.0,) * len(self.w))

    @functools.cached_property
    def d2q9_args(self) -> tuple:
        """inv_tau, u_in, 1 - u_in, eq_in, w, clean_corners, the mode
        coefficients, the source and the lid as the D2Q9 launchers take
        them, built once: a launch's host time is on the critical path of
        the 1-step kernel (≈ 37 µs a step at 2048x512)."""
        return (self.inv_tau, self.u_in, 1.0 - self.u_in,
                _floats(self.eq_in), _floats(self.w), int(self.clean_corners),
                _floats(self.modes), self._src(), *self.lid)

    @functools.cached_property
    def d3q19_args(self) -> tuple:
        """inv_tau, eq_in, w, the mode coefficients and the source as the
        3-D launchers take them, built once."""
        return (self.inv_tau, _floats(self.eq_in), _floats(self.w),
                _floats(self.modes), self._src())

    @classmethod
    def of(cls, problem: Problem) -> "StepConstants":
        lat = problem.lattice
        domain = kernel_domain(problem)
        slab = domain == 1 and is_slab(problem)
        # the obstacle rule acts in the obstacle domain and the slab
        rule = domain == 0 or slab
        bounce = rule and problem.obstacle_bc == "bounce_back"
        bouzidi = rule and problem.obstacle_bc == "bouzidi"
        force = problem.body_force
        prof = problem.force_profile
        variant = (domain | (SLAB if slab else 0) | (SOURCE if force else 0)
                   | (BOUNCE_BACK if bounce else 0)
                   | (BOUZIDI if bouzidi else 0)
                   | (FORCE if prof is not None else 0)
                   | (D3Q27 if lat.Q == 27 else 0))
        force_axis, force_table = -1, ()
        if prof is not None:
            n = problem.spatial_shape[::-1][prof.index]
            force_axis = prof.index
            force_table = tuple(prof.table(lat, n, torch.float32, "cpu")
                                .reshape(-1).tolist())
        src = (tuple(float(v) for v in physics.force_source(lat, force))
               if force else ())
        lid = (0.0, 0.0)
        if problem.lid_u:
            # tpulbm's apply_moving_wall coefficients for the top wall's
            # inward diagonals
            uw = np.array([problem.lid_u, 0.0])
            lid = tuple(6.0 * float(lat.w[i])
                        * float(lat.c[i].astype(np.float64) @ uw)
                        for i in (7, 8))
        return cls(inv_tau=1.0 / problem.params.tau,
                   u_in=float(problem.init_u[0]),
                   eq_in=tuple(float(v) for v in problem.ghost_ring_values()),
                   w=tuple(float(v) for v in lat.w),
                   mode=step_torch.collision_mode(problem),
                   clean_corners=bool(problem.clean_corners),
                   modes=mode_floats(problem), variant=variant, src=src,
                   lid=lid, force_axis=force_axis, force_table=force_table)


def check_inputs(f: torch.Tensor, out: torch.Tensor,
                 solid: torch.Tensor | None, q: int = 9) -> None:
    """Raise unless f and out are distinct contiguous float32 states of a
    q-population lattice, (9, ny, nx) or (19 or 27, nz, ny, nx), and solid
    (None
    for a shard, whose padded mask check_shard checks) a contiguous uint8
    mask of their spatial shape, all on one device."""
    rank, layout = _STATE_LAYOUT[q]
    if f.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"the kernels take float32 states, got "
                        f"{f.dtype} and {out.dtype}")
    if solid is not None and solid.dtype != torch.uint8:
        raise TypeError(f"solid mask must be uint8, got {solid.dtype}")
    if f.dim() != rank or f.shape[0] != q:
        raise ValueError(f"state must be {layout}, got {tuple(f.shape)}")
    if out.shape != f.shape or (solid is not None and tuple(solid.shape)
                                != tuple(f.shape[1:])):
        raise ValueError(f"shape mismatch: f {tuple(f.shape)}, out "
                         f"{tuple(out.shape)}, solid "
                         f"{None if solid is None else tuple(solid.shape)}")
    if not (f.is_contiguous() and out.is_contiguous()
            and (solid is None or solid.is_contiguous())):
        raise ValueError("f, out and solid must be contiguous")
    if not f.device == out.device == (f.device if solid is None
                                      else solid.device):
        raise ValueError(f"f, out and solid must share a device, got "
                         f"{f.device}, {out.device}, "
                         f"{None if solid is None else solid.device}")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {f.device}")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("out must not alias f (the step is not in place)")


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(source: str, fn: str, argtypes: list, mode: str | None = None,
          n_floats: int | None = None,
          variant: int | None = None) -> ctypes.CDLL:
    """The library of `source` with its launcher `fn` typed. Given a
    collision `mode`, the library is built for it and raises unless it
    holds that mode (tpulbm_collision_mode) and, given `n_floats`, takes
    that many mode coefficients (tpulbm_mode_floats); given a `variant`,
    it is built for that domain, source and obstacle rule and raises unless
    it holds them (tpulbm_build_variant)."""
    defines = ((mode_defines(mode) if mode else ())
               + (variant_defines(variant) if variant else ()))
    lib = cuda_build.load(source, defines).lib
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = _I32
    lib.tpulbm_cuda_error_string.argtypes = [_I32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    if mode is not None:
        held = (COLLISION_MODES[lib.tpulbm_collision_mode()],
                lib.tpulbm_mode_floats() if n_floats is not None else None)
        if held != (mode, n_floats):
            raise RuntimeError(f"{source} built for {mode!r} holds {held}, "
                               f"not ({mode!r}, {n_floats})")
    if variant is not None and lib.tpulbm_build_variant() != variant:
        raise RuntimeError(f"{source} built for variant {variant} holds "
                           f"{lib.tpulbm_build_variant()}")
    return lib


def mode_defines(mode: str) -> tuple[str, ...]:
    """nvcc's defines for a library of collision `mode`; none for BGK,
    whose library builds as it always has."""
    index = COLLISION_MODES.index(mode)
    return (f"-DTPULBM_COLLISION={index}",) if index else ()


def _bind_march1(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The 1-step D2Q9 library with its queries of the row march at depth
    1 typed: tpulbm_d2q9_smem_bytes(corners), _width(), _rows(),
    _threads() and _grid(cols, rows, corners, device) (strips * 65536 +
    segments)."""
    lib.tpulbm_d2q9_smem_bytes.argtypes = [_I32]
    lib.tpulbm_d2q9_smem_bytes.restype = _I32
    for name in ("width", "rows", "threads"):
        getattr(lib, f"tpulbm_d2q9_{name}").argtypes = []
        getattr(lib, f"tpulbm_d2q9_{name}").restype = _I32
    lib.tpulbm_d2q9_grid.argtypes = [_I32] * 4
    lib.tpulbm_d2q9_grid.restype = _I32
    return lib


@functools.cache
def _library(mode: str = "bgk", variant: int = 0) -> ctypes.CDLL:
    return _bind_march1(_bind(
        "step_d2q9.cu", "tpulbm_d2q9_step",
        [_PTR, _PTR, _PTR, _I32, _I32, _F32, _F32, _F32, _PTR, _PTR, _I32,
         _PTR, _PTR, _F32, _F32, _I32, _PTR, _PTR, _I32, _I32, _PTR], mode,
        MODE_FLOATS, variant))


def _bind_3d(source: str, fn: str, argtypes: list, mode: str,
             variant: int) -> ctypes.CDLL:
    """_bind for a 3-D source, which also raises unless the library holds
    the velocity set its variant names (tpulbm_lattice_q)."""
    q = 27 if variant & D3Q27 else 19
    lib = _bind(source, fn, argtypes, mode, mode_floats_3d(q), variant)
    lib.tpulbm_lattice_q.restype = _I32
    if lib.tpulbm_lattice_q() != q:
        raise RuntimeError(f"{source} built for D3Q{q} holds D3Q"
                           f"{lib.tpulbm_lattice_q()}")
    return lib


_RINGS_ARGS_3D = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32,
                  _I32, _I32, _I32, _I32, _I32]
_CONSTS_ARGS_3D = [_F32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _PTR]


def _bind_zmarch(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The 1-step D3Q19 library with its queries of the z-march typed:
    tpulbm_d3q19_smem_bytes(), _tile() (x * 256 + y), _threads(), _lag(),
    _resident(device) and _grid(cols, rows, nz, device) (the march's
    planes)."""
    for name in ("smem_bytes", "tile", "threads", "lag"):
        getattr(lib, f"tpulbm_d3q19_{name}").argtypes = []
        getattr(lib, f"tpulbm_d3q19_{name}").restype = _I32
    lib.tpulbm_d3q19_resident.argtypes = [_I32]
    lib.tpulbm_d3q19_resident.restype = _I32
    lib.tpulbm_d3q19_grid.argtypes = [_I32] * 4
    lib.tpulbm_d3q19_grid.restype = _I32
    return lib


@functools.cache
def _rings_library_3d(mode: str = "bgk", variant: int = 0) -> ctypes.CDLL:
    return _bind_zmarch(_bind_3d(
        "step_d3q19.cu", "tpulbm_d3q19_step_rings",
        _RINGS_ARGS_3D + _CONSTS_ARGS_3D, mode, variant | RINGS))


_SCRATCH_ARGS = [_PTR, ctypes.c_longlong]


def _bind_scratch(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The N-step 3-D library with its queries typed."""
    lib.tpulbm_d3q19_blocked_smem_bytes.argtypes = [_I32]
    lib.tpulbm_d3q19_blocked_smem_bytes.restype = _I32
    lib.tpulbm_d3q19_blocked_scratch_bytes.argtypes = [_I32, _I32]
    lib.tpulbm_d3q19_blocked_scratch_bytes.restype = ctypes.c_longlong
    lib.tpulbm_d3q19_blocked_tile.argtypes = [_I32]
    lib.tpulbm_d3q19_blocked_tile.restype = _I32
    lib.tpulbm_d3q19_blocked_cluster.argtypes = [_I32]
    lib.tpulbm_d3q19_blocked_cluster.restype = _I32
    lib.tpulbm_d3q19_blocked_threads.argtypes = [_I32]
    lib.tpulbm_d3q19_blocked_threads.restype = _I32
    lib.tpulbm_d3q19_blocked_active_clusters.argtypes = [_I32, _I32]
    lib.tpulbm_d3q19_blocked_active_clusters.restype = _I32
    return lib


@functools.cache
def _rings_blocked_library_3d(mode: str = "bgk",
                              variant: int = 0) -> ctypes.CDLL:
    return _bind_scratch(_bind_3d(
        "step_d3q19_blocked.cu", "tpulbm_d3q19_step_blocked_rings",
        _RINGS_ARGS_3D + [_I32] + _CONSTS_ARGS_3D[:-2] + _SCRATCH_ARGS
        + _CONSTS_ARGS_3D[-2:], mode, variant | RINGS))


@functools.cache
def _library_3d(mode: str = "bgk", variant: int = 0) -> ctypes.CDLL:
    return _bind_zmarch(_bind_3d(
        "step_d3q19.cu", "tpulbm_d3q19_step",
        [_PTR, _PTR, _PTR, _I32, _I32, _I32, _F32, _PTR, _PTR, _PTR, _PTR,
         _PTR, _PTR, _I32, _I32, _PTR], mode, variant))


@functools.cache
def _blocked_library_3d(mode: str = "bgk", variant: int = 0) -> ctypes.CDLL:
    return _bind_scratch(_bind_3d(
        "step_d3q19_blocked.cu", "tpulbm_d3q19_step_blocked",
        [_PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _F32, _PTR, _PTR, _PTR,
         _PTR, _PTR, _PTR, _I32] + _SCRATCH_ARGS + [_I32, _PTR], mode,
        variant))


def _bind_march(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The N-step D2Q9 library with its queries of the march typed:
    tpulbm_d2q9_blocked_smem_bytes(n_sub, corners), _width(), _rows(),
    _threads(n_sub) and _grid(n_sub, cols, rows, corners, device)."""
    lib.tpulbm_d2q9_blocked_smem_bytes.argtypes = [_I32, _I32]
    lib.tpulbm_d2q9_blocked_smem_bytes.restype = _I32
    for name in ("width", "rows"):
        getattr(lib, f"tpulbm_d2q9_blocked_{name}").argtypes = []
        getattr(lib, f"tpulbm_d2q9_blocked_{name}").restype = _I32
    lib.tpulbm_d2q9_blocked_threads.argtypes = [_I32]
    lib.tpulbm_d2q9_blocked_threads.restype = _I32
    lib.tpulbm_d2q9_blocked_grid.argtypes = [_I32] * 5
    lib.tpulbm_d2q9_blocked_grid.restype = _I32
    return lib


@functools.cache
def _blocked_library(mode: str = "bgk", variant: int = 0) -> ctypes.CDLL:
    return _bind_march(_bind(
        "step_d2q9_blocked.cu", "tpulbm_d2q9_step_blocked",
        [_PTR, _PTR, _PTR, _I32, _I32, _I32, _F32, _F32, _F32, _PTR, _PTR,
         _I32, _PTR, _PTR, _F32, _F32, _I32, _PTR, _PTR, _I32, _I32, _PTR],
        mode, MODE_FLOATS, variant))


_RINGS_ARGS = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32,
               _I32, _I32, _I32, _I32, _I32, _I32]
_CONSTS_ARGS = [_F32, _F32, _F32, _PTR, _PTR, _I32, _PTR, _PTR, _F32, _F32,
                _I32, _PTR, _PTR, _I32, _I32, _PTR]


@functools.cache
def _rings_library(mode: str = "bgk", variant: int = 0) -> ctypes.CDLL:
    return _bind_march1(_bind("step_d2q9.cu", "tpulbm_d2q9_step_rings",
                              _RINGS_ARGS + _CONSTS_ARGS, mode, MODE_FLOATS,
                              variant | RINGS))


@functools.cache
def _rings_blocked_library(mode: str = "bgk",
                           variant: int = 0) -> ctypes.CDLL:
    return _bind_march(_bind(
        "step_d2q9_blocked.cu", "tpulbm_d2q9_step_blocked_rings",
        _RINGS_ARGS + [_I32] + _CONSTS_ARGS, mode, MODE_FLOATS,
        variant | RINGS))


def link_args(consts: StepConstants, links: torch.Tensor | None,
              shape: tuple, f: torch.Tensor) -> tuple[int | None, int]:
    """(the link table's device pointer or None, its planes) as the
    launchers take them. Raises unless a Bouzidi library gets a contiguous
    float32 table of Q or 2Q planes of `shape` on f's device (the whole
    grid, or a shard's block padded as its mask) and any other library
    none."""
    q = len(consts.w)
    if bool(consts.variant & BOUZIDI) != (links is not None):
        raise ValueError(f"library {consts.library} and "
                         + ("no link table" if links is None else
                            f"a link table {tuple(links.shape)}"))
    if links is None:
        return None, 0
    if (links.dtype != torch.float32 or not links.is_contiguous()
            or links.device != f.device or links.shape[0] not in (q, 2 * q)
            or tuple(links.shape[1:]) != tuple(shape)):
        raise ValueError(f"the link table must be a contiguous float32 "
                         f"({q} or {2 * q}, *{tuple(shape)}) on {f.device}, "
                         f"got {links.dtype} {tuple(links.shape)} on "
                         f"{links.device}")
    return links.data_ptr(), links.shape[0]


def _check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.tpulbm_cuda_error_string(rc).decode())


def _floats(values: tuple) -> ctypes.Array:
    return (ctypes.c_float * len(values))(*values)


def _scratch_args(f: torch.Tensor, n_sub: int, scratch) -> tuple:
    """The N-step 3-D launchers' scratch buffer and its bytes (None, 0
    without one); nothing for the other launchers."""
    if f.dim() == 3 or n_sub == 1:
        return ()
    return (None, 0) if scratch is None else (scratch.data_ptr(),
                                              scratch.numel())


def launch_args(f: torch.Tensor, out: torch.Tensor, solid: torch.Tensor,
                consts: "StepConstants", n_sub: int,
                links: torch.Tensor | None, stream=None,
                scratch: torch.Tensor | None = None) -> tuple:
    """The arguments of a one-device launcher (tpulbm_d2q9_step and
    tpulbm_d3q19_step at n_sub 1, their _blocked forms at n_sub > 1) for a
    launch from f into out on `stream` of f's device; `scratch`, a uint8
    buffer on the device, is the N-step 3-D kernel's where it needs one
    (scratch_for)."""
    shape = tuple(f.shape[1:])
    if f.dim() == 3:
        tail = (*consts.d2q9_args, *consts.force_args(f.device, shape))
    else:
        tail = (*consts.d3q19_args, consts.force_args(f.device, shape)[1])
    return (f.data_ptr(), out.data_ptr(), solid.data_ptr(), *shape[::-1],
            *(() if n_sub == 1 else (n_sub,)), *tail,
            *link_args(consts, links, shape, f),
            *_scratch_args(f, n_sub, scratch), f.device.index or 0, stream)


def ring_launch_args(f: torch.Tensor, out: torch.Tensor, rings: tuple,
                     shard: "Shard", consts: "StepConstants", n_sub: int,
                     rows: tuple[int, int] = (0, 0), stream=None,
                     scratch: torch.Tensor | None = None) -> tuple:
    """The arguments of a ring launcher (tpulbm_d2q9_step_rings and
    tpulbm_d3q19_step_rings at n_sub 1, their _blocked forms at n_sub > 1)
    for a launch of `shard` from f and its rings into the rows [r0, r1) of
    out (2-D; a 3-D launch writes the whole block) on `stream`, with the
    N-step 3-D kernel's `scratch` as in launch_args."""
    rb, rt, rl, rr = rings
    y0, x0 = shard.origin
    nyl, nxl = shard.local_shape[-2:]
    hx = n_sub if shard.x_rings else 0
    grid = tuple(shard.grid)
    if f.dim() == 3:
        geometry = (*grid[::-1], nxl, nyl, x0, y0, hx, *rows)
        tail = (*consts.d2q9_args, *consts.force_args(f.device, grid))
    else:
        geometry = (*grid[::-1], nxl, nyl, x0, y0, hx)
        tail = (*consts.d3q19_args, consts.force_args(f.device, grid)[1])
    return (f.data_ptr(), out.data_ptr(), shard.mask.data_ptr(), _ptr(rb),
            _ptr(rt), _ptr(rl), _ptr(rr), *geometry,
            *(() if n_sub == 1 else (n_sub,)), *tail,
            *link_args(consts, shard.links, tuple(shard.mask.shape), f),
            *_scratch_args(f, n_sub, scratch), f.device.index or 0, stream)


def collide_stream(f: torch.Tensor, out: torch.Tensor, solid: torch.Tensor,
                   consts: StepConstants, plain=None,
                   links: torch.Tensor | None = None) -> torch.Tensor:
    """One timestep from f into out; returns out. solid is the uint8
    kernel_mask, links the Bouzidi library's link table (None for the
    others).

    On a CUDA tensor: launches the kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step for the same problem)."""
    check_inputs(f, out, solid)
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(f))
    lib = _library(consts.mode, consts.variant)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.tpulbm_d2q9_step(*launch_args(f, out, solid, consts, 1, links,
                                           stream))
    _check_launch(lib, rc, f"D2Q9 kernel ({consts.library})")
    _count(collide_stream, consts.library)
    return out


def _zero_counts(wrapper, modes: tuple, depths: tuple | None = None) -> None:
    """Set a kernel wrapper's launch counts to 0. Its one count is
    launches_by_library: per library launched (StepConstants.library, whose
    first part is the collision mode; the mode itself for a wrapper with
    one library per mode), an int, or a dict per depth (`depths`) for an
    N-step wrapper, whose counts are dicts per shard (iy, ix) for the ring
    wrapper. launches() and launches_by_mode() sum it over libraries (and
    shards). CPU calls (the plain version) are not counted."""
    wrapper.modes, wrapper.depths = modes, depths
    wrapper.launches_by_library = {}


def _count(wrapper, library: str, n_sub: int | None = None,
           shard: tuple[int, int] | None = None) -> None:
    """Count one launch of `wrapper`'s kernel from `library`, at depth
    n_sub for an N-step wrapper, on `shard` for the ring wrapper. A deep
    depth (DEEP_DEPTHS, DEEP_DEPTHS_3D) gets its count at its first
    launch, so the counts of a run that launched none keep the default
    depths alone."""
    by_library = wrapper.launches_by_library
    if n_sub is None:
        by_library[library] = by_library.get(library, 0) + 1
    elif shard is None:
        per_depth = by_library.setdefault(library,
                                          dict.fromkeys(wrapper.depths, 0))
        per_depth[n_sub] = per_depth.get(n_sub, 0) + 1
    else:
        per_shard = by_library.setdefault(
            library, {d: {} for d in wrapper.depths}).setdefault(n_sub, {})
        per_shard[shard] = per_shard.get(shard, 0) + 1


def _total(n) -> int:
    """A count, or the sum of a dict of counts per shard."""
    return sum(n.values()) if isinstance(n, dict) else n


def _depths(wrapper) -> tuple | None:
    """An N-step wrapper's default depths, then the deep ones it has
    launched; None for a 1-step wrapper."""
    if wrapper.depths is None:
        return None
    deep = {d for n in wrapper.launches_by_library.values() for d in n}
    return wrapper.depths + tuple(sorted(deep - set(wrapper.depths)))


def launches_by_mode(wrapper) -> dict:
    """`wrapper`'s launches per collision mode it holds (0 where none), each
    summed over the mode's libraries (and shards); per depth for an N-step
    wrapper (its default depths, and a deep one once launched)."""
    depths = _depths(wrapper)
    out = {mode: 0 if depths is None else dict.fromkeys(depths, 0)
           for mode in wrapper.modes}
    for library, n in wrapper.launches_by_library.items():
        mode = library.split("+")[0]
        if depths is None:
            out[mode] += n
        else:
            for d in depths:
                out[mode][d] += _total(n.get(d, 0))
    return out


def launches(wrapper):
    """`wrapper`'s launches summed over its libraries; per depth for an
    N-step wrapper (its default depths, and a deep one once launched)."""
    by_mode = launches_by_mode(wrapper).values()
    depths = _depths(wrapper)
    if depths is None:
        return sum(by_mode)
    return {d: sum(n[d] for n in by_mode) for d in depths}


def launches_by_shard(wrapper) -> dict:
    """The ring wrapper's launches per (library, depth, shard), zeros
    left out."""
    return {(library, d, shard): n
            for library, per_depth in wrapper.launches_by_library.items()
            for d, per_shard in per_depth.items()
            for shard, n in per_shard.items() if n}


_zero_counts(collide_stream, COLLISION_MODES)


def check_depth(n_sub: int) -> None:
    """Raise NotImplementedError for a blocking depth with no kernel: the
    port holds 2-D depths 2 to MAX_DEPTH (tpulbm's TPU build takes deeper
    ones while VMEM holds them)."""
    if n_sub not in BLOCKED_DEPTHS + DEEP_DEPTHS:
        raise NotImplementedError(
            f"temporal blocking at depth {n_sub}: the port's N-step kernel "
            f"holds depths 2 to {MAX_DEPTH}, its cap (tpulbm's TPU build "
            "takes deeper ones while VMEM holds them; ROADMAP Queue 3, "
            "different by design)")


def collide_stream_blocked(f: torch.Tensor, out: torch.Tensor,
                           solid: torch.Tensor, consts: StepConstants,
                           n_sub: int, plain=None,
                           links: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """n_sub timesteps from f into out in one launch; returns out.

    On a CUDA tensor: launches the N-step kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step) n_sub times."""
    check_depth(n_sub)
    check_inputs(f, out, solid)
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        for _ in range(n_sub):
            f = plain(f)
        return out.copy_(f)
    lib = _blocked_library(consts.mode, consts.variant | deep_bit(n_sub))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.tpulbm_d2q9_step_blocked(*launch_args(
        f, out, solid, consts, n_sub, links, stream))
    _check_launch(lib, rc, f"D2Q9 {n_sub}-step kernel ({consts.library})")
    _count(collide_stream_blocked, consts.library, n_sub)
    return out


_zero_counts(collide_stream_blocked, COLLISION_MODES, BLOCKED_DEPTHS)


@dataclasses.dataclass(frozen=True, eq=False)
class Shard:
    """One shard of a mesh as the ring kernels take it: its place `index`
    (iy, ix) in the mesh, the global (y, x) `origin` of its block of
    `local_shape` ([nz,] nyl, nxl) in the global `grid` ([nz,] ny, nx; a
    3-D block holds every z plane), the `depth` of its rings, whether it
    takes x rings (`x_rings`: the mesh cuts x, or TPULBM_FORCE_TILED, in
    3-D TPULBM_FORCE_XHALO; else its block spans every column), `mask`,
    its uint8 kernel mask padded by `depth` rows and columns on every side
    (halo.pad_mask, with the link bits under the Bouzidi obstacle) and
    `links`, the Bouzidi library's cut of the link table padded the same
    way (bouzidi.table_block; None for the others). The thermal and
    multiphase kernels take no mask (None)."""
    index: tuple[int, int]
    origin: tuple[int, int]
    local_shape: tuple[int, ...]
    grid: tuple[int, ...]
    depth: int
    x_rings: bool
    mask: torch.Tensor | None = None
    links: torch.Tensor | None = None


def _check_ring(name: str, t, shape: tuple, f: torch.Tensor) -> None:
    if t is None:
        raise ValueError(f"ring {name} is missing")
    if (t.dtype != torch.float32 or tuple(t.shape) != shape
            or not t.is_contiguous() or t.device != f.device):
        raise ValueError(f"ring {name} must be a contiguous float32 {shape} "
                         f"on {f.device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def check_shard(f: torch.Tensor, out: torch.Tensor, rings: tuple,
                shard: Shard, n_sub: int, rows: tuple[int, int],
                q2d: int = 9, depths: dict | None = None) -> None:
    """Raise unless f, out, the rings (rb, rt, rl, rr), the shard and the
    row range fit together: the checks before any pointer is passed. A
    2-D shard's rings are (q2d, depth, nxl + 2 hx) and (q2d, nyl, hx), a
    3-D one's (Q, nz, depth, nxl + 2 hx) and (Q, nz, nyl, hx). `depths`
    maps each ring depth the kernel takes to the steps a launch makes
    from it (default: n_sub steps from rings n_sub deep); a kernel that
    takes no mask (the thermal and multiphase ones, q2d 14 and 9 with
    `depths` given) gets a shard without one."""
    nyl, nxl = shard.local_shape[-2:]
    ny, nx = shard.grid[-2:]
    lead = tuple(shard.local_shape[:-2])
    depth = shard.depth
    q = f.shape[0] if f.dim() else 0
    if lead and q not in (19, 27):
        raise ValueError(f"a 3-D shard's state is (19 or 27, nz, nyl, nxl), "
                         f"got {tuple(f.shape)}")
    check_inputs(f, out, None, q=q if lead else q2d)
    if tuple(f.shape[1:]) != tuple(shard.local_shape) or \
            tuple(shard.grid[:-2]) != lead:
        raise ValueError(f"state {tuple(f.shape)} is not the shard's block "
                         f"{shard.local_shape} of {shard.grid}")
    masked = depths is None
    if masked:
        held = (RINGS_DEPTHS_3D + DEEP_DEPTHS_3D if lead
                else RINGS_DEPTHS + DEEP_DEPTHS)
        if n_sub != depth or depth not in held:
            raise ValueError(f"depth {n_sub} with rings {depth} deep (the "
                             f"ring kernels hold depths {held})")
        if not lead and shard.x_rings and depth > TILED_MAX_DEPTH:
            raise ValueError(
                f"x rings at depth {depth}: tpulbm's x-tiled kernel takes "
                f"depths up to {TILED_MAX_DEPTH} ({TILED_ASSERT})")
    elif depths.get(depth) != n_sub:
        raise ValueError(f"{n_sub} steps with rings {depth} deep (this ring "
                         f"kernel takes rings {tuple(depths)} deep for "
                         f"{tuple(depths.values())} steps)")
    if min(nyl, nxl) < max(depth, 3):
        raise ValueError(f"a shard needs at least max({depth}, 3) rows and "
                         f"columns, got {shard.local_shape}")
    r0, r1 = rows
    if not 0 <= r0 < r1 <= nyl or (lead and (r0, r1) != (0, nyl)):
        raise ValueError(f"row range {rows} outside [0, {nyl})"
                         + (" (a 3-D launch writes every row)" if lead
                            else ""))
    hx = depth if shard.x_rings else 0
    if not shard.x_rings and (shard.origin[1] != 0 or nxl != nx):
        raise ValueError("a shard without x rings must span every column")
    mask = shard.mask
    padded = lead + (nyl + 2 * depth, nxl + 2 * depth)
    if not masked:
        if mask is not None:
            raise ValueError("this kernel takes no shard mask")
    elif (mask is None or mask.dtype != torch.uint8
          or not mask.is_contiguous() or tuple(mask.shape) != padded
          or mask.device != f.device):
        raise ValueError(f"shard mask must be contiguous uint8 {padded} on "
                         f"{f.device}")
    rb, rt, rl, rr = rings
    width = nxl + 2 * hx
    # a launch reads rows [r0 - depth - 1, r1 + depth + 1) (csrc's Shard)
    if rb is not None or r0 <= depth:
        _check_ring("rb", rb, (q,) + lead + (depth, width), f)
    if rt is not None or r1 >= nyl - depth:
        _check_ring("rt", rt, (q,) + lead + (depth, width), f)
    if shard.x_rings:
        _check_ring("rl", rl, (q,) + lead + (nyl, depth), f)
        _check_ring("rr", rr, (q,) + lead + (nyl, depth), f)
    elif rl is not None or rr is not None:
        raise ValueError("x rings given to a shard that spans every column")
    if not (0 <= shard.origin[0] <= ny - nyl
            and 0 <= shard.origin[1] <= nx - nxl):
        raise ValueError(f"shard origin {shard.origin} outside the grid")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def collide_stream_rings(f: torch.Tensor, out: torch.Tensor, rings: tuple,
                         shard: Shard, consts: StepConstants, n_sub: int,
                         rows: tuple[int, int] | None = None,
                         plain=None) -> torch.Tensor:
    """n_sub timesteps of one shard from its block f and its rings
    (rb, rt, rl, rr; shard.depth = n_sub cells deep) into the rows
    [r0, r1) of out (every row when `rows` is None; the other rows of out
    are left as they are); returns out. A ring the rows do not reach may
    be None (the interior range of the overlap mode reads none).

    On a CUDA tensor: launches the rings build of the 1-step kernel
    (n_sub 1) or of the N-step kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (step_rings_torch.make_ring_step for the shard)."""
    nyl = shard.local_shape[0]
    rows = (0, nyl) if rows is None else tuple(rows)
    check_shard(f, out, rings, shard, n_sub, rows)
    r0, r1 = rows
    rb, rt, rl, rr = rings
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        width = shard.local_shape[1] + (2 * n_sub if shard.x_rings else 0)
        blank = f.new_zeros((9, n_sub, width))
        new = plain(f, blank if rb is None else rb,
                    blank if rt is None else rt, rl, rr)
        out[:, r0:r1] = new[:, r0:r1]
        return out
    stream = torch.cuda.current_stream(f.device).cuda_stream
    args = ring_launch_args(f, out, rings, shard, consts, n_sub, rows, stream)
    if n_sub == 1:
        lib = _rings_library(consts.mode, consts.variant)
        rc = lib.tpulbm_d2q9_step_rings(*args)
    else:
        lib = _rings_blocked_library(consts.mode,
                                     consts.variant | deep_bit(n_sub))
        rc = lib.tpulbm_d2q9_step_blocked_rings(*args)
    _check_launch(lib, rc, f"D2Q9 {n_sub}-step ring kernel "
                           f"({consts.library}, shard {shard.index})")
    _count(collide_stream_rings, consts.library, n_sub, shard.index)
    return out


_zero_counts(collide_stream_rings, COLLISION_MODES, RINGS_DEPTHS)


def collide_stream_rings_3d(f: torch.Tensor, out: torch.Tensor,
                            rings: tuple, shard: Shard,
                            consts: StepConstants, n_sub: int,
                            plain=None) -> torch.Tensor:
    """n_sub D3Q19 or D3Q27 timesteps of one shard of a 3-D mesh from its
    block f (Q, nz, nyl, nxl) and its rings (rb, rt, rl, rr; shard.depth =
    n_sub cells deep, rl and rr None where the block spans every column)
    into out; returns out.

    On a CUDA tensor: launches the ring build of the 1-step D3Q19 kernel
    (n_sub 1) or of the N-step one (2, 3) on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (step_rings_torch.make_ring_step for the shard)."""
    nyl = shard.local_shape[-2]
    check_shard(f, out, rings, shard, n_sub, (0, nyl))
    if len(consts.w) != f.shape[0]:
        raise ValueError(f"library {consts.library} of Q = {len(consts.w)} "
                         f"and a state of {f.shape[0]} populations")
    rb, rt, rl, rr = rings
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(f, rb, rt, rl, rr))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    if n_sub == 1:
        lib = _rings_library_3d(consts.mode, consts.variant)
        rc = lib.tpulbm_d3q19_step_rings(*ring_launch_args(
            f, out, rings, shard, consts, n_sub, stream=stream))
    else:
        lib = _rings_blocked_library_3d(consts.mode, consts.variant
                                        | deep_bit(n_sub, three_d=True))
        scratch = scratch_for(lib, n_sub, f.device)  # held past the launch
        rc = lib.tpulbm_d3q19_step_blocked_rings(*ring_launch_args(
            f, out, rings, shard, consts, n_sub, stream=stream,
            scratch=scratch))
    _check_launch(lib, rc, f"3-D {n_sub}-step ring kernel "
                           f"({consts.library}, shard {shard.index})")
    _count(collide_stream_rings_3d, consts.library, n_sub, shard.index)
    return out


_zero_counts(collide_stream_rings_3d, COLLISION_MODES_3D, RINGS_DEPTHS_3D)


def collide_stream_3d(f: torch.Tensor, out: torch.Tensor,
                      solid: torch.Tensor, consts: StepConstants,
                      plain=None,
                      links: torch.Tensor | None = None) -> torch.Tensor:
    """One D3Q19 or D3Q27 timestep from f into out; returns out.

    On a CUDA tensor: launches the kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step for the same problem)."""
    check_inputs(f, out, solid, q=len(consts.w))
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(f))
    lib = _library_3d(consts.mode, consts.variant)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.tpulbm_d3q19_step(*launch_args(f, out, solid, consts, 1, links,
                                            stream))
    _check_launch(lib, rc, f"3-D kernel ({consts.library})")
    _count(collide_stream_3d, consts.library)
    return out


_zero_counts(collide_stream_3d, COLLISION_MODES_3D)


def check_depth_3d(n_sub: int) -> None:
    """Raise NotImplementedError for a 3-D blocking depth with no kernel:
    2 to MAX_DEPTH, tpulbm's halo height, above which its dispatch (and
    stepper.plan_3d) plans the 1-step kernel instead."""
    if n_sub not in BLOCKED_DEPTHS_3D + DEEP_DEPTHS_3D:
        raise NotImplementedError(
            f"3-D temporal blocking at depth {n_sub}: the N-step kernel "
            f"holds depths 2 to {MAX_DEPTH}, tpulbm's halo height (its "
            "dispatch plans no deeper one)")


def scratch_for(lib: ctypes.CDLL, n_sub: int, device: torch.device):
    """The scratch buffer an N-step 3-D launch of `lib` at n_sub needs on
    `device` (its stage rings where no tile fits shared memory: D3Q27 at
    8), a uint8 tensor from PyTorch's allocator, or None. The caller holds
    it until the launch is enqueued (its pointer alone does not keep it);
    freed then, its memory goes only to later work on the stream."""
    nbytes = lib.tpulbm_d3q19_blocked_scratch_bytes(n_sub, device.index or 0)
    if nbytes < 0:
        raise RuntimeError(f"the N-step 3-D kernel's scratch query failed "
                           f"at depth {n_sub}")
    return (torch.empty(nbytes, dtype=torch.uint8, device=device)
            if nbytes else None)


def collide_stream_3d_blocked(f: torch.Tensor, out: torch.Tensor,
                              solid: torch.Tensor, consts: StepConstants,
                              n_sub: int, plain=None,
                              links: torch.Tensor | None = None
                              ) -> torch.Tensor:
    """n_sub D3Q19 or D3Q27 timesteps from f into out in one launch;
    returns out.

    On a CUDA tensor: launches the N-step kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step) n_sub times."""
    check_depth_3d(n_sub)
    check_inputs(f, out, solid, q=len(consts.w))
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        for _ in range(n_sub):
            f = plain(f)
        return out.copy_(f)
    lib = _blocked_library_3d(consts.mode,
                              consts.variant | deep_bit(n_sub, three_d=True))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    scratch = scratch_for(lib, n_sub, f.device)  # held past the launch
    rc = lib.tpulbm_d3q19_step_blocked(*launch_args(
        f, out, solid, consts, n_sub, links, stream, scratch))
    _check_launch(lib, rc, f"3-D {n_sub}-step kernel ({consts.library})")
    _count(collide_stream_3d_blocked, consts.library, n_sub)
    return out


_zero_counts(collide_stream_3d_blocked, COLLISION_MODES_3D,
             BLOCKED_DEPTHS_3D)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0, the thermal and multiphase
    kernels' and their ring builds' (ops/step_thermal_cuda.py,
    ops/step_multiphase_cuda.py) included."""
    from . import step_multiphase_cuda, step_thermal_cuda
    _zero_counts(collide_stream, COLLISION_MODES)
    _zero_counts(collide_stream_blocked, COLLISION_MODES, BLOCKED_DEPTHS)
    _zero_counts(collide_stream_rings, COLLISION_MODES, RINGS_DEPTHS)
    _zero_counts(collide_stream_rings_3d, COLLISION_MODES_3D,
                 RINGS_DEPTHS_3D)
    _zero_counts(collide_stream_3d, COLLISION_MODES_3D)
    _zero_counts(collide_stream_3d_blocked, COLLISION_MODES_3D,
                 BLOCKED_DEPTHS_3D)
    _zero_counts(step_thermal_cuda.collide_stream_thermal,
                 step_thermal_cuda.MODES)
    _zero_counts(step_thermal_cuda.collide_stream_thermal_rings,
                 step_thermal_cuda.MODES, (1,))
    step_multiphase_cuda.collide_stream_multiphase.launches = 0
    _zero_counts(step_multiphase_cuda.collide_stream_multiphase_rings,
                 ("bgk",), (step_multiphase_cuda.DEPTH,))


def kernel_constants(problem: Problem, q: int = 9) -> StepConstants:
    """The constants of `problem`'s kernel library; raises for what the
    kernels do not cover: they run the equilibrium, the bounce-back and
    the Bouzidi obstacles (in the obstacle domain and, 2-D, the slab),
    the D2Q9 kernels every collision and the force profile along
    x or y, the 3-D kernels (q 19: D3Q19 or D3Q27) every collision but KBC
    (and MRT on D3Q27), as tpulbm's, and the force profile along z, in the
    domains of DOMAINS and DOMAINS_3D."""
    q3 = q != 9
    if ((problem.lattice.Q not in (19, 27) if q3
         else problem.lattice.Q != 9)
            or problem.thermal is not None or problem.shan_chen):
        takes = ("problems 'cylinder', 'poiseuille', 'cavity', "
                 "'taylor-green', 'shear-layer' and 'kolmogorov' in 2-D"
                 if not q3 else "the sphere in a duct (problem "
                 "'cylinder3d'), the Poiseuille duct (problem 'poiseuille') "
                 "and the boxes (problems 'taylor-green' and 'kolmogorov') "
                 "with nz > 0")
        raise NotImplementedError(
            f"the {'3-D' if q3 else 'D2Q9'} kernels take {takes}, "
            f"not problem {problem.params.problem!r} on "
            f"{problem.lattice.name}")
    if problem.obstacle_bc not in ("equilibrium", "bounce_back", "bouzidi"):
        raise NotImplementedError(f"the kernels do not hold obstacle_bc="
                                  f"{problem.obstacle_bc!r}")
    prof = problem.force_profile
    if prof is not None and (prof.axis == "z") != q3:
        raise NotImplementedError(
            f"a force profile along {prof.axis!r} in the "
            f"{'3-D' if q3 else 'D2Q9'} kernels: they read a table per "
            f"{'z' if q3 else 'x or y'} (3-D Kolmogorov's force varies "
            "along z)")
    consts = StepConstants.of(problem)
    if (q == 9 and DOMAINS[consts.variant & DOMAIN_BITS] == "cavity"
            and min(problem.spatial_shape) < 3):
        raise ValueError("the cavity kernels take nx = ny >= 3 (the corner "
                         "closure reads an interior neighbour)")
    return consts


def kernel_mask(problem: Problem, solid=None, table=None) -> np.ndarray:
    """The uint8 mask the kernels read: SOLID_BIT on the solid cells of
    `solid` (default the problem's; zeros without an obstacle), and under
    the Bouzidi obstacle LINK_BIT on the cells with a cut link in `table`
    (default the whole grid's link table; a shard's padded cut). The whole
    grid's mask is memoized on the Problem, as its link table is: every
    wrapper of a run reads it, and at 256³ its link bits scan the table."""
    if solid is None and table is None:
        cached = getattr(problem, "_kernel_mask", None)
        if cached is None:
            cached = _kernel_mask(problem, None, None)
            object.__setattr__(problem, "_kernel_mask", cached)  # frozen
        return cached
    return _kernel_mask(problem, solid, table)


def _kernel_mask(problem: Problem, solid, table) -> np.ndarray:
    if solid is None:
        solid = (np.zeros(problem.spatial_shape, bool)
                 if problem.solid is None else problem.solid)
    mask = np.asarray(solid).astype(np.uint8) * SOLID_BIT
    if problem.obstacle_bc == "bouzidi" and problem.solid is not None:
        from . import bouzidi
        if table is None:
            table = bouzidi.link_tables(problem)
        mask |= bouzidi.link_cells(table, problem.lattice.Q).astype(
            np.uint8) * LINK_BIT
    return mask


def _kernel_operands(problem: Problem, device, q: int = 9):
    """(device, constants, kernel mask, plain step or None, link table or
    None) for a wrapper of `problem` on `device` with a q-population
    kernel (kernel_constants). A problem without an obstacle takes a zero
    mask, which those domains' kernels do not read; the link table is the
    Bouzidi library's (ops/bouzidi.device_table: on the device once a
    Problem)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    consts = kernel_constants(problem, q)
    solid = torch.as_tensor(kernel_mask(problem), device=device)
    links = None
    if consts.variant & BOUZIDI:
        from .bouzidi import device_table
        links = device_table(problem, device)
    plain = (step_torch.make_step_rolled(problem, device)
             if device.type == "cpu" else None)
    return device, consts, solid, plain, links


def make_local_step_cuda(problem: Problem, device):
    """step(f, out) -> out: one timestep of `problem` through the kernel
    (CUDA) or its plain version (CPU), on states living on `device`."""
    _, consts, solid, plain, links = _kernel_operands(problem, device)

    def step(f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream(f, out, solid, consts, plain, links)

    return step


def make_local_step_cuda_blocked(problem: Problem, device, n_sub: int):
    """step(f, out) -> out: n_sub timesteps of `problem` in one launch of
    the N-step kernel (CUDA) or n_sub plain steps (CPU). The counterpart of
    make_local_step_pallasN (n_sub 3-8; 5-8 in the deep build) and
    make_local_step_pallas2 (n_sub 2); other depths raise
    NotImplementedError."""
    check_depth(n_sub)
    _, consts, solid, plain, links = _kernel_operands(problem, device)

    def step(f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream_blocked(f, out, solid, consts, n_sub, plain,
                                      links)

    return step


def make_local_step_cuda_3d(problem: Problem, device):
    """step(f, out) -> out: one D3Q19 or D3Q27 timestep of `problem`
    through the kernel (CUDA) or its plain version (CPU), on
    (Q, nz, ny, nx) states living on `device`. The counterpart of
    make_local_step_pallas3d and of make_local_step_pallas3d_tiled at
    n_sub=1, for the sphere in a duct (y and z walls, equilibrium inlet,
    zero-gradient outlet), the periodic duct and the periodic box (with
    3-D Kolmogorov's force)."""
    _, consts, solid, plain, links = _kernel_operands_3d(problem, device)

    def step(f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream_3d(f, out, solid, consts, plain, links)

    return step


def make_local_step_cuda_3d_blocked(problem: Problem, device, n_sub: int):
    """step(f, out) -> out: n_sub D3Q19 or D3Q27 timesteps of `problem` in
    one launch of the N-step kernel (CUDA) or n_sub plain steps (CPU). The
    counterpart of make_local_step_pallas3d_tiled at n_sub 2-8 (4-8 in the
    deep build), for the sphere in a duct, the periodic duct and the
    periodic box; other depths raise NotImplementedError."""
    check_depth_3d(n_sub)
    _, consts, solid, plain, links = _kernel_operands_3d(problem, device)

    def step(f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream_3d_blocked(f, out, solid, consts, n_sub, plain,
                                         links)

    return step


def _kernel_operands_3d(problem: Problem, device):
    return _kernel_operands(problem, device, q=19)
