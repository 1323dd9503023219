"""Problem definition: lattice + geometry + boundary-condition layout.

Port of tpulbm/models/base.py for the slices the port covers (uniform
equilibrium start, optional solid mask; the boundary layouts of the 2-D
cylinder, the body-forced channel, the lid-driven cavity, the 3-D sphere
in a duct and the 3-D duct, with the obstacle's analytic surface and wall
velocity for the Bouzidi rule; the thermal double-population problems; the
Shan-Chen multiphase channel's rho-map start; the fully periodic 2-D boxes'
equilibrium at an analytic (rho, u) field, the passive scalar's analytic
T field and Kolmogorov's force profile). The initial state and the ghost
values are computed in NumPy on the host, exactly as tpulbm does, so both
packages start from byte-identical arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..config import SimulationParams
from ..lattice import Lattice
from .. import physics


@dataclasses.dataclass(frozen=True)
class ThermalConfig:
    """Double-population thermal coupling (Boussinesq). A second lattice
    (D2Q5) carries temperature as a scalar advected by the flow; the flow
    feels the buoyancy force buoyancy · (T − t_ref) along buoyancy_axis.

    State layout: the scalar populations g are stacked under the flow
    populations f in one (Q_f + Q_g, ny, nx) array; only the collision and
    the wall rules treat the two plane groups differently.
    """
    lattice: Lattice          # the scalar's lattice (D2Q5)
    tau_g: float              # thermal relaxation time; alpha = (tau_g-1/2)/3
    t_bottom: float = 1.0     # fixed wall temperatures (hot plate below)
    t_top: float = 0.0
    buoyancy: float = 0.0     # beta·g product (Boussinesq)
    perturb: float = 1e-3     # seed-mode amplitude (×ΔT) of the initial T
    # 1 = +y (Rayleigh-Bénard: gravity opposes the wall gradient); 0 = +x
    # (the side-heated cavity, rotated so that its hot and cold walls are
    # the y walls and its adiabatic walls the x walls)
    buoyancy_axis: int = 1

    @property
    def t_ref(self) -> float:
        return 0.5 * (self.t_bottom + self.t_top)

    @property
    def alpha(self) -> float:
        """Thermal diffusivity in lattice units."""
        return (self.tau_g - 0.5) / 3.0


_AXES = ("x", "y", "z")


@dataclasses.dataclass(frozen=True)
class ForceProfile:
    """A body force that varies along one axis: the port's form of tpulbm's
    Problem.force_fn, which a CUDA kernel cannot trace. `fn` maps the
    global coordinates along `axis` ("x" or "y" in 2-D, "z" in 3-D:
    Kolmogorov's F_x(y), 3-D Kolmogorov's F_x(z)), a 1-D tensor in the
    state's dtype, to the force's components (Fx, Fy[, Fz]), each a tensor
    of that shape or a float. Each cell, halo and window cells included,
    takes the force at the coordinate of the cell that owns it (taken
    mod the extent), so a shard or an N-step launch adds the bits one
    device adds. Every force_fn of tpulbm depends on one coordinate;
    a force of several raises."""
    axis: str
    fn: Callable

    def __post_init__(self):
        if self.axis not in _AXES:
            raise NotImplementedError(
                f"a force varying along {self.axis!r}: the port's forces "
                "vary along one axis, 'x', 'y' or 'z' (the kernels read one "
                "table per coordinate)")

    @property
    def index(self) -> int:
        """The axis as the kernels number it: 0 for x, 1 for y, 2 for z."""
        return _AXES.index(self.axis)

    def table(self, lattice: Lattice, n: int, dtype: torch.dtype,
              device) -> torch.Tensor:
        """(Q, n) source S_i(c) = 3 w_i (c_i·F(c)) at the coordinates
        c = 0 .. n-1, in `dtype`: tpulbm's _add_force_field arithmetic
        (step_jax.py:77-98), evaluated once per coordinate."""
        coord = torch.arange(n, dtype=dtype, device=device)
        comps = [torch.broadcast_to(torch.as_tensor(v, dtype=dtype,
                                                    device=device), (n,))
                 for v in self.fn(coord)]
        cu = torch.as_tensor(lattice.c, dtype=dtype, device=device) @ \
            torch.stack(comps)
        w = torch.as_tensor(3.0 * lattice.w, dtype=dtype, device=device)
        return w[:, None] * cu


@dataclasses.dataclass(frozen=True)
class Problem:
    """Static description of one simulation setup. `solid` is a host bool
    (*spatial) mask in ([z,] y, x) order, True on solid cells, or None."""

    params: SimulationParams
    lattice: Lattice
    solid: np.ndarray | None
    init_rho: float = 1.0
    init_u: tuple[float, ...] = (0.0, 0.0)
    inlet_zou_he: bool = False        # Zou-He velocity inlet at x = 0
    outlet_zou_he: bool = False       # Zou-He pressure outlet at x = nx-1
    inlet_equilibrium: bool = False   # equilibrium inlet at x = 0 (3-D)
    outlet_zero_grad: bool = False    # zero-gradient outlet at x = nx-1 (3-D)
    walls_y: bool = True              # bounce-back walls at y = 0 and ny-1
    walls_z: bool = False             # bounce-back walls at z = 0 and nz-1
    walls_x: bool = False             # bounce-back walls at x = 0 and nx-1
    lid_u: float = 0.0                # moving-lid speed (+x) at the top wall
    closed_box: bool = False          # no open BCs: the Runner pins the mass
    periodic_x: bool = False
    periodic_y: bool = False          # fully periodic box (walls_y off)
    periodic_z: bool = False          # the 3-D box: z wraps (walls_z off)
    body_force: tuple[float, ...] = ()  # uniform force, added after collision
    # a force varying along one axis (Kolmogorov), added after the
    # collision and the uniform force's source
    force_profile: ForceProfile | None = None
    # "equilibrium" (solids pinned to rest equilibrium), "bounce_back"
    # (solids skip the collision and store their streamed populations
    # reversed) or "bouzidi" (curved-wall interpolation on the cut links,
    # ops/bouzidi.py, then the equilibrium pin)
    obstacle_bc: str = "equilibrium"
    # analytic signed distance to the obstacle surface (positive in fluid),
    # pts (..., D) in (x, y[, z]) order -> (...,), a NumPy callable; the
    # "bouzidi" rule needs it (ops/bouzidi.py), the others ignore it
    obstacle_sdf: object = None
    # the wall velocity of a MOVING obstacle (the spinning cylinder):
    # pts (..., D) -> u (..., D), NumPy; "bouzidi" only
    obstacle_velocity: object = None
    # "bgk" | "trt" | "mrt" | "regularized" | "kbc" (physics.collide_*)
    collision: str = "bgk"
    clean_corners: bool = False       # Zou-He corner closure (2-D; opt-in)
    trt_magic: float = 3.0 / 16.0
    mrt_rates: tuple = ()             # ((moment, rate), ...) ghost overrides
    smagorinsky: float = 0.0          # LES Cs (physics.smagorinsky_inv_tau)
    power_law: tuple = ()             # (k, n) (physics.power_law_inv_tau)
    thermal: ThermalConfig | None = None  # double-population thermal coupling
    shan_chen: tuple = ()             # (g, rho0): Shan-Chen multiphase
    init_rho_map: np.ndarray | None = None  # initial rho per cell (u = 0)
    # (rho (*spatial), u (D, *spatial)): an equilibrium start at an
    # analytic field (the periodic boxes); overrides init_rho and init_u
    init_fields: tuple | None = None
    # the scalar's start T (*spatial) with init_fields (the passive
    # scalar); None: uniform t_ref
    init_T: object = None

    @property
    def state_q(self) -> int:
        """Leading (plane) extent of the state: Q_f, plus Q_g when a
        thermal scalar is stacked underneath."""
        return self.lattice.Q + (self.thermal.lattice.Q if self.thermal
                                 else 0)

    @property
    def spatial_shape(self) -> tuple[int, ...]:
        p = self.params
        return (p.nz, p.ny, p.nx) if p.is_3d else (p.ny, p.nx)

    @property
    def dtype(self):
        return np.float64 if self.params.precision == "f64" else np.float32

    def ghost_ring_values(self) -> np.ndarray:
        """(state_q,) values held by out-of-domain ghost cells:
        equilibrium(rho=1, u=init_u), frozen for the whole run (the
        reference never updates its physical-edge ghosts). Thermal
        problems append w_g · t_ref for the scalar planes (the thermal
        steps read their own per-wall ghost rows instead)."""
        ring = physics.uniform_equilibrium(
            self.lattice, self.init_rho, self.init_u, dtype=self.dtype)
        if self.thermal is not None:
            ring = np.concatenate(
                [ring, (self.thermal.lattice.w
                        * self.thermal.t_ref).astype(self.dtype)])
        return ring

    def initial_state(self) -> np.ndarray:
        """(state_q, *spatial) initial populations: uniform
        equilibrium(1, init_u), solid cells at rest equilibrium. Thermal
        problems stack the scalar's equilibrium underneath, at the
        conductive profile plus a cos·sin seed mode. A rho map (the
        multiphase droplet or band) starts at feq_i = w_i rho(x), u = 0.
        init_fields starts at the equilibrium of an analytic (rho, u), the
        scalar (if any) at w_i T (1 + 3 c_i·u) with T = init_T."""
        Q = self.lattice.Q
        if self.init_fields is not None:
            return self._state_from_fields()
        if self.init_rho_map is not None:
            w = self.lattice.w.astype(self.dtype)
            f = (w.reshape((Q,) + (1,) * len(self.spatial_shape))
                 * np.asarray(self.init_rho_map, self.dtype)[None])
            return np.ascontiguousarray(f)
        feq = self.ghost_ring_values()[:Q]
        f = np.broadcast_to(
            feq.reshape((Q,) + (1,) * len(self.spatial_shape)),
            (Q,) + self.spatial_shape).copy()
        if self.solid is not None:
            rest = physics.rest_equilibrium(self.lattice, self.dtype)
            f[:, self.solid] = rest[:, None]
        if self.thermal is None:
            return f
        th = self.thermal
        ny, nx = self.spatial_shape
        # conductive profile between the wall nodes (height ny-1 cells),
        # seeded with one cos(kx)·sin(pi y/H) mode at amplitude
        # perturb·ΔT so that the onset is deterministic
        y = np.arange(ny, dtype=np.float64)[:, None] / max(ny - 1, 1)
        x = np.arange(nx, dtype=np.float64)[None, :]
        dt_wall = th.t_bottom - th.t_top
        T = th.t_bottom - dt_wall * y
        T = T + th.perturb * dt_wall * np.cos(2.0 * np.pi * x / nx) \
            * np.sin(np.pi * y)
        lg = th.lattice
        g = (lg.w.reshape((lg.Q, 1, 1)) * T[None]).astype(self.dtype)
        return np.concatenate([f, g], axis=0)

    def _state_from_fields(self) -> np.ndarray:
        """fields_state on the host, as a NumPy array."""
        return self.fields_state("cpu").numpy()

    def fields_state(self, device):
        """tpulbm's init_fields start (base.py:154-190) as a tensor on
        `device`, in float64 and rounded once: f_i = w_i rho (1 + 3 c·u +
        4.5 (c·u)² - 1.5 u²), and under it the scalar g_i = w_i T (1 + 3
        c_i·u). One population at a time, each element's operations in
        tpulbm's order (u² and c·u summed component by component), each an
        elementwise float64 operation rounded once on any device, so the
        card's state has the host's bits: the whole (Q, *spatial) float64
        temporaries in NumPy took seconds at 256³, PyTorch's CPU threads
        still seconds there."""
        import torch
        rho0, u0 = (torch.from_numpy(np.asarray(a, np.float64)).to(device)
                    for a in self.init_fields)
        u2 = u0[0] * u0[0]
        for a in range(1, u0.shape[0]):
            u2 = u2 + u0[a] * u0[a]
        rows = [(float(self.lattice.w[i]), self.lattice.c[i], rho0,
                 lambda cu: 1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * u2)
                for i in range(self.lattice.Q)]
        if self.thermal is not None:
            lg = self.thermal.lattice
            T = (torch.full(self.spatial_shape, self.thermal.t_ref,
                            dtype=torch.float64, device=u0.device)
                 if self.init_T is None
                 else torch.from_numpy(np.asarray(self.init_T, np.float64))
                 .to(device))
            rows += [(float(lg.w[j]), lg.c[j], T, lambda cu: 1.0 + 3.0 * cu)
                     for j in range(lg.Q)]
        dt = torch.float64 if self.dtype == np.float64 else torch.float32
        out = torch.empty((len(rows),) + tuple(u2.shape), dtype=dt,
                          device=u0.device)
        for k, (w, c, scale, bracket) in enumerate(rows):
            # c·u as tpulbm's tensordot sums it: component by component
            cu = float(c[0]) * u0[0]
            for a in range(1, len(c)):
                cu = cu + float(c[a]) * u0[a]
            out[k] = (w * scale * bracket(cu)).to(dt)
        return out
