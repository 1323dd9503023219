"""Simulation configuration: the port's copy of tpulbm/config.py.

The same SimulationParams fields, defaults, presets, JSON round trip and
CLI flags as tpulbm, so checkpoints and simulation_params.csv move between
the two packages unchanged (tests/test_torch_compat.py holds the copy to
the original). Derived quantities are tpulbm's (and its reference's):

    nu() = (tau - 0.5)/3
    reynolds() = U * (2*cylinder_radius*ny)/nu

`--backend pallas` (the default) selects the hand-written CUDA kernels
(ops/step_cuda.py, ops/step_thermal_cuda.py); `--backend jax` selects the
plain PyTorch step (ops/step_torch.py, ops/step_thermal.py). The names are
kept so both packages share one CLI.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class SimulationParams:
    """All run parameters. Frozen and hashable."""

    # Core physics/grid (defaults == reference LBMConfig.h:37-42)
    tau: float = 0.6
    inlet_velocity: float = 0.01333
    nx: int = 2048
    ny: int = 512
    nz: int = 0                      # 0 → 2-D; >0 → 3-D (D3Q19)
    num_timesteps: int = 120000
    output_frequency: int = 140

    # Cylinder geometry as fractions of the domain (LBMConfig.h:45-48)
    cylinder_x: float = 0.2
    cylinder_y: float = 0.5
    cylinder_radius: float = 0.05
    # spin rate of the cylinder surface (rad/timestep, +ccw); needs
    # obstacle_bc="bouzidi" (the only mode with moving-wall machinery)
    cylinder_omega: float = 0.0

    # VTK output (LBMConfig.h:51)
    vtk_start_step: int = 0

    # --- new capabilities (absent from the reference) ---
    problem: str = "cylinder"        # "cylinder" | "poiseuille" | "cavity" | "cylinder3d"
    obstacle_bc: str = "equilibrium"  # "equilibrium" (reference parity) |
    # "bounce_back" (full-way) | "bouzidi" (curved-wall interpolated)
    collision: str = "bgk"           # "bgk" (reference parity) | "trt" |
    # "mrt" | "regularized" | "kbc" (new: stable at low tau)
    trt_magic: float = 3.0 / 16.0    # TRT magic parameter Λ
    # MRT ghost-moment rate overrides as ((moment, rate), ...) pairs, e.g.
    # (("e", 1.5), ("qx", 1.2)). Row names per physics._mrt_basis; unset
    # moments use the measured-stable defaults (physics._MRT_GHOST_RATES).
    mrt_rates: tuple[tuple[str, float], ...] = ()
    # Smagorinsky LES constant Cs (0 = off; typical 0.1-0.2). BGK-only:
    # per-cell tau_eff from the non-equilibrium stress (physics.
    # smagorinsky_inv_tau) — adds eddy viscosity where the flow is
    # under-resolved, stabilizing high-Re runs the reference cannot reach.
    smagorinsky: float = 0.0
    # Non-Newtonian power-law (Ostwald-de Waele) rheology (new capability —
    # the reference is strictly Newtonian): apparent viscosity
    # nu(γ̇) = k γ̇^(n-1). n = 1 is Newtonian (off); n < 1 shear-thinning
    # (blood, polymer melts), n > 1 shear-thickening. power_law_k = 0
    # derives the consistency index from tau: k = (tau - 1/2)/3, i.e. the
    # apparent viscosity at unit shear rate equals the Newtonian one.
    # BGK-only; per-cell tau_eff via physics.power_law_inv_tau.
    power_law_n: float = 1.0
    power_law_k: float = 0.0
    # 3-D velocity set: "d3q19" (default, the bandwidth-optimal standard)
    # or "d3q27" (full fourth-order-isotropic set — better rotational
    # isotropy for high-fidelity turbulence at ~1.4x the state size).
    lattice3d: str = "d3q19"
    # Shan-Chen multiphase (the "multiphase" problem; new capability): the
    # pseudopotential interaction strength g (g < -4 separates phases for
    # the standard psi with rho0 = 1; 0 = off) and the initial
    # liquid/vapor densities (both relax to the EOS coexistence values).
    shan_chen_g: float = 0.0
    mp_rho_liquid: float = 2.0
    mp_rho_vapor: float = 0.15
    # Wall wettability: the phantom fluid density the psi stencil reads
    # beyond the y walls (0 = neutral rho=1). Higher values attract the
    # liquid (wetting, contact angle < 90 deg), lower repel it — the
    # standard pseudopotential contact-angle control (Benzi et al. 2006).
    mp_wall_rho: float = 0.0
    # Thermal (double-population) coupling — the rayleigh-benard problem.
    # thermal_tau sets the diffusivity alpha = (thermal_tau - 1/2)/3;
    # rayleigh (if > 0) derives the Boussinesq buoyancy from
    # Ra = buoyancy·ΔT·H³/(nu·alpha); buoyancy overrides it directly.
    thermal_tau: float = 0.0         # 0 = no thermal scalar
    t_hot: float = 1.0               # bottom-wall temperature
    t_cold: float = 0.0              # top-wall temperature
    rayleigh: float = 0.0
    buoyancy: float = 0.0
    body_force: tuple[float, ...] = ()  # Guo-style forcing (ref dead code LBMUtils.h:15-19)
    periodic_x: bool = False         # poiseuille channel uses periodic x
    precision: str = "f32"           # "f32" (the kernels) | "f64" (validation)
    backend: str = "pallas"          # "pallas" (CUDA kernels) | "jax" (plain step)
    mesh_shape: tuple[int, int] = (1, 1)  # (devices along y, devices along x)
    checkpoint_every: int = 0        # chunks between checkpoints; 0 = off
    checkpoint_dir: str = "checkpoints"
    output_dir: str = "."
    enable_vtk: bool = True
    vtk_format: str = "ascii"        # "ascii" (reference byte parity) | "binary" (4x smaller)
    # Velocity/density point probes: ((x_frac, y_frac[, z_frac]), ...) as
    # domain fractions (like cylinder_x/y). Each output interval the
    # runner records rho and u at these cells to probes.csv — the
    # standard way to extract shedding frequencies from a wake signal
    # without dumping fields. () = off.
    probe_points: tuple = ()
    # Reynolds statistics: accumulate time-averaged mean fields and
    # Reynolds stresses <u_i'u_j'> on device, sampling the state at every
    # output interval with t >= stats_from (the usual "discard the
    # transient" control). -1 = off. Results land in stats_fields.npz
    # (mean_rho, mean_u*, reynolds stress components, sample count).
    # New capability — the reference has no flow statistics.
    stats_from: int = -1
    # Kolmogorov forcing wavenumber (problem="kolmogorov"): the body force
    # F_x(y) = F0·cos(2π·n·y/ny) drives n shear bands across the periodic
    # box; F0 is derived so the laminar fixed point peaks at
    # inlet_velocity (models/periodic2d.py). Kolmogorov Re = u0/(ν·κ).
    kolmogorov_n: int = 4
    # Zou-He corner treatment at the 4 wall-inlet/outlet cells:
    # "reference" composes the sequential edge updates exactly as the
    # reference does; "clean" applies the Zou & He (1997) corner-node
    # closure (u = v = 0, density residual split) on every backend
    zou_he_corners: str = "reference"

    # ---- derived quantities (parity with LBMConfig.h:53-65) ----
    def nu(self) -> float:
        return (self.tau - 0.5) / 3.0

    def reynolds(self) -> float:
        if self.problem == "cavity":
            # lid-driven cavity: Re = U_lid (nx-1) / nu (models/cavity.py;
            # the wall BC pins u at the boundary nodes, so the side length
            # is nx-1 cells)
            return self.inlet_velocity * (self.nx - 1) / self.nu()
        D = 2.0 * self.cylinder_radius * self.ny
        return (self.inlet_velocity * D) / self.nu()

    def power_law(self) -> tuple[float, float] | None:
        """(k, n) for the power-law rheology, or None when Newtonian.
        k = 0 derives the consistency index from tau (nu at unit shear)."""
        if self.power_law_n == 1.0:
            return None
        k = self.power_law_k if self.power_law_k else self.nu()
        return (k, self.power_law_n)

    def get_cylinder_x(self) -> int:
        return int(self.cylinder_x * self.nx)

    def get_cylinder_y(self) -> int:
        return int(self.cylinder_y * self.ny)

    def get_cylinder_radius_cells(self) -> int:
        return int(self.cylinder_radius * self.ny)

    @property
    def is_3d(self) -> bool:
        return self.nz > 0

    @property
    def num_cells(self) -> int:
        return self.nx * self.ny * (self.nz if self.is_3d else 1)

    # ---- serialization ----
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SimulationParams":
        d = dict(d)
        for key in ("body_force", "mesh_shape"):
            if key in d and isinstance(d[key], list):
                d[key] = tuple(d[key])
        if isinstance(d.get("mrt_rates"), (list, dict)):
            items = d["mrt_rates"].items() if isinstance(d["mrt_rates"], dict) \
                else d["mrt_rates"]
            d["mrt_rates"] = tuple((str(k), float(v)) for k, v in items)
        if isinstance(d.get("probe_points"), list):
            d["probe_points"] = tuple(tuple(float(v) for v in pt)
                                      for pt in d["probe_points"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "SimulationParams":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "SimulationParams":
        return dataclasses.replace(self, **kw)


def tau_for_reynolds(re: float, inlet_velocity: float, ny: int,
                     cylinder_radius: float = 0.05) -> float:
    """tau that yields the requested Reynolds number on this grid (inverts
    reference LBMConfig.h:54-58)."""
    D = 2.0 * cylinder_radius * ny
    nu = inlet_velocity * D / re
    return 3.0 * nu + 0.5


# ---- named presets (BASELINE.json configs) ----

def _presets() -> dict[str, SimulationParams]:
    base = SimulationParams()
    return {
        # Reference compile-time defaults: 2048x512, tau=0.6 → Re ≈ 20.5.
        "reference-default": base,
        # Quick steady-wake run at modest Re on a small grid (BASELINE config 1).
        "cylinder-small": base.replace(nx=512, ny=128, num_timesteps=8000,
                                       output_frequency=140),
        # Re=200 von Kármán vortex street (BASELINE config 3).
        # NOTE: at the reference's U=0.01333 this Reynolds number needs
        # tau=0.51024, where BGK blows up — VERIFIED on the compiled
        # reference itself (validation/ref_driver: unstable at t=74). We
        # reach Re=200 at U=0.05 → tau=0.5384 instead (Ma≈0.09, stable for
        # both solvers); the reference's README claim of Re=200 results
        # must have used parameters outside this snapshot.
        "re200": base.replace(inlet_velocity=0.05,
                              tau=tau_for_reynolds(200.0, 0.05, base.ny)),
        # Re=100 / Re=50 variants (reference README.md:57-59 result set).
        "re100": base.replace(inlet_velocity=0.05,
                              tau=tau_for_reynolds(100.0, 0.05, base.ny)),
        "re50": base.replace(inlet_velocity=0.05,
                             tau=tau_for_reynolds(50.0, 0.05, base.ny)),
        # Poiseuille channel validation (BASELINE config 2): body-force driven,
        # periodic in x, walls in y; analytic parabola check in tests.
        "poiseuille": base.replace(
            problem="poiseuille", nx=64, ny=64, tau=0.8,
            inlet_velocity=0.0, periodic_x=True,
            body_force=(1e-5, 0.0), num_timesteps=20000,
            output_frequency=1000, cylinder_radius=0.0, enable_vtk=False),
        # Lid-driven square cavity at Re=100 (Ghia, Ghia & Shin 1982
        # benchmark; models/cavity.py). inlet_velocity is the lid speed;
        # tau = 3 U (nx-1)/Re + 1/2.
        "cavity": base.replace(
            problem="cavity", nx=128, ny=128, tau=0.881, inlet_velocity=0.1,
            num_timesteps=40000, output_frequency=2000, cylinder_radius=0.0,
            enable_vtk=False),
        # Rayleigh-Bénard convection at Ra=10^4, Pr≈0.71 (air): hot plate
        # below, cold above, periodic x. Buoyancy derived from --rayleigh
        # (models/rayleigh_benard.py); Nu ≈ 2.65 expected at this Ra.
        "rayleigh-benard": base.replace(
            problem="rayleigh-benard", nx=128, ny=64, tau=0.55,
            thermal_tau=0.5704, rayleigh=1e4, inlet_velocity=0.0,
            periodic_x=True, cylinder_radius=0.0, num_timesteps=60000,
            output_frequency=2000, enable_vtk=False),
        # de Vahl Davis (1983) differentially heated square cavity at
        # Ra=10^4, Pr≈0.71 (rotated frame: hot/cold Dirichlet walls in y,
        # adiabatic no-slip walls in x, gravity along -x); benchmark
        # Nu = 2.243.
        "heated-cavity": base.replace(
            problem="heated-cavity", nx=96, ny=96, tau=0.55,
            thermal_tau=0.5704, rayleigh=1e4, inlet_velocity=0.0,
            periodic_x=False, cylinder_radius=0.0, num_timesteps=120000,
            output_frequency=2000, enable_vtk=False),
        # Multi-million-cell sharded scaling config (BASELINE config 4).
        "scale-8m": base.replace(nx=4096, ny=2048, num_timesteps=2000,
                                 output_frequency=500),
        # 3-D D3Q19 cylinder/sphere flow (BASELINE config 5, stretch).
        "cylinder3d-small": base.replace(problem="cylinder3d", nx=128, ny=64, nz=64,
                                         num_timesteps=2000, output_frequency=200),
        # Decaying Taylor-Green vortex: exact NS solution (viscosity gate).
        "taylor-green": base.replace(
            problem="taylor-green", nx=256, ny=256, tau=0.8,
            inlet_velocity=0.04, periodic_x=True, cylinder_radius=0.0,
            num_timesteps=20000, output_frequency=1000, enable_vtk=False),
        # Minion-Brown double shear layer at Re=30k on 128²: the collision
        # -operator stability benchmark (BGK diverges; regularized runs).
        "shear-layer": base.replace(
            problem="shear-layer", nx=128, ny=128,
            tau=0.5 + 3.0 * (0.04 * 128.0 / 30000.0),
            inlet_velocity=0.04, periodic_x=True, cylinder_radius=0.0,
            collision="regularized",
            num_timesteps=12000, output_frequency=1000, enable_vtk=False),
        # Forced 2-D Kolmogorov flow at Re = u0/(ν·κ) ≈ 40, far past the
        # n=4 band-instability threshold (Re_c ≈ 1.6 measured,
        # scripts/kolmogorov_threshold.py): the bands break up and the
        # 2-D inverse cascade condenses the energy into the gravest box
        # mode (~95% in shell k=κ0 by t=40k — docs/validation). Reynolds
        # statistics sample the condensate after spin-up; spectra via
        # scripts/spectra.py.
        "kolmogorov": base.replace(
            problem="kolmogorov", nx=256, ny=256, kolmogorov_n=4,
            tau=0.5 + 3.0 * (0.05 / (40.0 * 2.0 * 3.141592653589793
                                     * 4.0 / 256.0)),
            inlet_velocity=0.05, periodic_x=True, cylinder_radius=0.0,
            num_timesteps=40000, output_frequency=200, stats_from=20000,
            enable_vtk=False),
        # Forced 3-D box turbulence: F_x(z) = F0·cos(κz), n=2 on 128³ at
        # Re = u0/(ν·κ) ≈ 20 — n must be ≥ 2 so a transverse mode with
        # q < κ exists (n=1 in a cube has none and stays laminar; same
        # geometry constraint as 2-D). Sustained cascade toward k^-5/3
        # (scripts/spectra.py on fields3d.npz / the stats means).
        "kolmogorov3d": base.replace(
            problem="kolmogorov", nx=128, ny=128, nz=128, kolmogorov_n=2,
            tau=0.5 + 3.0 * (0.05 / (20.0 * 2.0 * 3.141592653589793
                                     * 2.0 / 128.0)),
            inlet_velocity=0.05, periodic_x=True, cylinder_radius=0.0,
            num_timesteps=30000, output_frequency=500, stats_from=15000,
            enable_vtk=False),
    }


PRESETS = _presets()


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", choices=sorted(PRESETS), default=None,
                        help="named parameter preset")
    parser.add_argument("--config-json", type=str, default=None,
                        help="path to a JSON file with SimulationParams fields")
    # individual overrides
    for field in ("tau", "inlet_velocity", "cylinder_x", "cylinder_y",
                  "cylinder_radius", "cylinder_omega", "smagorinsky", "power_law_n",
                  "power_law_k", "shan_chen_g", "mp_rho_liquid",
                  "mp_rho_vapor", "mp_wall_rho", "thermal_tau", "t_hot",
                  "t_cold", "rayleigh", "buoyancy"):
        parser.add_argument(f"--{field.replace('_', '-')}", type=float, default=None)
    for field in ("nx", "ny", "nz", "num_timesteps", "output_frequency",
                  "vtk_start_step", "checkpoint_every", "stats_from",
                  "kolmogorov_n"):
        parser.add_argument(f"--{field.replace('_', '-')}", type=int, default=None)
    parser.add_argument("--reynolds", type=float, default=None,
                        help="set tau to achieve this Reynolds number")
    parser.add_argument("--problem", choices=["cylinder", "poiseuille",
                                              "cavity", "rayleigh-benard",
                                              "heated-cavity",
                                              "cylinder3d", "multiphase",
                                              "taylor-green", "shear-layer",
                                              "kolmogorov",
                                              "passive-scalar"],
                        default=None)
    parser.add_argument("--obstacle-bc",
                        choices=["equilibrium", "bounce_back", "bouzidi"],
                        default=None)
    parser.add_argument("--collision",
                        choices=["bgk", "trt", "mrt", "regularized", "kbc"],
                        default=None)
    parser.add_argument("--lattice3d", choices=["d3q19", "d3q27"],
                        default=None,
                        help="3-D velocity set (d3q27: full isotropic set)")
    parser.add_argument("--mrt-rates", type=str, default=None,
                        help="MRT ghost-moment rate overrides, e.g. "
                             "'e=1.64,qx=1.2' (moment names per "
                             "physics._mrt_basis)")
    parser.add_argument("--precision", choices=["f32", "f64"], default=None)
    parser.add_argument("--backend", choices=["pallas", "jax"], default=None)
    parser.add_argument("--mesh", type=str, default=None,
                        help="device mesh as 'NYxNX', e.g. 2x4; 'auto' to choose")
    parser.add_argument("--output-dir", type=str, default=None)
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--no-vtk", action="store_true")
    parser.add_argument("--zou-he-corners",
                        choices=["reference", "clean"], default=None,
                        help="corner-cell treatment (clean = Zou-He 1997 corner closure)")
    parser.add_argument("--probe", type=str, default=None,
                        help="point probes as domain fractions, e.g. "
                             "'0.3,0.5;0.8,0.5' — rho/u recorded per "
                             "output interval to probes.csv")
    parser.add_argument("--vtk-format", choices=["ascii", "binary"],
                        default=None,
                        help="legacy VTK encoding: ascii is byte-compatible "
                             "with the reference; binary is ~4x smaller/faster")


def params_from_args(args: argparse.Namespace) -> SimulationParams:
    if args.config_json:
        with open(args.config_json) as fh:
            params = SimulationParams.from_json(fh.read())
    elif args.preset:
        params = PRESETS[args.preset]
    else:
        params = SimulationParams()

    overrides: dict[str, Any] = {}
    for field in ("tau", "inlet_velocity", "cylinder_x", "cylinder_y",
                  "cylinder_radius", "cylinder_omega", "smagorinsky", "power_law_n",
                  "power_law_k", "shan_chen_g", "mp_rho_liquid",
                  "mp_rho_vapor", "mp_wall_rho", "thermal_tau", "t_hot",
                  "t_cold", "rayleigh", "buoyancy", "nx", "ny", "nz",
                  "num_timesteps",
                  "output_frequency", "vtk_start_step", "checkpoint_every",
                  "stats_from", "kolmogorov_n",
                  "problem", "precision", "backend", "output_dir",
                  "checkpoint_dir", "vtk_format", "zou_he_corners",
                  "lattice3d"):
        val = getattr(args, field, None)
        if val is not None:
            overrides[field] = val
    if getattr(args, "obstacle_bc", None) is not None:
        overrides["obstacle_bc"] = args.obstacle_bc
    if getattr(args, "collision", None) is not None:
        overrides["collision"] = args.collision
    if getattr(args, "mrt_rates", None):
        pairs = []
        for item in args.mrt_rates.split(","):
            name, _, val = item.partition("=")
            if not val:
                raise ValueError(
                    f"--mrt-rates entries must be name=value, got {item!r}")
            pairs.append((name.strip(), float(val)))
        overrides["mrt_rates"] = tuple(pairs)
    if getattr(args, "probe", None):
        overrides["probe_points"] = tuple(
            tuple(float(v) for v in pt.split(","))
            for pt in args.probe.split(";") if pt.strip())
    if args.no_vtk:
        overrides["enable_vtk"] = False
    params = params.replace(**overrides)
    if args.reynolds is not None:
        params = params.replace(tau=tau_for_reynolds(
            args.reynolds, params.inlet_velocity, params.ny, params.cylinder_radius))
    if args.mesh and args.mesh != "auto":
        my, mx = args.mesh.lower().split("x")
        params = params.replace(mesh_shape=(int(my), int(mx)))
    validate_params(params)
    return params


def check_collision(params: SimulationParams) -> None:
    """Reject the collision combinations tpulbm refuses: KBC in 3-D; MRT
    on D3Q27; a thermal problem (a thermal_tau, or a thermal problem name)
    under anything but BGK, with or without the Smagorinsky closure; the
    closure
    or the power law off BGK, or both at once; the power law with a
    thermal scalar; multiphase under anything but plain BGK.
    validate_params and the problem builders (models.check_slice) both
    call it."""
    thermal = bool(params.thermal_tau) or params.problem in (
        "rayleigh-benard", "heated-cavity")
    if params.is_3d and params.lattice3d == "d3q27" \
            and params.collision == "mrt":
        raise ValueError(
            "MRT is implemented for D2Q9/D3Q19 only (physics._mrt_basis); "
            "use bgk or trt with lattice3d='d3q27'")
    if params.collision == "kbc" and params.is_3d:
        raise ValueError(
            "the KBC entropic operator is implemented for D2Q9 (2-D) "
            "only; use collision='regularized' for stabilized 3-D runs")
    if thermal and params.collision != "bgk":
        raise ValueError(
            "thermal (double-population) problems implement collision="
            f"'bgk' (+ --smagorinsky) only, got {params.collision!r}; "
            "the scalar coupling is not wired into the other operators")
    if params.smagorinsky and params.collision != "bgk":
        raise ValueError(
            "the Smagorinsky closure is implemented for collision="
            f"'bgk' only (got {params.collision!r}); TRT/MRT would "
            "need their own per-cell rate plumbing")
    if params.power_law_n != 1.0:
        if params.collision != "bgk":
            raise ValueError(
                "power-law rheology is implemented for collision='bgk' "
                f"only (got {params.collision!r})")
        if params.smagorinsky:
            raise ValueError(
                "power-law rheology and the Smagorinsky closure both set "
                "a per-cell relaxation rate; enable at most one")
        if thermal:
            raise ValueError(
                "power-law rheology is not wired into the thermal "
                "(rayleigh-benard) kernels")
    if params.problem == "multiphase" and (
            params.collision != "bgk" or params.smagorinsky
            or params.power_law_n != 1.0 or params.thermal_tau):
        raise ValueError(
            "multiphase v1 is BGK-only (no TRT/MRT/LES/power-law/"
            "thermal combination)")


def validate_params(params: SimulationParams) -> None:
    """Reject option combinations that would silently no-op.

    The Zou-He corner closure is only implemented for the 2-D cylinder
    problem (models/cylinder.py wires it into Problem.clean_corners;
    boundaries.apply_all additionally gates on lattice D == 2) — accepting
    the explicit opt-in for poiseuille/cylinder3d and doing nothing would
    be a silent lie."""
    if params.zou_he_corners == "clean" and params.problem != "cylinder":
        raise ValueError(
            f"--zou-he-corners clean is only implemented for the 2-D "
            f"cylinder problem, not {params.problem!r}")
    if params.cylinder_omega:
        if params.obstacle_bc != "bouzidi":
            raise ValueError(
                "--cylinder-omega needs --obstacle-bc bouzidi (the voxel "
                "modes have no moving-wall machinery)")
        if params.problem != "cylinder":
            raise ValueError(
                f"--cylinder-omega only applies to the 2-D cylinder "
                f"problem, not {params.problem!r}")
    if params.mrt_rates and params.collision != "mrt":
        raise ValueError(
            "--mrt-rates only applies to collision='mrt', not "
            f"{params.collision!r}")
    if params.smagorinsky < 0:
        raise ValueError(
            f"smagorinsky (Cs) must be >= 0, got {params.smagorinsky}")
    if params.power_law_n <= 0:
        raise ValueError(
            f"power_law_n must be > 0, got {params.power_law_n}")
    check_collision(params)
    if params.power_law_k < 0:
        raise ValueError(
            f"power_law_k must be >= 0, got {params.power_law_k}")
    if params.power_law_k and params.power_law_n == 1.0:
        raise ValueError(
            "power_law_k is set but power_law_n == 1 (Newtonian), so it "
            "would be silently ignored; set power_law_n != 1 or drop "
            "power_law_k (viscosity comes from tau)")
    if params.problem == "multiphase":
        if not params.shan_chen_g:
            raise ValueError("the multiphase problem needs --shan-chen-g "
                             "(g < -4 separates phases)")
    elif params.shan_chen_g:
        raise ValueError(
            f"shan_chen_g only applies to problem='multiphase', not "
            f"{params.problem!r}")
    if params.problem != "multiphase" and (
            params.mp_wall_rho or params.mp_rho_liquid != 2.0
            or params.mp_rho_vapor != 0.15):
        raise ValueError(
            "mp_wall_rho/mp_rho_liquid/mp_rho_vapor only apply to "
            f"problem='multiphase', not {params.problem!r}")
    if params.lattice3d != "d3q19" and not params.is_3d:
        raise ValueError(
            f"lattice3d={params.lattice3d!r} only applies to 3-D problems "
            "(nz > 0); it would be silently ignored here")
    if params.lattice3d not in ("d3q19", "d3q27"):
        raise ValueError(
            f"lattice3d must be 'd3q19' or 'd3q27', got {params.lattice3d!r}")
    if params.stats_from < -1:
        raise ValueError(
            f"stats_from must be -1 (off) or a start timestep >= 0, got "
            f"{params.stats_from}")
    if params.stats_from >= params.num_timesteps:
        raise ValueError(
            f"stats_from={params.stats_from} is beyond num_timesteps="
            f"{params.num_timesteps}; no samples would ever be taken")
    if params.kolmogorov_n < 1:
        raise ValueError(
            f"kolmogorov_n must be a positive forcing wavenumber, got "
            f"{params.kolmogorov_n}")
