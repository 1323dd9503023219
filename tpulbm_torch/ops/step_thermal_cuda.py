"""The fused thermal collide-stream step as a hand-written CUDA kernel.

Port of tpulbm/ops/step_thermal_pallas.py::make_local_step_thermal_pallas
(one step per launch): csrc/step_thermal.cu, built
once for BGK and once for its Smagorinsky LES branch (MODES,
-DTPULBM_COLLISION=5), and each of those once more for a shard of a mesh
(-DTPULBM_RINGS=1, collide_stream_thermal_rings: the block and its
one-cell rings, the Pallas kernel's rb/rt, flags and x_halo rl/rr). Rayleigh-Bénard and the heated cavity pass the wall
flags on; the periodic passive scalar (no y walls, buoyancy 0) passes them
off, and the kernel, which loads its tile at wrapped coordinates, wraps y
too, as the Pallas kernel does with flags[0:2] off. The kernel is built
with nvcc at first use and called through ctypes on PyTorch's current
stream. Its plain version is ops/step_thermal.py::make_step_thermal.

Dispatch follows the tensor: for a CPU tensor the wrapper runs the plain
version; for a CUDA tensor it launches the kernel or raises. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..models.base import Problem
from . import step_cuda, step_thermal, step_torch

SOURCE = "tpulbm_torch/csrc/step_thermal.cu"
REPLACES = "tpulbm/ops/step_thermal_pallas.py:147"  # make_local_step_thermal_pallas
# the ring build: the same function's ring rows, edge flags and x_halo
RINGS_REPLACES = ("tpulbm/ops/step_thermal_pallas.py:147 "
                  "(make_local_step_thermal_pallas, rb/rt, flags, x_halo)")
Q_STATE = 14   # 9 D2Q9 planes, then 5 D2Q5 planes
# the collisions of the thermal kernel, as tpulbm's: BGK and the
# Smagorinsky closure (step_cuda.COLLISION_MODES names their defines)
MODES = ("bgk", "smagorinsky")


@dataclasses.dataclass(frozen=True)
class ThermalConstants:
    """The physics constants the kernel takes as arguments, each rounded to
    float32 once on the host from tpulbm's float64 values; `mode` picks
    the library (MODES)."""
    # 1/tau, 1/tau_g, buoyancy, t_ref, then the Smagorinsky closure's
    # tau0, tau0² and 18 Cs² as tpulbm's Pallas kernel computes them (zero
    # under BGK)
    scalars: tuple[float, ...]
    w: tuple[float, ...]             # D2Q9 weights, then D2Q5 weights
    w3: tuple[float, ...]            # 3 w_i: buoyancy source per unit force
    ghost_bottom: tuple[float, ...]  # frozen ghost row below y = 0
    ghost_top: tuple[float, ...]     # frozen ghost row above y = ny-1
    wall_bottom: tuple[float, ...]   # (w_i + w_opp) T_bottom per g plane
    wall_top: tuple[float, ...]      # (w_i + w_opp) T_top per g plane
    baxis: int                       # buoyancy axis: 1 = y, 0 = x
    walls_x: bool                    # adiabatic no-slip x walls (cavity)
    # the bottom and top rows are walls (the Pallas kernel's flags[0:2]);
    # without them a pull across y wraps (the passive scalar)
    walls_y: bool
    mode: str = "bgk"

    @classmethod
    def of(cls, problem: Problem) -> "ThermalConstants":
        lat, lg, th = step_thermal._thermal_parts(problem)
        bottom, top = step_thermal.ghost_rows(problem)
        wsum = lg.w + lg.w[lg.opposite]
        mode = step_torch.collision_mode(problem)
        inv_tau = 1.0 / problem.params.tau
        tau0, cs = 1.0 / inv_tau, float(problem.smagorinsky)
        smag = ((tau0, tau0 * tau0, 18.0 * cs * cs) if mode == "smagorinsky"
                else (0.0, 0.0, 0.0))
        return cls(
            scalars=(inv_tau, 1.0 / th.tau_g, float(th.buoyancy),
                     float(th.t_ref), *smag),
            w=tuple(float(v) for v in np.concatenate([lat.w, lg.w])),
            w3=tuple(3.0 * float(v) for v in lat.w),
            ghost_bottom=tuple(float(v) for v in bottom),
            ghost_top=tuple(float(v) for v in top),
            wall_bottom=tuple(float(v) * th.t_bottom for v in wsum),
            wall_top=tuple(float(v) * th.t_top for v in wsum),
            baxis=int(th.buoyancy_axis), walls_x=bool(problem.walls_x),
            walls_y=bool(problem.walls_y), mode=mode)

    @functools.cached_property
    def arrays(self) -> tuple:
        """The seven float arrays as the C launcher takes them, built once
        (a launch then passes pointers only)."""
        return tuple(step_cuda._floats(v) for v in (
            self.scalars, self.w, self.w3, self.ghost_bottom,
            self.ghost_top, self.wall_bottom, self.wall_top))


def check_inputs(s: torch.Tensor, out: torch.Tensor) -> None:
    """Raise unless s and out are distinct contiguous float32 (14, ny, nx)
    states on one device."""
    if s.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"the thermal kernel takes float32 states, got "
                        f"{s.dtype} and {out.dtype}")
    if s.dim() != 3 or s.shape[0] != Q_STATE:
        raise ValueError(f"state must be ({Q_STATE}, ny, nx), got "
                         f"{tuple(s.shape)}")
    if out.shape != s.shape:
        raise ValueError(f"shape mismatch: s {tuple(s.shape)}, out "
                         f"{tuple(out.shape)}")
    if not (s.is_contiguous() and out.is_contiguous()):
        raise ValueError("s and out must be contiguous")
    if s.device != out.device:
        raise ValueError(f"s and out must share a device, got {s.device} "
                         f"and {out.device}")
    if s.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {s.device}")
    if out.data_ptr() == s.data_ptr():
        raise ValueError("out must not alias s (the step is not in place)")


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _library(mode: str = "bgk") -> ctypes.CDLL:
    """The thermal library built for `mode`; raises unless it holds it."""
    return step_cuda._bind("step_thermal.cu", "tpulbm_thermal_step",
                           [_PTR, _PTR, _I32, _I32] + [_PTR] * 7
                           + [_I32] * 5 + [_PTR], mode)


def collide_stream_thermal(s: torch.Tensor, out: torch.Tensor,
                           consts: ThermalConstants,
                           plain=None) -> torch.Tensor:
    """One thermal timestep from s into out; returns out.

    On a CUDA tensor: launches the kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step for the same problem)."""
    check_inputs(s, out)
    if s.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(s))
    lib = _library(consts.mode)
    ny, nx = s.shape[1:]
    stream = torch.cuda.current_stream(s.device).cuda_stream
    rc = lib.tpulbm_thermal_step(
        s.data_ptr(), out.data_ptr(), nx, ny, *consts.arrays, consts.baxis,
        int(consts.walls_y), int(consts.walls_y), int(consts.walls_x),
        s.device.index, stream)
    step_cuda._check_launch(lib, rc, f"thermal kernel ({consts.mode})")
    step_cuda._count(collide_stream_thermal, consts.mode)
    return out


step_cuda._zero_counts(collide_stream_thermal, MODES)


@functools.cache
def _rings_library(mode: str = "bgk") -> ctypes.CDLL:
    """The thermal ring build for `mode`; raises unless it holds it."""
    return step_cuda._bind("step_thermal.cu", "tpulbm_thermal_step_rings",
                           [_PTR] * 6 + [_I32] * 7 + [_PTR] * 7
                           + [_I32] * 4 + [_PTR], mode,
                           variant=step_cuda.RINGS)


def ring_args(s: torch.Tensor, out: torch.Tensor, rings: tuple,
              shard: step_cuda.Shard, consts: ThermalConstants, device: int,
              stream: int) -> tuple:
    """The arguments of tpulbm_thermal_step_rings for one shard's launch
    (the pointers of s, out and the rings, the geometry, the constants)."""
    rb, rt, rl, rr = rings
    ny, nx = shard.grid
    nyl, nxl = shard.local_shape
    y0, x0 = shard.origin
    return (s.data_ptr(), out.data_ptr(), rb.data_ptr(), rt.data_ptr(),
            step_cuda._ptr(rl), step_cuda._ptr(rr), nx, ny, nxl, nyl, x0, y0,
            1 if shard.x_rings else 0, *consts.arrays, consts.baxis,
            int(consts.walls_y), int(consts.walls_x), device, stream)


def collide_stream_thermal_rings(s: torch.Tensor, out: torch.Tensor,
                                 rings: tuple, shard: step_cuda.Shard,
                                 consts: ThermalConstants,
                                 plain=None) -> torch.Tensor:
    """One thermal timestep of one shard of a mesh from its block s
    (14, nyl, nxl) and its rings (rb, rt, rl, rr), one cell deep
    (shard.depth 1; rl and rr None where the block spans every column),
    into out; returns out. The walls act at the domain's own edges only.

    On a CUDA tensor: launches the ring build on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (step_thermal.make_ring_step_thermal for the shard)."""
    nyl = shard.local_shape[0]
    step_cuda.check_shard(s, out, rings, shard, 1, (0, nyl), q2d=Q_STATE,
                          depths={1: 1})
    rb, rt, rl, rr = rings
    if s.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(s, rb, rt, rl, rr))
    lib = _rings_library(consts.mode)
    stream = torch.cuda.current_stream(s.device).cuda_stream
    rc = lib.tpulbm_thermal_step_rings(*ring_args(
        s, out, rings, shard, consts, s.device.index, stream))
    step_cuda._check_launch(lib, rc, f"thermal ring kernel ({consts.mode}, "
                                     f"shard {shard.index})")
    step_cuda._count(collide_stream_thermal_rings, consts.mode, 1,
                     shard.index)
    return out


step_cuda._zero_counts(collide_stream_thermal_rings, MODES, (1,))


def make_local_step_thermal_cuda(problem: Problem, device):
    """step(s, out) -> out: one timestep of a thermal problem
    (Rayleigh-Bénard or the side-heated cavity, BGK or the Smagorinsky
    closure; the periodic passive scalar) through the kernel (CUDA) or its
    plain version (CPU), on (14, ny, nx) states living on `device`. The
    counterpart of make_local_step_thermal_pallas on one full-width
    device."""
    if problem.thermal is None or problem.state_q != Q_STATE:
        raise NotImplementedError("the thermal kernel covers the D2Q9 + "
                                  "D2Q5 thermal problems only")
    step_thermal.check_geometry(problem)
    device = torch.device(device)
    consts = ThermalConstants.of(problem)
    plain = (step_thermal.make_step_thermal(problem, device)
             if device.type == "cpu" else None)

    def step(s: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream_thermal(s, out, consts, plain=plain)

    return step
