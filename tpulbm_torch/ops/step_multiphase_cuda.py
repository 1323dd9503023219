"""The fused Shan-Chen multiphase step as a hand-written CUDA kernel.

Port of tpulbm/ops/step_multiphase_pallas.py::make_local_step_multiphase_pallas
(one step per launch): csrc/step_multiphase.cu (a row march down column
strips) on one full-width device, and its ring build (-DTPULBM_RINGS=1,
collide_stream_multiphase_rings) on a shard of a mesh: the block and its
pre-collision rings two cells deep, the Pallas kernel's depth-2 rb/rt and
x_halo rl/rr. The kernel is built with nvcc at first use and called
through ctypes on PyTorch's current stream. Its plain version is
ops/step_multiphase.py::make_step_multiphase.

Dispatch follows the tensor: for a CPU tensor the wrapper runs the plain
version; for a CUDA tensor it launches the kernel or raises. There is no
fallback from one to the other.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..models.base import Problem
from . import step_cuda, step_multiphase

SOURCE = "tpulbm_torch/csrc/step_multiphase.cu"
REPLACES = "tpulbm/ops/step_multiphase_pallas.py:121"  # make_local_step_multiphase_pallas
# the ring build: the same function's depth-2 ring rows and x_halo
RINGS_REPLACES = ("tpulbm/ops/step_multiphase_pallas.py:121 "
                  "(make_local_step_multiphase_pallas, depth-2 rb/rt, "
                  "x_halo)")
Q = 9
DEPTH = 2   # the rings' depth: ψ's stencil reads one cell, the pull one


@dataclasses.dataclass(frozen=True)
class MultiphaseConstants:
    """The physics constants the kernel takes as arguments, each rounded to
    float32 once on the host from the plain step's float64 values."""
    scalars: tuple[float, ...]   # 1/tau, 1/(1/tau), -g, rho0, wall ψ
    w: tuple[float, ...]         # D2Q9 weights

    @classmethod
    def of(cls, problem: Problem) -> "MultiphaseConstants":
        lat, g, rho0 = step_multiphase._mp_parts(problem)
        inv_tau = 1.0 / problem.params.tau
        return cls(scalars=(inv_tau, 1.0 / inv_tau, -g, rho0,
                            step_multiphase.wall_psi(problem)),
                   w=tuple(float(v) for v in lat.w))

    @functools.cached_property
    def arrays(self) -> tuple:
        """The two float arrays as the C launcher takes them, built once
        (a launch then passes pointers only)."""
        return step_cuda._floats(self.scalars), step_cuda._floats(self.w)


def check_inputs(f: torch.Tensor, out: torch.Tensor) -> None:
    """Raise unless f and out are distinct contiguous float32 (9, ny, nx)
    states on one device."""
    if f.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"the multiphase kernel takes float32 states, got "
                        f"{f.dtype} and {out.dtype}")
    if f.dim() != 3 or f.shape[0] != Q:
        raise ValueError(f"state must be ({Q}, ny, nx), got "
                         f"{tuple(f.shape)}")
    if out.shape != f.shape:
        raise ValueError(f"shape mismatch: f {tuple(f.shape)}, out "
                         f"{tuple(out.shape)}")
    if not (f.is_contiguous() and out.is_contiguous()):
        raise ValueError("f and out must be contiguous")
    if f.device != out.device:
        raise ValueError(f"f and out must share a device, got {f.device} "
                         f"and {out.device}")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {f.device}")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("out must not alias f (the step is not in place)")


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int


def _bind_march(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A multiphase library with its queries of the row march typed:
    tpulbm_multiphase_width(), _rows(), _threads(), _smem_bytes() and
    _grid(cols, rows, device) (strips * 65536 + segments)."""
    for name in ("width", "rows", "threads", "smem_bytes"):
        getattr(lib, f"tpulbm_multiphase_{name}").argtypes = []
        getattr(lib, f"tpulbm_multiphase_{name}").restype = _I32
    lib.tpulbm_multiphase_grid.argtypes = [_I32] * 3
    lib.tpulbm_multiphase_grid.restype = _I32
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    return _bind_march(step_cuda._bind(
        "step_multiphase.cu", "tpulbm_multiphase_step",
        [_PTR, _PTR, _I32, _I32, _PTR, _PTR, _I32, _PTR]))


def collide_stream_multiphase(f: torch.Tensor, out: torch.Tensor,
                              consts: MultiphaseConstants,
                              plain=None) -> torch.Tensor:
    """One multiphase timestep from f into out; returns out.

    On a CUDA tensor: launches the kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step for the same problem)."""
    check_inputs(f, out)
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(f))
    lib = _library()
    ny, nx = f.shape[1:]
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.tpulbm_multiphase_step(f.data_ptr(), out.data_ptr(), nx, ny,
                                    *consts.arrays, f.device.index, stream)
    step_cuda._check_launch(lib, rc, "multiphase kernel")
    collide_stream_multiphase.launches += 1
    return out


# kernel launches; CPU calls (the plain version) are not counted
collide_stream_multiphase.launches = 0


@functools.cache
def _rings_library() -> ctypes.CDLL:
    return _bind_march(step_cuda._bind(
        "step_multiphase.cu", "tpulbm_multiphase_step_rings",
        [_PTR] * 6 + [_I32] * 7 + [_PTR, _PTR, _I32, _PTR],
        variant=step_cuda.RINGS))


def ring_args(f: torch.Tensor, out: torch.Tensor, rings: tuple,
              shard: step_cuda.Shard, consts: MultiphaseConstants,
              device: int, stream: int) -> tuple:
    """The arguments of tpulbm_multiphase_step_rings for one shard's
    launch (the pointers of f, out and the rings, the geometry, the
    constants)."""
    rb, rt, rl, rr = rings
    ny, nx = shard.grid
    nyl, nxl = shard.local_shape
    y0, x0 = shard.origin
    return (f.data_ptr(), out.data_ptr(), rb.data_ptr(), rt.data_ptr(),
            step_cuda._ptr(rl), step_cuda._ptr(rr), nx, ny, nxl, nyl, x0, y0,
            DEPTH if shard.x_rings else 0, *consts.arrays, device, stream)


def collide_stream_multiphase_rings(f: torch.Tensor, out: torch.Tensor,
                                    rings: tuple, shard: step_cuda.Shard,
                                    consts: MultiphaseConstants,
                                    plain=None) -> torch.Tensor:
    """One Shan-Chen timestep of one shard of a mesh from its block f
    (9, nyl, nxl) and its pre-collision rings (rb, rt, rl, rr), DEPTH
    cells deep (rl and rr None where the block spans every column), into
    out; returns out. The walls act at the domain's own rows only.

    On a CUDA tensor: launches the ring build on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (step_multiphase.make_ring_step_multiphase for the
    shard)."""
    nyl = shard.local_shape[0]
    step_cuda.check_shard(f, out, rings, shard, 1, (0, nyl), q2d=Q,
                          depths={DEPTH: 1})
    rb, rt, rl, rr = rings
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(f, rb, rt, rl, rr))
    lib = _rings_library()
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.tpulbm_multiphase_step_rings(*ring_args(
        f, out, rings, shard, consts, f.device.index, stream))
    step_cuda._check_launch(lib, rc, f"multiphase ring kernel (shard "
                                     f"{shard.index})")
    step_cuda._count(collide_stream_multiphase_rings, "bgk", DEPTH,
                     shard.index)
    return out


step_cuda._zero_counts(collide_stream_multiphase_rings, ("bgk",), (DEPTH,))


def check_problem(problem: Problem) -> None:
    """Raise NotImplementedError unless the multiphase kernel covers
    `problem`: the D2Q9 Shan-Chen channel under BGK."""
    if not problem.shan_chen or problem.lattice.Q != Q:
        raise NotImplementedError("the multiphase kernel covers the D2Q9 "
                                  "Shan-Chen problem only")
    if problem.collision != "bgk":
        raise NotImplementedError("the multiphase kernel covers BGK only")
    step_multiphase.check_geometry(problem)


def make_local_step_multiphase_cuda(problem: Problem, device):
    """step(f, out) -> out: one Shan-Chen timestep of a multiphase problem
    (the x-periodic channel, BGK) through the kernel (CUDA) or its plain
    version (CPU), on (9, ny, nx) states living on `device`. The
    counterpart of make_local_step_multiphase_pallas on one full-width
    device."""
    check_problem(problem)
    device = torch.device(device)
    consts = MultiphaseConstants.of(problem)
    plain = (step_multiphase.make_step_multiphase(problem, device)
             if device.type == "cpu" else None)

    def step(f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream_multiphase(f, out, consts, plain=plain)

    return step
