"""The fused D2Q9 collide-stream step as a hand-written CUDA kernel.

Port of tpulbm/ops/step_pallas.py::make_local_step_pallas. The kernel
(csrc/step_d2q9.cu) is built with nvcc at first use and called through
ctypes on PyTorch's current stream. Its plain version is
ops/step_torch.py::make_step_rolled.

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
from ..utils import cuda_build
from . import step_torch

KERNEL_SOURCE = "tpulbm_torch/csrc/step_d2q9.cu"
REPLACES = "tpulbm/ops/step_pallas.py:1093"   # make_local_step_pallas


@dataclasses.dataclass(frozen=True)
class StepConstants:
    """The physics constants the kernel takes as arguments."""
    inv_tau: float
    u_in: float
    eq_in: tuple[float, ...]   # frozen ghost equilibrium per direction
    w: tuple[float, ...]       # weights: the solid cells' rest equilibrium

    @classmethod
    def of(cls, problem: Problem) -> "StepConstants":
        return cls(inv_tau=1.0 / problem.params.tau,
                   u_in=float(problem.init_u[0]),
                   eq_in=tuple(float(v) for v in problem.ghost_ring_values()),
                   w=tuple(float(v) for v in problem.lattice.w))


def check_inputs(f: torch.Tensor, out: torch.Tensor,
                 solid: torch.Tensor) -> None:
    """Raise unless f and out are distinct contiguous float32 (9, ny, nx)
    tensors and solid a contiguous uint8 (ny, nx) mask, all on one
    device."""
    if f.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"the D2Q9 kernel takes float32 states, got "
                        f"{f.dtype} and {out.dtype}")
    if solid.dtype != torch.uint8:
        raise TypeError(f"solid mask must be uint8, got {solid.dtype}")
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"state must be (9, ny, nx), got {tuple(f.shape)}")
    if out.shape != f.shape or tuple(solid.shape) != tuple(f.shape[1:]):
        raise ValueError(f"shape mismatch: f {tuple(f.shape)}, out "
                         f"{tuple(out.shape)}, solid {tuple(solid.shape)}")
    if not (f.is_contiguous() and out.is_contiguous()
            and solid.is_contiguous()):
        raise ValueError("f, out and solid must be contiguous")
    if not f.device == out.device == solid.device:
        raise ValueError(f"f, out and solid must share a device, got "
                         f"{f.device}, {out.device}, {solid.device}")
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {f.device}")
    if out.data_ptr() == f.data_ptr():
        raise ValueError("out must not alias f (the step is not in place)")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("step_d2q9.cu").lib
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpulbm_d2q9_step.argtypes = [ptr, ptr, ptr, i32, i32, f32, f32, f32,
                                     ptr, ptr, i32, ptr]
    lib.tpulbm_d2q9_step.restype = i32
    lib.tpulbm_cuda_error_string.argtypes = [i32]
    lib.tpulbm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def collide_stream(f: torch.Tensor, out: torch.Tensor, solid: torch.Tensor,
                   consts: StepConstants,
                   plain=None) -> torch.Tensor:
    """One timestep from f into out; returns out.

    On a CUDA tensor: launches the kernel on the current stream (no
    synchronization) and raises if the launch is refused. On a CPU tensor:
    runs `plain` (the plain version's step for the same problem)."""
    check_inputs(f, out, solid)
    if f.device.type == "cpu":
        if plain is None:
            raise ValueError("a CPU tensor needs the plain step")
        return out.copy_(plain(f))
    lib = _library()
    ny, nx = f.shape[1:]
    farr = ctypes.c_float * 9
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = lib.tpulbm_d2q9_step(
        f.data_ptr(), out.data_ptr(), solid.data_ptr(), nx, ny,
        consts.inv_tau, consts.u_in, 1.0 - consts.u_in,
        farr(*consts.eq_in), farr(*consts.w), f.device.index, stream)
    if rc != 0:
        raise RuntimeError("D2Q9 kernel launch failed: "
                           + lib.tpulbm_cuda_error_string(rc).decode())
    collide_stream.launches += 1
    return out


# kernel launches; CPU calls (the plain version) are not counted
collide_stream.launches = 0


def make_local_step_cuda(problem: Problem, device):
    """step(f, out) -> out: one timestep of `problem` through the kernel
    (CUDA) or its plain version (CPU), on states living on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if problem.collision != "bgk" or problem.obstacle_bc != "equilibrium":
        raise NotImplementedError("the D2Q9 kernel covers BGK with the "
                                  "equilibrium obstacle only")
    consts = StepConstants.of(problem)
    solid = torch.as_tensor(problem.solid, device=device).to(torch.uint8)
    plain = (step_torch.make_step_rolled(problem, device)
             if device.type == "cpu" else None)

    def step(f: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return collide_stream(f, out, solid, consts, plain)

    return step
