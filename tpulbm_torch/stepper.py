"""Chunked time stepping on one device.

Port of tpulbm/parallel/sharded_step.py::make_chunk_fn for a single device:
no mesh and no halo exchange. A chunk is a Python loop of step launches
over two ping-pong buffers; PyTorch queues them asynchronously, so the host
only waits where a caller reads a result.
"""
from __future__ import annotations

import torch

from .models.base import Problem
from .ops import step_cuda, step_torch


def make_chunk_fn(problem: Problem, device, chunk_len: int,
                  backend: str = "pallas"):
    """fn(f) -> f advanced by chunk_len steps, on `device`.

    backend="pallas": the CUDA kernel (its plain version for CPU tensors);
    backend="jax": the plain PyTorch step, in f32 or f64.
    The input f is donated: its storage is reused as a ping-pong buffer.
    """
    if chunk_len < 1:
        raise ValueError(f"chunk_len must be >= 1, got {chunk_len}")
    if backend == "pallas":
        if problem.params.precision != "f32":
            raise NotImplementedError(
                "the CUDA kernel runs float32 only, as tpulbm's Pallas "
                "kernels do; use backend='jax' for f64")
        step = step_cuda.make_local_step_cuda(problem, device)

        def chunk(f: torch.Tensor) -> torch.Tensor:
            spare = torch.empty_like(f)
            for _ in range(chunk_len):
                f, spare = step(f, spare), f
            return f
    elif backend == "jax":
        step_plain = step_torch.make_step_rolled(problem, torch.device(device))

        def chunk(f: torch.Tensor) -> torch.Tensor:
            for _ in range(chunk_len):
                f = step_plain(f)
            return f
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return chunk
