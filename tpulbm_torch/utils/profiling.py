"""Throughput accounting and an optional profiler trace.

Port of tpulbm/utils/profiling.py. PyTorch returns before the GPU finishes,
so the meter synchronizes a CUDA device at both ends of the measured span:
it times the work, not its enqueueing.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """torch.profiler trace (CPU and, where present, CUDA activity) written
    for TensorBoard under log_dir; no-op if log_dir is None."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class ThroughputMeter:
    """(cells × steps) / seconds → MLUPS (million lattice-site updates per
    second)."""

    def __init__(self, num_cells: int, device=None):
        self.num_cells = num_cells
        self.device = torch.device(device) if device is not None else None
        self.steps = 0
        self.seconds = 0.0

    def _fence(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def measure(self, n_steps: int):
        self._fence()
        t0 = time.perf_counter()
        yield
        self._fence()
        self.seconds += time.perf_counter() - t0
        self.steps += n_steps

    @property
    def mlups(self) -> float:
        if self.seconds == 0:
            return 0.0
        return self.num_cells * self.steps / self.seconds / 1e6
