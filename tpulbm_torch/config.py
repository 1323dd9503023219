"""Simulation configuration: tpulbm's jax-free config module, re-exported.

`--backend pallas` (the default) selects the hand-written CUDA kernel
(ops/step_cuda.py); `--backend jax` selects the plain PyTorch step
(ops/step_torch.py). The names are kept so both packages share one CLI.
"""
from tpulbm.config import (PRESETS, SimulationParams, add_cli_args,
                           params_from_args, tau_for_reynolds)

__all__ = ["PRESETS", "SimulationParams", "add_cli_args", "params_from_args",
           "tau_for_reynolds"]
