"""Lattice descriptors: tpulbm's D2Q9 and D3Q19, re-exported, plus tensor
views."""
from __future__ import annotations

import torch

from tpulbm.lattice import D2Q9, D3Q19, Lattice

__all__ = ["D2Q9", "D3Q19", "Lattice", "lattice_tensors"]


def lattice_tensors(lat: Lattice, device, dtype=torch.float32):
    """(c, w, opposite) of `lat` as tensors on `device`: c (Q, D) int64,
    w (Q,) in `dtype`, opposite (Q,) int64."""
    c = torch.as_tensor(lat.c, dtype=torch.int64, device=device)
    w = torch.as_tensor(lat.w, dtype=dtype, device=device)
    opp = torch.as_tensor(lat.opposite, dtype=torch.int64, device=device)
    return c, w, opp
