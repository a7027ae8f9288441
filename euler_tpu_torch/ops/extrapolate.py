"""Velocity extrapolation into newly-fluid cells
(`euler_tpu/ops/extrapolate.py`, main.c:158-185): a sample that is fluid
now but was not before takes the average of its 3x3 neighbours that were
fluid before; with no such neighbour it takes 0."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import property_of, valid_region


def _neighborhood_sum(a):
    """Sum of the 3x3 neighbourhood (zero beyond edges): rows first, then
    columns, in the JAX package's order."""
    p = F.pad(a, (1, 1, 1, 1))
    rows = p[:-2, :] + p[1:-1, :] + p[2:, :]
    return rows[:, :-2] + rows[:, 1:-1] + rows[:, 2:]


def extrapolate(cfg: SimConfig, q, fluid, prev_fluid, celltype: str,
                clamp_ny=None, row_offset: int = 0, clamp_nx=None,
                col_offset: int = 0):
    region = valid_region(cfg, celltype, q.device, clamp_ny, row_offset,
                          clamp_nx, col_offset)
    prop = property_of(fluid, celltype) & region
    prev_prop = property_of(prev_fluid, celltype) & region
    newly = (~prev_prop) & prop

    prev_f = prev_prop.to(q.dtype)
    total = _neighborhood_sum(q * prev_f)
    count = _neighborhood_sum(prev_f)
    avg = total / torch.where(count > 0, count, 1.0)
    avg = torch.where(count > 0, avg, 0.0)
    return torch.where(newly, avg, q)
