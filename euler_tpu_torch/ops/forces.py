"""Gravity, boundary zeroing and the CFL max speed
(`euler_tpu/ops/forces.py`: main.c:539-545, 822-832, 808-820)."""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import property_of, valid_region


def apply_body_forces(cfg: SimConfig, v, dt, clamp_ny=None,
                      row_offset: int = 0, clamp_nx=None,
                      col_offset: int = 0):
    """Gravity on every V sample (main.c:539-545), fluid or not."""
    region = valid_region(cfg, "v", v.device, clamp_ny, row_offset,
                          clamp_nx, col_offset)
    g = torch.as_tensor(cfg.gravity, dtype=v.dtype, device=v.device)
    return torch.where(region, v + g * dt, v)


def zero_bounds(cfg: SimConfig, q, fluid, solid, celltype: str,
                clamp_ny=None, row_offset: int = 0, clamp_nx=None,
                col_offset: int = 0):
    """Zero non-fluid and solid faces (main.c:822-832)."""
    region = valid_region(cfg, celltype, q.device, clamp_ny, row_offset,
                          clamp_nx, col_offset)
    keep = property_of(fluid, celltype) & ~property_of(solid, celltype)
    return torch.where(keep & region, q, 0.0)


def max_speed_sq(cfg: SimConfig, u, v):
    """maxsq over U plus maxsq over V (main.c:808-820, 839)."""
    mu, mv = max_speed_sq_parts(cfg, u, v)
    return mu + mv


def max_speed_sq_parts(cfg: SimConfig, u, v, clamp_ny=None,
                       row_offset: int = 0, clamp_nx=None,
                       col_offset: int = 0):
    """(maxsq over U, maxsq over V): on blocks each is all-reduced (max)
    before the sum (`parallel/spatial.py`)."""
    rows = (clamp_ny, row_offset, clamp_nx, col_offset)
    mu = torch.where(valid_region(cfg, "u", u.device, *rows), u * u,
                     0.0).max()
    mv = torch.where(valid_region(cfg, "v", v.device, *rows), v * v,
                     0.0).max()
    return mu, mv
