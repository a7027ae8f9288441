"""RK1 semi-Lagrangian advection (`euler_tpu/ops/advect.py`,
main.c:382-438), stencil interpolation only: the face velocities, whose
non-fluid sites are written as 0 (zero_bounds clears them anyway), and
the cell-centred colours, whose non-fluid cells keep their value."""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import (
    shift_down,
    shift_left,
    u_property,
    v_property,
    valid_region,
)
from euler_tpu_torch.ops.interp_stencil import interpolate_stencil


def _site_index_grids(cfg: SimConfig, dtype, device):
    xs = torch.arange(cfg.nx, dtype=dtype, device=device)[None, :]
    ys = torch.arange(cfg.ny, dtype=dtype, device=device)[:, None]
    return xs.expand(cfg.ny, cfg.nx), ys.expand(cfg.ny, cfg.nx)


def advect_u(cfg: SimConfig, u, v, fluid, dt):
    """main.c:382-399."""
    xs, ys = _site_index_grids(cfg, u.dtype, u.device)
    inv_h = 1.0 / cfg.side_length
    dx = u
    # v at the u site: v grid index (x+0.5, y-0.5)
    dy = interpolate_stencil(cfg, v, fluid, xs + 0.5, ys - 0.5, "v")
    prev_x = xs - dx * dt * inv_h
    prev_y = ys - dy * dt * inv_h
    out = interpolate_stencil(cfg, u, fluid, prev_x, prev_y, "u")
    mask = u_property(fluid) & valid_region(cfg, "u", u.device)
    return torch.where(mask, out, 0.0)


def advect_v(cfg: SimConfig, u, v, fluid, dt):
    """main.c:405-422."""
    xs, ys = _site_index_grids(cfg, v.dtype, v.device)
    inv_h = 1.0 / cfg.side_length
    dy = v
    # u at the v site: u grid index (x-0.5, y+0.5)
    dx = interpolate_stencil(cfg, u, fluid, xs - 0.5, ys + 0.5, "u")
    prev_x = xs - dx * dt * inv_h
    prev_y = ys - dy * dt * inv_h
    out = interpolate_stencil(cfg, v, fluid, prev_x, prev_y, "v")
    mask = v_property(fluid) & valid_region(cfg, "v", v.device)
    return torch.where(mask, out, 0.0)


def advect_p(cfg: SimConfig, q, u, v, fluid, dt):
    """main.c:424-438: advect a cell-centred quantity (the colours) with
    the face-averaged velocity; non-fluid cells keep their value."""
    xs, ys = _site_index_grids(cfg, q.dtype, q.device)
    inv_h = 1.0 / cfg.side_length
    dy = (v + shift_down(v)) * 0.5
    dx = (u + shift_left(u)) * 0.5
    prev_x = xs - dx * dt * inv_h
    prev_y = ys - dy * dt * inv_h
    out = interpolate_stencil(cfg, q, fluid, prev_x, prev_y, "p")
    return torch.where(fluid, out, q)
