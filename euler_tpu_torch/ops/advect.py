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


def _site_index_grids(cfg: SimConfig, dtype, device, row_offset: int = 0,
                      col_offset: int = 0):
    """The sites' (x, y) indices: the grid column and row (plane column +
    col_offset, plane row + row_offset on a block)."""
    xs = torch.arange(col_offset, col_offset + cfg.nx, dtype=dtype,
                      device=device)[None, :]
    ys = torch.arange(row_offset, row_offset + cfg.ny, dtype=dtype,
                      device=device)[:, None]
    return xs.expand(cfg.ny, cfg.nx), ys.expand(cfg.ny, cfg.nx)


def advect_u(cfg: SimConfig, u, v, fluid, dt, clamp_ny=None,
             row_offset: int = 0, clamp_nx=None, col_offset: int = 0):
    """main.c:382-399.  `clamp_ny`, `row_offset`, `clamp_nx`,
    `col_offset`: a block's place in the grid
    (`ops/cuda/grid_kernel.grid_stage`)."""
    rows = dict(clamp_ny=clamp_ny, row_offset=row_offset, clamp_nx=clamp_nx,
                col_offset=col_offset)
    xs, ys = _site_index_grids(cfg, u.dtype, u.device, row_offset,
                               col_offset)
    inv_h = 1.0 / cfg.side_length
    dx = u
    # v at the u site: v grid index (x+0.5, y-0.5)
    dy = interpolate_stencil(cfg, v, fluid, xs + 0.5, ys - 0.5, "v", **rows)
    prev_x = xs - dx * dt * inv_h
    prev_y = ys - dy * dt * inv_h
    out = interpolate_stencil(cfg, u, fluid, prev_x, prev_y, "u", **rows)
    mask = u_property(fluid) & valid_region(cfg, "u", u.device, **rows)
    return torch.where(mask, out, 0.0)


def advect_v(cfg: SimConfig, u, v, fluid, dt, clamp_ny=None,
             row_offset: int = 0, clamp_nx=None, col_offset: int = 0):
    """main.c:405-422."""
    rows = dict(clamp_ny=clamp_ny, row_offset=row_offset, clamp_nx=clamp_nx,
                col_offset=col_offset)
    xs, ys = _site_index_grids(cfg, v.dtype, v.device, row_offset,
                               col_offset)
    inv_h = 1.0 / cfg.side_length
    dy = v
    # u at the v site: u grid index (x-0.5, y+0.5)
    dx = interpolate_stencil(cfg, u, fluid, xs - 0.5, ys + 0.5, "u", **rows)
    prev_x = xs - dx * dt * inv_h
    prev_y = ys - dy * dt * inv_h
    out = interpolate_stencil(cfg, v, fluid, prev_x, prev_y, "v", **rows)
    mask = v_property(fluid) & valid_region(cfg, "v", v.device, **rows)
    return torch.where(mask, out, 0.0)


def advect_p(cfg: SimConfig, q, u, v, fluid, dt, clamp_ny=None,
             row_offset: int = 0, clamp_nx=None, col_offset: int = 0):
    """main.c:424-438: advect a cell-centred quantity (the colours) with
    the face-averaged velocity; non-fluid cells keep their value.  On a
    block padded with its neighbours' cells (`parallel/spatial.Blocks`)
    `clamp_ny`, `row_offset`, `clamp_nx`, `col_offset` give its place in
    the grid, as for `advect_u`; the face averages read the padded
    plane's row and column before each cell."""
    rows = dict(clamp_ny=clamp_ny, row_offset=row_offset, clamp_nx=clamp_nx,
                col_offset=col_offset)
    xs, ys = _site_index_grids(cfg, q.dtype, q.device, row_offset,
                               col_offset)
    inv_h = 1.0 / cfg.side_length
    dy = (v + shift_down(v)) * 0.5
    dx = (u + shift_left(u)) * 0.5
    prev_x = xs - dx * dt * inv_h
    prev_y = ys - dy * dt * inv_h
    out = interpolate_stencil(cfg, q, fluid, prev_x, prev_y, "p", **rows)
    return torch.where(fluid, out, q)
