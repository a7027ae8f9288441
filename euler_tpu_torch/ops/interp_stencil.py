"""Stencil interpolation (`euler_tpu/ops/interp_stencil.py`).

The CFL limit (0.75 cells per substep, main.c:838) keeps every backtrace
within one cell of its site, so the 2x2 interpolation corners lie in the
3x3 window centred on the site: the base is the site itself or the cell
before it.  The corner values are read from the zero-padded field at
those window offsets; for in-window positions this is bit-identical to
the gather form in `interp.interpolate`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import grid_size, property_of
from euler_tpu_torch.ops.interp import bilinear, clamp_hi


def interpolate_stencil(cfg: SimConfig, q, fluid, idx_x, idx_y, celltype: str,
                        clamp_ny: int | None = None, row_offset: int = 0,
                        clamp_nx: int | None = None, col_offset: int = 0):
    """interpolate (main.c:337-364) for per-site samples [..., Y, X] with
    |idx - site| <= 1 in each axis; leading axes (the K slots of the
    marker store) broadcast against the [Y, X] fields.

    On a block's plane (the marker pass of parallel/cuda_shard.py) the
    sample indices are global: `row_offset` / `col_offset` are the global
    row / column of plane row / column 0 and `clamp_ny` / `clamp_nx` the
    global row / column counts that the clamps use (cfg.ny, cfg.nx and 0
    on a whole plane)."""
    size_x, size_y = grid_size(cfg, celltype)
    if clamp_ny is not None:
        size_y += clamp_ny - cfg.ny
    if clamp_nx is not None:
        size_x += clamp_nx - cfg.nx
    ix = torch.clamp(idx_x.to(q.dtype), 0.0, clamp_hi(size_x))
    iy = torch.clamp(idx_y.to(q.dtype), 0.0, clamp_hi(size_y))
    whole_x = torch.floor(ix)
    whole_y = torch.floor(iy)
    frac_x = ix - whole_x
    frac_y = iy - whole_y

    Y, X = q.shape
    dev = q.device
    site_x = torch.arange(X, device=dev)
    site_y = torch.arange(Y, device=dev)[:, None]
    # window column/row of the base in the padded field: site (+1 for
    # the pad) when the base is the site, else the cell before it
    col0 = site_x + torch.where(whole_x.long() == site_x + col_offset, 1, 0)
    row0 = site_y + torch.where(whole_y.long() == site_y + row_offset, 1, 0)

    prop = property_of(fluid, celltype)
    qp = F.pad(q, (1, 1, 1, 1))
    vp = F.pad(prop.to(torch.uint8), (1, 1, 1, 1)) != 0

    def corner(cy, cx):
        return vp[row0 + cy, col0 + cx], qp[row0 + cy, col0 + cx]

    v00, q00 = corner(0, 0)
    v01, q01 = corner(0, 1)
    v10, q10 = corner(1, 0)
    v11, q11 = corner(1, 1)
    q00 = torch.where(v00, q00, 0.0)
    q01 = torch.where(v01, q01, 0.0)
    q10 = torch.where(v10, q10, 0.0)
    q11 = torch.where(v11, q11, 0.0)
    return bilinear(q00, q01, q10, q11, frac_x, frac_y, v00, v01, v10, v11)
