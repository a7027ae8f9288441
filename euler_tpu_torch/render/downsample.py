"""Pooled frames for grids larger than the terminal window
(`euler_tpu/render/downsample.py`).

The reference draws its 100 x 40 grid 1:1 and clips what the window does
not hold (main.c:914-951).  For large grids this pools the interior into
window-sized blocks on the device, so the host copy stays ~5 bytes a
character cell.  Per block:
  * glyph: the largest marker count (any water in the block shows);
  * class: solid over sink over empty (obstacles stay visible);
  * colour: the mean of the water cells' RGB (rainbow mode).
The pooled planes keep the one-cell border ring, so the unchanged ANSI
encoder renders them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.render.ansi import (
    C_EMPTY,
    C_SINK,
    C_SOLID,
    T_HIDE_CURSOR,
    T_REPOSITION,
    encode_frame,
    gather_device,
    to_host,
)


def _pool(a, fy: int, fx: int, reduce):
    """Block-reduce a [iy, ix, ...] plane, the edges padded with zeros up
    to whole blocks; `reduce` takes the block axes (1, 3)."""
    iy, ix = a.shape[:2]
    py, px = (-iy) % fy, (-ix) % fx
    pad = [0, 0] * (a.ndim - 2) + [0, px, 0, py]
    a = F.pad(a, pad)
    by, bx = (iy + py) // fy, (ix + px) // fx
    return reduce(a.reshape((by, fy, bx, fx) + tuple(a.shape[2:])))


def _amax(a):
    return torch.amax(a, dim=(1, 3))


def _sum(a):
    return torch.sum(a, dim=(1, 3))


def gather_frame_downsampled(cfg: SimConfig, fy: int, fx: int,
                             scn: Scenario, state: FluidState):
    """The pooled render gather: (glyph, cls, rgb) numpy arrays of shape
    [by + 2, bx + 2] (with the border ring), by = ceil((Y - 2) / fy),
    pooled on the state's device and copied to the host once."""
    count, cls, rgb = gather_device(cfg, scn, state)
    # interior only: the border ring is put back after pooling
    count, cls, rgb = count[1:-1, 1:-1], cls[1:-1, 1:-1], rgb[1:-1, 1:-1]

    glyph_d = _pool(count, fy, fx, _amax)
    any_solid = _pool((cls == C_SOLID).to(torch.uint8), fy, fx, _amax) > 0
    any_sink = _pool((cls == C_SINK).to(torch.uint8), fy, fx, _amax) > 0
    cls_d = torch.where(any_solid, C_SOLID,
                        torch.where(any_sink, C_SINK, C_EMPTY)
                        ).to(torch.uint8)

    water = (count > 0)[..., None].to(torch.float32)
    rgb_sum = _pool(rgb.to(torch.float32) * water, fy, fx, _sum)
    n_water = _pool(water, fy, fx, _sum)
    rgb_d = (rgb_sum / torch.clamp_min(n_water, 1.0)).to(torch.uint8)

    def pad2(a):
        return F.pad(a, [0, 0] * (a.ndim - 2) + [1, 1, 1, 1])

    return to_host(pad2(glyph_d), pad2(cls_d), pad2(rgb_d))


def pick_factors(cfg: SimConfig, window_rows: int, window_cols: int):
    """The smallest (fy, fx) for which the interior fits the window."""
    iy, ix = cfg.ny - 2, cfg.nx - 2
    fy = max(1, -(-iy // max(window_rows, 1)))
    fx = max(1, -(-ix // max(window_cols, 1)))
    return fy, fx


def draw_frame_downsampled(cfg: SimConfig, scn: Scenario, state: FluidState,
                           window_rows: int, window_cols: int) -> bytes:
    """`draw_frame` for grids larger than the window: pooled on the
    device, encoded by the ANSI encoder with a window-sized config (the
    encoder reads only ny and nx)."""
    fy, fx = pick_factors(cfg, window_rows, window_cols)
    glyph, cls, rgb = gather_frame_downsampled(cfg, fy, fx, scn, state)
    small = SimConfig(ny=int(glyph.shape[0]), nx=int(glyph.shape[1]),
                      rainbow=cfg.rainbow)
    body = encode_frame(small, glyph, cls, rgb, window_rows, window_cols,
                        cfg.rainbow)
    return T_REPOSITION + body + T_HIDE_CURSOR
