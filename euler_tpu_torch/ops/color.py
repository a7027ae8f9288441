"""Rainbow colours (`euler_tpu/ops/color.py`): `hsv_basis` follows
misc/color.h:16-33 and `colorize` main.c:187-201.  The renderer's
`linear_to_srgb` and `float_to_byte_color` come with the renderer
(ROADMAP queue 1 item M10)."""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario


def hsv_basis(t):
    """Piecewise-linear periodic HSV component (misc/color.h:16-33)."""
    t = t - 6.0 * torch.floor((1.0 / 6.0) * t)
    t = torch.where(t < 0.0, t + 6.0, t)
    return torch.where(
        t < 1.0, t,
        torch.where(t < 3.0, 1.0, torch.where(t < 4.0, 4.0 - t, 0.0)))


def colorize(cfg: SimConfig, scn: Scenario, state: FluidState) -> FluidState:
    """Rainbow init (main.c:187-201): phase (x+y)*6/period, 0 at sources,
    on fluid cells."""
    f = state.r.dtype
    dev = state.r.device
    xs = torch.arange(cfg.nx, dtype=f, device=dev)[None, :]
    ys = torch.arange(cfg.ny, dtype=f, device=dev)[:, None]
    t = (xs + ys) * (6.0 / cfg.initial_color_period)
    t = torch.where(scn.source, 0.0, t)
    fluid = state.fluid
    return state.replace(
        r=torch.where(fluid, hsv_basis(t + 2.0), state.r),
        g=torch.where(fluid, hsv_basis(t), state.g),
        b=torch.where(fluid, hsv_basis(t - 2.0), state.b),
    )
