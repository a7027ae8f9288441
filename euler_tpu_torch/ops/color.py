"""Colour machinery (`euler_tpu/ops/color.py`): `hsv_basis`,
`linear_to_srgb` and `float_to_byte_color` follow misc/color.h:6-33,
`colorize` main.c:187-201."""

from __future__ import annotations

import numpy as np
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


def linear_to_srgb(x):
    """Approximate gamma (misc/color.h:11-13): max(x, 0) ** (1 / 2.2) in
    f32.  The power is taken in f64 and rounded once to f32, which agrees
    with the JAX package's f32 pow far more often than torch's f32 pow
    does (and with it on every byte `render.ansi` makes of it); the card
    and the CPU then give the same bytes."""
    e = float(np.float32(1 / 2.2))
    return torch.pow(torch.clamp_min(x, 0.0).double(), e).to(x.dtype)


def float_to_byte_color(x: np.ndarray) -> np.ndarray:
    """misc/color.h:6-9, on the host."""
    end = np.nextafter(np.float32(256.0), np.float32(0.0))
    return np.clip(end * x, 0.0, end).astype(np.int32)
