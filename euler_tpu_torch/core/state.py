"""Simulation state as dataclasses of tensors.

Same fields, dtypes and layouts as `euler_tpu/core/state.py`:
  * arrays are indexed [y, x];
  * `u` samples live on vertical faces: logical [Y, X-1], stored [Y, X]
    with the last column unused; `v` logical [Y-1, X], stored [Y, X];
  * "fluid" means marker_count > 0.
One difference of form: the slot marker store is kept as [2, K, Y, X]
(`alive` as [K, Y, X]); the JAX package's flat [2, M] is the same memory
(m = (k*Y + y)*X + x), and `euler_tpu_torch.convert` reshapes between them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig


@dataclasses.dataclass
class Scenario:
    """Static per-scenario cell flags."""

    solid: torch.Tensor        # bool [Y, X]
    source: torch.Tensor       # bool [Y, X]
    sink: torch.Tensor         # bool [Y, X]
    source_yx: torch.Tensor    # int32 [S, 2] rows (y, x)
    source_valid: torch.Tensor  # bool [S]

    @property
    def num_sources(self) -> int:
        return self.source_yx.shape[0]


@dataclasses.dataclass
class FluidState:
    """Dynamic simulation state (one scenario instance)."""

    u: torch.Tensor               # f32 [Y, X]
    v: torch.Tensor               # f32 [Y, X]
    r: torch.Tensor               # f32 [Y, X]
    g: torch.Tensor               # f32 [Y, X]
    b: torch.Tensor               # f32 [Y, X]
    markers: torch.Tensor         # f32 [2, K, Y, X] (x planes, y planes)
    alive: torch.Tensor           # bool [K, Y, X]
    marker_count: torch.Tensor    # i32 [Y, X]
    prev_marker_count: torch.Tensor  # i32 [Y, X]
    alive_count: torch.Tensor     # i32 scalar
    source_exhausted: torch.Tensor  # bool scalar
    rng: torch.Tensor             # u32 [2] xorshift64* state (hi, lo)
    frame_count: torch.Tensor     # i32 scalar
    dropped_markers: torch.Tensor  # i32 scalar
    p: torch.Tensor               # f32 [Y, X] last substep's pressure

    @property
    def fluid(self) -> torch.Tensor:
        return self.marker_count > 0

    @property
    def prev_fluid(self) -> torch.Tensor:
        return self.prev_marker_count > 0

    def replace(self, **changes) -> "FluidState":
        return dataclasses.replace(self, **changes)


def zeros_state(cfg: SimConfig, rng_pair, device="cuda") -> FluidState:
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    f = getattr(torch, cfg.dtype)

    def z(*shape, dtype=f):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FluidState(
        u=z(Y, X), v=z(Y, X), r=z(Y, X), g=z(Y, X), b=z(Y, X),
        markers=z(2, K, Y, X),
        alive=z(K, Y, X, dtype=torch.bool),
        marker_count=z(Y, X, dtype=torch.int32),
        prev_marker_count=z(Y, X, dtype=torch.int32),
        alive_count=z(dtype=torch.int32),
        source_exhausted=z(dtype=torch.bool),
        rng=torch.as_tensor(np.asarray(rng_pair, np.uint32)).to(device),
        frame_count=z(dtype=torch.int32),
        dropped_markers=z(dtype=torch.int32),
        p=z(Y, X),
    )


# ------------------------------------------------------------------
# Cell-type machinery (main.c:46-50, 119-156)
# ------------------------------------------------------------------

def shift_up(a: torch.Tensor, fill=0) -> torch.Tensor:
    """a[..., y+1, x] with `fill` beyond the top edge."""
    return torch.cat([a[..., 1:, :], torch.full_like(a[..., :1, :], fill)], -2)


def shift_down(a: torch.Tensor, fill=0) -> torch.Tensor:
    """a[..., y-1, x] with `fill` beyond the bottom edge."""
    return torch.cat([torch.full_like(a[..., :1, :], fill), a[..., :-1, :]], -2)


def shift_right(a: torch.Tensor, fill=0) -> torch.Tensor:
    """a[..., y, x+1] with `fill` beyond the right edge."""
    return torch.cat([a[..., 1:], torch.full_like(a[..., :1], fill)], -1)


def shift_left(a: torch.Tensor, fill=0) -> torch.Tensor:
    """a[..., y, x-1] with `fill` beyond the left edge."""
    return torch.cat([torch.full_like(a[..., :1], fill), a[..., :-1]], -1)


def u_property(p_value: torch.Tensor) -> torch.Tensor:
    """main.c:128-132 — OR of the P cells left/right of each U face."""
    return p_value | shift_right(p_value, False)


def v_property(p_value: torch.Tensor) -> torch.Tensor:
    """main.c:134-138 — OR of the P cells below/above each V face."""
    return p_value | shift_up(p_value, False)


def property_of(p_value: torch.Tensor, celltype: str) -> torch.Tensor:
    if celltype == "p":
        return p_value
    if celltype == "u":
        return u_property(p_value)
    if celltype == "v":
        return v_property(p_value)
    raise ValueError(celltype)


def valid_region(cfg: SimConfig, celltype: str, device="cpu") -> torch.Tensor:
    """bool [Y, X] mask of the logical sample region for a cell type."""
    m = torch.ones((cfg.ny, cfg.nx), dtype=torch.bool, device=device)
    if celltype == "u":
        m[:, -1] = False
    elif celltype == "v":
        m[-1, :] = False
    elif celltype != "p":
        raise ValueError(celltype)
    return m


def grid_size(cfg: SimConfig, celltype: str):
    """(size_x, size_y) per main.c:149-156."""
    if celltype == "p":
        return (cfg.nx, cfg.ny)
    if celltype == "u":
        return (cfg.nx - 1, cfg.ny)
    if celltype == "v":
        return (cfg.nx, cfg.ny - 1)
    raise ValueError(celltype)
