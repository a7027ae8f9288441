"""Seeded grid-stage states for the tests of K7, the tiled grid stage
(`csrc/grid_stage.cuh` `grid_passes`), made with numpy and the port's
plain versions and importing nothing of JAX (tests/test_torch_grid_tiles.py
on the CPU, tests/test_torch_cuda.py on the card).

`grid_state(Y, X, tile, seed)` gives the inputs of
`grid_stage(cfg, u, v, fluid, prev_fluid, solid, dt)`: the dam break of
`core/presets.py` stepped `frames` frames in the Jacobi speed mode on the
CPU (the plain versions), then, on the rows and columns either side of
every border between tiles of tile = (tile_y, tile_x) cells, seeded cells
made fluid that were not fluid before (newly fluid, so extrapolated from
their neighbours) and seeded cells made solid.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.forces import max_speed_sq


def grid_config(Y: int, X: int) -> SimConfig:
    """The Jacobi speed mode (`bench.py --precon jacobi`) on a Y x X grid."""
    return SimConfig(
        nx=X, ny=Y, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, tol=1e-6, tol_rel=1e-6,
                            dtype="float32", preconditioner="jacobi",
                            warm_start=False, fuse_projection=True))


def tile_borders(n: int, tile: int) -> np.ndarray:
    """The indices < n on either side of a border between tiles of `tile`
    cells (the first and last index of each tile)."""
    i = np.arange(n)
    return (i % tile == 0) | (i % tile == tile - 1)


def grid_state(Y: int, X: int, tile, seed: int = 0, frames: int = 2,
               device="cpu"):
    """(cfg, u, v, fluid, prev_fluid, solid, dt) on `device`."""
    cfg = grid_config(Y, X)
    scn, st = dam_break(cfg, device="cpu")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    rng = np.random.default_rng(seed)
    border = tile_borders(Y, tile[0])[:, None] | tile_borders(X, tile[1])[None]
    fluid = st.fluid.numpy().copy()
    prev = st.prev_fluid.numpy().copy()
    solid = scn.solid.numpy().copy()
    newly = border & (rng.random((Y, X)) < 0.3)
    fluid |= newly
    prev &= ~newly
    solid |= border & ~newly & (rng.random((Y, X)) < 0.15)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time))

    def put(a):
        return torch.as_tensor(a).to(device)

    return (cfg, put(st.u), put(st.v), put(fluid), put(prev), put(solid),
            put(dt))
