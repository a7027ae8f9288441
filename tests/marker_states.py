"""Seeded slot-marker states for the tests of the marker kernels K1, K4,
K5 and K6, made with numpy and importing nothing of JAX
(tests/test_torch_marker_tiles.py on the CPU, tests/test_torch_cuda.py
on the card).

`marker_state(Y, X, K, fill, seed)` gives the inputs of
`march_rebin(cfg, u, v, fluid, solid, slots, dt, count, dead=dead)`:
walls on the border (where the grid is wider than two cells), scattered
solid and sink cells inside (the middle cell always a sink; dead cells
hold no marker, as after a pass), the fluid mask count > 0, and the live
markers spread over their home cells with velocities of up to about one
cell a substep in any direction, so that markers leave their cells
across edges and corners.  `fill`:
  "mixed": counts 0..K, with a quarter of the interior empty;
  "full": every open cell holds K markers, so that cells receiving
          arrivals overflow and drop;
  "empty": no marker at all.
With `stale=True` the dead slots hold seeded positions in their cell (as
in a store that K5 copied through) instead of zeros.

`rebin_state(Y, X, K, fill, seed, holes)` gives the inputs of the re-bin
`rebin_markers(cfg, markers, alive, dead)`: marker_state's live markers
marched one substep by the plain march.  With `holes=True` the alive
plane is not front-compacted: a seeded 30% of its live slots are cleared
and, but for fill "empty", 10% of the dead slots are set alive with a
position in their cell (marched too), so that live slots lie beyond a
cell's count.  Every live marker stays within one cell of its home, as
the CFL limit keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.markers_slots import live_slots, march_slots


def marker_config(Y: int, X: int, K: int) -> SimConfig:
    return SimConfig(nx=X, ny=Y, marker_layout="slots", slots_per_cell=K)


def _in_cell(rng, shape, h):
    """Seeded positions (px, py) [K, Y, X] inside each slot's cell."""
    K, Y, X = shape
    ys, xs = np.mgrid[0:Y, 0:X].astype(np.float32)
    px = ((xs[None] + rng.uniform(0.02, 0.98, shape)) * h).astype(np.float32)
    py = ((ys[None] + rng.uniform(0.02, 0.98, shape)) * h).astype(np.float32)
    return px, py


def marker_state(Y: int, X: int, K: int, fill: str = "mixed",
                 seed: int = 0, device="cpu", stale: bool = False):
    """(cfg, u, v, fluid, solid, slots [2K, Y, X], dt, count, dead)."""
    rng = np.random.default_rng(seed)
    cfg = marker_config(Y, X, K)
    h = np.float32(cfg.side_length)
    solid = np.zeros((Y, X), bool)
    if Y > 2 and X > 2:
        solid[0, :] = solid[-1, :] = solid[:, 0] = solid[:, -1] = True
    inner = rng.random((Y, X)) < 0.03
    solid |= inner
    sink = ~solid & (rng.random((Y, X)) < 0.01)
    solid[Y // 2, X // 2] = False
    sink[Y // 2, X // 2] = True
    if fill == "empty":
        count = np.zeros((Y, X), np.int32)
    elif fill == "full":
        count = np.full((Y, X), K, np.int32)
    else:
        count = rng.integers(0, K + 1, (Y, X)).astype(np.int32)
        count[rng.random((Y, X)) < 0.25] = 0
    count[solid | sink] = 0  # a pass deletes what a dead cell holds
    k = np.arange(K)[:, None, None]
    live = k < count[None]
    px, py = _in_cell(rng, (K, Y, X), h)
    if stale:
        spx, spy = _in_cell(np.random.default_rng(seed + 1), (K, Y, X), h)
        px[~live] = spx[~live]
        py[~live] = spy[~live]
    else:
        px[~live] = 0.0
        py[~live] = 0.0
    speed = np.float32(0.9) * h  # cells a substep at dt = 1
    u = rng.uniform(-1.0, 1.0, (Y, X)).astype(np.float32) * speed
    v = rng.uniform(-1.0, 1.0, (Y, X)).astype(np.float32) * speed
    slots = np.concatenate([px, py]).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    count_t = t(count)
    return (cfg, t(u), t(v), count_t > 0, t(solid), t(slots),
            torch.ones((), dtype=torch.float32, device=device), count_t,
            t(sink | solid))


def rebin_state(Y: int, X: int, K: int, fill: str = "mixed", seed: int = 0,
                holes: bool = False, device="cpu"):
    """(cfg, markers [2, K, Y, X], alive [K, Y, X], dead)."""
    cfg, u, v, fluid, solid, slots, dt, count, dead = marker_state(
        Y, X, K, fill, seed)
    live = live_slots(count, K)
    alive = live
    px, py = slots[:K], slots[K:]
    if holes:
        rng = np.random.default_rng(seed + 2)
        alive = live & torch.as_tensor(rng.random((K, Y, X)) >= 0.3)
        if fill != "empty":
            extra = ~live & torch.as_tensor(rng.random((K, Y, X)) < 0.1)
            spx, spy = _in_cell(rng, (K, Y, X), np.float32(cfg.side_length))
            px = torch.where(extra, torch.as_tensor(spx), px)
            py = torch.where(extra, torch.as_tensor(spy), py)
            alive = alive | extra
    px, py = march_slots(cfg, u, v, fluid, solid, px, py, alive, dt)
    return (cfg, torch.stack([px, py]).to(device), alive.to(device),
            dead.to(device))
