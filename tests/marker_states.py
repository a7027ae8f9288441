"""Seeded slot-marker states for the K1 / K4 tests, made with numpy and
importing nothing of JAX (tests/test_torch_marker_tiles.py on the CPU,
tests/test_torch_cuda.py on the card).

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
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig


def marker_config(Y: int, X: int, K: int) -> SimConfig:
    return SimConfig(nx=X, ny=Y, marker_layout="slots", slots_per_cell=K)


def marker_state(Y: int, X: int, K: int, fill: str = "mixed",
                 seed: int = 0, device="cpu"):
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
    ys, xs = np.mgrid[0:Y, 0:X].astype(np.float32)
    px = ((xs[None] + rng.uniform(0.02, 0.98, (K, Y, X))) * h).astype(
        np.float32)
    py = ((ys[None] + rng.uniform(0.02, 0.98, (K, Y, X))) * h).astype(
        np.float32)
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
