"""Programmatic scenario presets (`euler_tpu/core/presets.py`).

Masks and marker positions are built with numpy from an explicit
`numpy.random.Generator` seed, exactly as the JAX preset builds them, so
both packages start from bit-identical states.  Slot layout only.  The
tensors go to `device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core import rng as rng_mod
from euler_tpu_torch.core.state import Scenario, zeros_state
from euler_tpu_torch.ops.color import colorize


def _finish(cfg: SimConfig, solid, fluid, source, sink, seed=0,
            device="cuda"):
    """Assemble Scenario + FluidState from masks with fast marker seeding."""
    if cfg.marker_layout != "slots":
        raise NotImplementedError(
            "presets build the slot layout only; the global layout is "
            "ROADMAP queue 1 item M9")
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    sink = sink.copy()
    sink[:, 0] = sink[:, X - 1] = True
    sink[0, :] = sink[Y - 1, :] = True
    fluid = fluid & ~solid & ~sink

    ys, xs = np.nonzero(fluid)
    n_cells = len(ys)
    k = cfg.markers_per_cell
    n = n_cells * k
    if n > cfg.max_markers or k > K:
        raise ValueError("preset overfills marker capacity")

    rng = np.random.default_rng(seed)
    # sub-cell quadrant pattern of main.c:259-262 + jitter/2
    offs = np.array(
        [[0.0, 0.5], [0.0, 0.0], [0.5, 0.5], [0.5, 0.0]], np.float32
    )[:k]
    base = np.stack([xs, ys], axis=1).astype(np.float32)  # [C, 2] (x, y)
    pos = (
        base[:, None, :]
        + offs[None, :, :]
        + rng.random((n_cells, k, 2), np.float32) * 0.5
    ) * np.float32(cfg.side_length)                        # [C, k, 2]

    markers = np.zeros((2, K, Y, X), np.float32)
    alive = np.zeros((K, Y, X), bool)
    for j in range(k):
        markers[0, j, ys, xs] = pos[:, j, 0]
        markers[1, j, ys, xs] = pos[:, j, 1]
        alive[j, ys, xs] = True

    sy, sx = np.nonzero(source)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    scn = Scenario(
        solid=t(solid), source=t(source), sink=t(sink),
        source_yx=t(np.stack([sy, sx], axis=1).astype(np.int32)),
        source_valid=t(np.ones((len(sy),), bool)),
    )
    state = zeros_state(cfg, rng_mod.initial_device_state(), device)
    state = state.replace(
        markers=t(markers), alive=t(alive),
        alive_count=t(n, torch.int32),
    )
    from euler_tpu_torch.ops.markers_slots import refresh_marker_counts_slots

    state = refresh_marker_counts_slots(cfg, scn, state)
    if cfg.rainbow:
        state = colorize(cfg, scn, state)
    return scn, state


def _solid_box(Y, X):
    """Solid floor and side walls just inside the border sink ring."""
    solid = np.zeros((Y, X), bool)
    solid[1, 1: X - 1] = True
    solid[1:-1, 1] = True
    solid[1:-1, X - 2] = True
    return solid


def dam_break(cfg: SimConfig, fill_x: float = 0.4, fill_y: float = 0.6,
              seed=0, device="cuda"):
    """A water column against the left wall — the classic dam break."""
    Y, X = cfg.ny, cfg.nx
    solid = _solid_box(Y, X)
    fluid = np.zeros((Y, X), bool)
    fluid[2: 2 + int((Y - 3) * fill_y), 2: 2 + int((X - 3) * fill_x)] = True
    source = np.zeros((Y, X), bool)
    sink = np.zeros((Y, X), bool)
    return _finish(cfg, solid, fluid, source, sink, seed, device)


def block_obstacles(cfg: SimConfig, seed=0, device="cuda"):
    """Falling water over interior solid obstacles (block.txt, scaled)."""
    Y, X = cfg.ny, cfg.nx
    solid = _solid_box(Y, X)
    fluid = np.zeros((Y, X), bool)
    fluid[Y // 2: Y - 2, 2: X - 2] = True
    bw = max(2, X // 16)
    for x0 in range(X // 8, X - X // 8, 2 * bw):
        solid[Y // 4: Y // 4 + max(2, Y // 16), x0: x0 + bw] = True
    source = np.zeros((Y, X), bool)
    sink = np.zeros((Y, X), bool)
    return _finish(cfg, solid, fluid, source, sink, seed, device)
