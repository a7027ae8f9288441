"""Scenario parsing and initial-state construction
(`euler_tpu/core/scenario.py`), replicating sim_init (main.c:209-274):

* characters: 'X' solid, '0' fluid, '?' fluid + source, '=' sink
  (main.c:226-235);
* the first text line lands on row y = Y-2 and rows descend to y = 1
  (main.c:220): the text is y-flipped into the grid, whose y axis
  points up;
* cells go in columns 1..X-2; anything beyond the width is discarded up
  to the next newline (main.c:237-240);
* a border ring of sinks on all four edges (main.c:244-252);
* 4 jittered markers per fluid cell in x-major cell order with the
  sub-cell pattern of main.c:259-262, drawing the xorshift64* stream in
  the same order (x jitter, then y jitter, per marker);
* the marker counts are refreshed and, in rainbow mode, the cells
  coloured (main.c:268-273).

Slot layout only: marker k of a cell goes to slot k of the [2, K, Y, X]
store.  The tensors go to `device`, the card unless the caller asks for
the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core import rng as rng_mod
from euler_tpu_torch.core.state import Scenario, zeros_state


def parse_scenario_text(text, cfg: SimConfig):
    """Scenario text -> (solid, fluid, source, sink) bool [Y, X] arrays,
    byte for byte main.c:218-241 (over-wide lines truncated, a last line
    without a newline kept)."""
    Y, X = cfg.ny, cfg.nx
    solid = np.zeros((Y, X), dtype=bool)
    fluid = np.zeros((Y, X), dtype=bool)
    source = np.zeros((Y, X), dtype=bool)
    sink = np.zeros((Y, X), dtype=bool)

    data = text.encode() if isinstance(text, str) else text
    length = len(data)
    i = 0
    y = Y - 2
    while y > 0 and i < length:
        x = 1
        while x < X - 1 and i < length:
            c = chr(data[i])
            i += 1
            if c == "\n":
                break
            elif c == "X":
                solid[y, x] = True
            elif c == "0":
                fluid[y, x] = True
            elif c == "?":
                fluid[y, x] = True
                source[y, x] = True
            elif c == "=":
                sink[y, x] = True
            x += 1
        # discard anything beyond the simulation width (main.c:237-240)
        if x == X - 1:
            while i < length and chr(data[i]) != "\n":
                i += 1
            if i < length:
                i += 1
        y -= 1

    # border sinks on all four edges (main.c:244-252)
    sink[:, 0] = True
    sink[:, X - 1] = True
    sink[0, :] = True
    sink[Y - 1, :] = True
    return solid, fluid, source, sink


def seed_markers(fluid: np.ndarray, cfg: SimConfig,
                 gen: rng_mod.XorShift64Star) -> np.ndarray:
    """4 jittered markers per fluid cell (main.c:254-267), as [n, 2]
    (x, y) f32.  Cells in x-major order (main.c:256-257); marker k sits
    in the sub-cell quadrant (k < 2 ? 0 : .5, k % 2 ? 0 : .5) plus
    randf()/2 jitter, x drawn before y.  Only fluid cells draw, so the
    loop walks the fluid cells in that order (the same draws as a walk
    over every cell)."""
    xs, ys = np.nonzero(fluid.T)  # x-major cell order
    positions = []
    for i, j in zip(xs.tolist(), ys.tolist()):
        for k in range(4):
            x = i + (0.0 if k < 2 else 0.5) + gen.randf() / np.float32(2.0)
            y = j + (0.0 if k % 2 else 0.5) + gen.randf() / np.float32(2.0)
            positions.append(
                (np.float32(cfg.side_length) * np.float32(x),
                 np.float32(cfg.side_length) * np.float32(y)))
    return np.array(positions, dtype=np.float32).reshape(-1, 2)


def _source_scan_order(source: np.ndarray) -> np.ndarray:
    """Source cells in update_fluid_sources scan order (main.c:284-285):
    y-major, [S, 2] rows (y, x)."""
    ys, xs = np.nonzero(source)
    return np.stack([ys, xs], axis=1).astype(np.int32)


def load_scenario(path: str, cfg: SimConfig, pad_sources: int | None = None,
                  device="cuda"):
    with open(path, "rb") as f:
        text = f.read()
    return build_scenario(text, cfg, pad_sources, device=device)


def build_scenario(text, cfg: SimConfig, pad_sources: int | None = None,
                   device="cuda"):
    """(Scenario, FluidState) from scenario text.  The xorshift64* stream
    starts at the reference seed; what remains after the marker seeding
    becomes the state's RNG, so source emission continues the same
    stream.  `pad_sources` pads the source list with invalid entries
    (cell (0, 0), `source_valid` False) to that length."""
    if cfg.marker_layout != "slots":
        raise NotImplementedError(
            "the port builds the slot layout only; marker_layout='global' "
            "is ROADMAP queue 1 item M9")
    solid, fluid, source, sink = parse_scenario_text(text, cfg)

    gen = rng_mod.XorShift64Star()
    positions = seed_markers(fluid, cfg, gen)
    n = positions.shape[0]
    if n > cfg.max_markers:
        raise ValueError(
            f"scenario seeds {n} markers, exceeds capacity {cfg.max_markers}")

    source_yx = _source_scan_order(source)
    n_src = source_yx.shape[0]
    pad = n_src if pad_sources is None else pad_sources
    if pad < n_src:
        raise ValueError(f"pad_sources={pad} < actual source count {n_src}")
    valid = np.zeros((pad,), bool)
    valid[:n_src] = True
    padded = np.zeros((pad, 2), np.int32)
    padded[:n_src] = source_yx

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    scn = Scenario(solid=t(solid), source=t(source), sink=t(sink),
                   source_yx=t(padded), source_valid=t(valid))

    # each cell's markers go to its own slots k = 0..3; the seeding order
    # (and so the RNG stream, main.c:256-266) is unchanged
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    k = cfg.markers_per_cell
    xs_f, ys_f = np.nonzero(fluid.T)  # x-major cell order
    pos = positions.reshape(len(xs_f), k, 2)
    markers = np.zeros((2, K, Y, X), np.float32)
    alive = np.zeros((K, Y, X), bool)
    for j in range(k):
        markers[0, j, ys_f, xs_f] = pos[:, j, 0]
        markers[1, j, ys_f, xs_f] = pos[:, j, 1]
        alive[j, ys_f, xs_f] = True

    state = zeros_state(cfg, gen.state_u32_pair(), device)
    state = state.replace(markers=t(markers), alive=t(alive),
                          alive_count=t(n, torch.int32))

    # refresh_marker_counts at init (main.c:268): the previous counts
    # take the old (zero) counts, the counts become the histogram of the
    # seeded markers, and markers in sink / solid cells are dropped
    from euler_tpu_torch.ops.color import colorize
    from euler_tpu_torch.ops.markers_slots import refresh_marker_counts_slots

    state = refresh_marker_counts_slots(cfg, scn, state)
    if cfg.rainbow:
        state = colorize(cfg, scn, state)
    return scn, state
