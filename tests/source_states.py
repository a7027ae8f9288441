"""Seeded inputs of source emission (S1) for the port's tests: the
waterfall scenario's sources with a random store, alive plane, colours
and RNG, and chosen counts at the sources, as numpy dicts of the JAX
package's field layouts (`convert.state_from_numpy` /
`scenario_from_numpy` take them).  Imports nothing of JAX, so the card
tests use it too."""

from __future__ import annotations

import numpy as np

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.rng import XorShift64Star
from euler_tpu_torch.core.scenario import parse_scenario_text

WATERFALL = "scenarios/waterfall.txt"


def source_scenario(cfg: SimConfig, n_src=None, pad=0, path=WATERFALL):
    """The scenario's masks at cfg's size with its first n_src sources,
    padded with `pad` invalid entries at cell (0, 0)."""
    with open(path, "rb") as f:
        solid, _fluid, source, sink = parse_scenario_text(f.read(), cfg)
    ys, xs = np.nonzero(source)
    yx = np.stack([ys, xs], 1).astype(np.int32)[:n_src]
    source = np.zeros_like(source)
    source[yx[:, 0], yx[:, 1]] = True
    valid = np.r_[np.ones(len(yx), bool), np.zeros(pad, bool)]
    yx = np.concatenate([yx, np.zeros((pad, 2), np.int32)])
    return {"solid": solid, "source": source, "sink": sink,
            "source_yx": yx, "source_valid": valid}


def source_state(cfg: SimConfig, scn: dict, seed: int, counts,
                 alive_count: int, exhausted=False, frame_count=7):
    """A seeded state with `counts` at the sources (random elsewhere)."""
    g = np.random.default_rng(seed)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    count = g.integers(0, K + 1, (Y, X)).astype(np.int32)
    yx = scn["source_yx"]
    count[yx[:, 0], yx[:, 1]] = counts
    gen = XorShift64Star(int(g.integers(1, 2**63)))
    return {
        "u": np.zeros((Y, X), np.float32), "v": np.zeros((Y, X), np.float32),
        "r": g.random((Y, X), np.float32), "g": g.random((Y, X), np.float32),
        "b": g.random((Y, X), np.float32),
        "markers": g.random((2, K * Y * X), np.float32) * X,
        "alive": g.random(K * Y * X) < 0.5,
        "marker_count": count, "prev_marker_count": count.copy(),
        "alive_count": np.int32(alive_count),
        "source_exhausted": np.bool_(exhausted),
        "rng": gen.state_u32_pair(),
        "frame_count": np.int32(frame_count),
        "dropped_markers": np.int32(0), "p": np.zeros((Y, X), np.float32),
    }


def source_case(case: str):
    """(cfg, scenario dict, state dict, active) of a named case:
    "active", "inactive", "exhaustion" (alive_count max_markers - 3, 5
    sources), "exhausted", "per_cell" and "K" (counts at the caps),
    "padded" (6 invalid entries)."""
    per_cell, K = (8, 6) if case == "K" else (4, 8)
    cfg = SimConfig(marker_layout="slots", markers_per_cell=per_cell,
                    slots_per_cell=K)
    n_src = 5 if case in ("exhaustion", "exhausted") else None
    scn = source_scenario(cfg, n_src, pad=6 if case == "padded" else 0)
    S = len(scn["source_yx"])
    counts = {
        "per_cell": np.resize(np.int32([3, 4, 5]), S),
        "K": np.resize(np.int32([4, 5, 6]), S),
    }.get(case, np.random.default_rng(1).integers(0, 6, S))
    if case in ("exhaustion", "exhausted"):
        counts = np.zeros(S, np.int32)
    alive_count = (cfg.max_markers - 3 if n_src else 1000)
    st = source_state(cfg, scn, 2, counts, alive_count,
                      exhausted=case == "exhausted")
    return cfg, scn, st, case != "inactive"


CASES = ["active", "inactive", "exhaustion", "exhausted", "per_cell", "K",
         "padded"]
