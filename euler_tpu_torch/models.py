"""Model registry (`euler_tpu/models.py`): the reference's five bundled
scenario files (scenarios/*.txt) and the two programmatic presets, under
one API:

    scn, state = euler_tpu_torch.models.load("waterfall", cfg)
    scn, state = euler_tpu_torch.models.load("dam_break", cfg)  # any size

`scenarios/` is found at the repo root, beside this package.  The port
builds the slot layout only, so the default config is the default
`SimConfig` on slots; the tensors go to the card unless `device="cpu"`.
"""

from __future__ import annotations

import os

from euler_tpu_torch.config import SimConfig

SCENARIO_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "scenarios")

_BUNDLED = ["basic", "block", "filter", "waterfall", "weird-edges"]
_PRESETS = ["dam_break", "block_obstacles"]


def names() -> list[str]:
    return list(_BUNDLED) + list(_PRESETS)


def load(name: str, cfg: SimConfig | None = None, **kwargs):
    """(Scenario, FluidState) of a bundled scenario or a preset; kwargs go
    to `load_scenario` or the preset (`device`, `pad_sources`, `seed`)."""
    cfg = cfg or SimConfig(marker_layout="slots")
    if name in _BUNDLED:
        from euler_tpu_torch.core.scenario import load_scenario

        return load_scenario(os.path.join(SCENARIO_DIR, f"{name}.txt"), cfg,
                             **kwargs)
    if name in _PRESETS:
        from euler_tpu_torch.core import presets

        return getattr(presets, name)(cfg, **kwargs)
    raise KeyError(f"unknown model {name!r}; available: {names()}")
