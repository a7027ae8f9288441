"""Checkpoint and resume of the whole simulation state
(`euler_tpu/io/checkpoint.py`): the state, the scenario and the config
round-trip through one .npz file with the JAX package's keys
(`state.<field>`, `scn.<field>`, `config_json`), so a run stops and
resumes bit for bit (the RNG stream's position and the exhausted flag
included), and either package loads the other's files.

The store is written in the JAX package's flat [2, M] layout
(`convert.state_to_numpy`); `load` reads that and the spatial [2, K, Y,
X] store alike.  `save_orbax` / `load_orbax` stay with the JAX package:
orbax is a JAX library.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

from euler_tpu_torch import convert
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.state import FluidState, Scenario

_STATE_FIELDS = [f.name for f in dataclasses.fields(FluidState)]
_SCN_FIELDS = [f.name for f in dataclasses.fields(Scenario)]


def _cfg_to_json(cfg: SimConfig) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def _cfg_from_json(s: str) -> SimConfig:
    d = json.loads(s)
    d["solver"] = SolverConfig(**d["solver"])
    if "marker_tile" in d:
        d["marker_tile"] = tuple(d["marker_tile"])  # JSON decodes a list
    return SimConfig(**d)


def save(path: str, cfg: SimConfig, scn: Scenario, state: FluidState) -> None:
    """Write the checkpoint atomically: a sibling temp file renamed over
    `path`, so a crash mid-save (saves run on a background thread in the
    CLI) never truncates the previous good checkpoint."""
    arrays = {f"state.{k}": v
              for k, v in convert.state_to_numpy(state).items()}
    arrays.update({f"scn.{k}": v
                   for k, v in convert.scenario_to_numpy(scn).items()})
    arrays["config_json"] = np.frombuffer(_cfg_to_json(cfg).encode(),
                                          dtype=np.uint8)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(suffix=".npz.tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load(path: str, device="cuda"):
    """(cfg, scn, state) from a checkpoint of either package, the tensors
    on `device`."""
    with np.load(path) as z:
        cfg = _cfg_from_json(bytes(z["config_json"].tobytes()).decode())
        fields = {}
        for name in _STATE_FIELDS:
            key = f"state.{name}"
            if key in z:
                fields[name] = z[key]
            elif name == "dropped_markers":
                # checkpoints written before the drop counter existed
                fields[name] = np.zeros((), np.int32)
            elif name == "p":
                # checkpoints written before the pressure carry existed
                fields[name] = np.zeros_like(z["state.u"])
            else:
                raise KeyError(key)
        scn = {name: z[f"scn.{name}"] for name in _SCN_FIELDS}
    return (cfg, convert.scenario_from_numpy(scn, device=device),
            convert.state_from_numpy(fields, device=device))
