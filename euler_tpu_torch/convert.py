"""State and scenario conversion between numpy and the port's dataclasses.

Takes the fields of the JAX package's `FluidState` / `Scenario` as numpy
arrays (what `np.asarray` gives for each field) and returns the port's
tensors (on the card unless the caller asks for the CPU), and back.
The JAX slot store is flat [2, M] (alive [M]) with
m = (k*Y + y)*X + x; the port keeps the same memory as [2, K, Y, X]
(alive [K, Y, X]).  Imports neither jax nor euler_tpu.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from euler_tpu_torch.core.state import FluidState, Scenario

_STATE_FIELDS = [f.name for f in dataclasses.fields(FluidState)]
_SCENARIO_FIELDS = [f.name for f in dataclasses.fields(Scenario)]


def state_from_numpy(arrays: dict, device="cuda") -> FluidState:
    """FluidState from a dict of numpy arrays keyed by field name."""
    Y, X = np.shape(arrays["u"])
    out = {}
    for name in _STATE_FIELDS:
        a = np.asarray(arrays[name])
        if name in ("markers", "alive") and a.ndim in (1, 2):
            K = a.shape[-1] // (Y * X)
            a = a.reshape(a.shape[:-1] + (K, Y, X))
        out[name] = torch.as_tensor(a.copy(), device=device)
    return FluidState(**out)


def scenario_from_numpy(arrays: dict, device="cuda") -> Scenario:
    """Scenario from a dict of numpy arrays keyed by field name."""
    return Scenario(**{
        name: torch.as_tensor(np.asarray(arrays[name]).copy(), device=device)
        for name in _SCENARIO_FIELDS
    })


def state_to_numpy(state: FluidState) -> dict:
    """Dict of numpy arrays in the JAX package's layouts (flat store)."""
    out = {}
    for name in _STATE_FIELDS:
        a = getattr(state, name).detach().cpu().numpy()
        if name == "markers":
            a = a.reshape(2, -1)
        elif name == "alive":
            a = a.reshape(-1)
        out[name] = a
    return out


def scenario_to_numpy(scn: Scenario) -> dict:
    return {name: getattr(scn, name).detach().cpu().numpy()
            for name in _SCENARIO_FIELDS}
