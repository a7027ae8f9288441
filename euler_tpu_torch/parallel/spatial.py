"""The slot store's two forms (`euler_tpu/parallel/spatial.py:41-61`).

The port keeps the slot store as spatial planes, positions [2, K, Y, X]
and validity [K, Y, X] (`core/state.py`); the JAX package's flat [2, M]
store (m = (k*Y + y)*X + x), as a JAX checkpoint or `convert` gives it,
is the same memory.  `to_spatial` and `to_flat` reshape between the two.
The mesh and its shardings (`spatial.py:64-121` there) are not ported.
"""

from __future__ import annotations

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState


def to_spatial(cfg: SimConfig, state: FluidState) -> FluidState:
    """Re-view flat [2, M] slot markers as spatial planes [2, K, Y, X]; a
    state already in that form is returned as it is."""
    if cfg.marker_layout != "slots":
        raise ValueError("spatial planes need the slot marker layout, got "
                         f"{cfg.marker_layout!r}")
    if state.markers.ndim == 4:
        return state
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return state.replace(markers=state.markers.reshape(2, K, Y, X),
                         alive=state.alive.reshape(K, Y, X))


def to_flat(cfg: SimConfig, state: FluidState) -> FluidState:
    """Inverse of `to_spatial`: the flat [2, M] layout of checkpoints and
    of the JAX package."""
    if state.markers.ndim != 4:
        return state
    M = cfg.max_markers
    return state.replace(markers=state.markers.reshape(2, M),
                         alive=state.alive.reshape(M))
