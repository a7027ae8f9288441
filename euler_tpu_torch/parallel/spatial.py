"""The slot store's two forms and the row mesh
(`euler_tpu/parallel/spatial.py`).

The port keeps the slot store as spatial planes, positions [2, K, Y, X]
and validity [K, Y, X] (`core/state.py`); the JAX package's flat [2, M]
store (m = (k*Y + y)*X + x), as a JAX checkpoint or `convert` gives it,
is the same memory.  `to_spatial` and `to_flat` reshape between the two.

`spatial_mesh` lays the ranks out as a ("y", "x") mesh (spatial.py:64),
and `shard_spatial` gives each rank its block of rows of every
[.., Y, X] plane, the slot planes included (spatial.py:80-110); scalars
and the source list stay whole on every rank.  `gather_spatial` puts
the blocks back together.  Only meshes with x = 1 are split here: the
marker pass runs on such blocks (`parallel/cuda_shard.py`), and the
frame step on them, `make_spatial_step`, needs the sharded solve (ROADMAP
M12 part c).
"""

from __future__ import annotations

import dataclasses

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.parallel.mesh import (
    PART_C,
    all_gather_cat,
    axis_size,
    mesh_device,
    square_factor,
    world,
)

# the fields whose last two dimensions are the grid's rows and columns
STATE_PLANES = ("u", "v", "r", "g", "b", "markers", "alive", "marker_count",
                "prev_marker_count", "p")
SCENARIO_PLANES = ("solid", "source", "sink")


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


def spatial_mesh(world_size: int | None = None, x: int | None = None,
                 device: str = "cuda") -> DeviceMesh:
    """A ("y", "x") mesh over the default group's ranks, `x` columns
    (square-ish by default, as spatial.py:64 lays its devices out)."""
    n = world(world_size, device)
    if x is None:
        x = square_factor(n)
    if x < 1 or n % x:
        raise ValueError(f"{n} ranks don't split into x={x} columns")
    return init_device_mesh(device, (n // x, x), mesh_dim_names=("y", "x"))


def row_block(cfg: SimConfig, mesh: DeviceMesh) -> tuple[int, int]:
    """(first row, rows) of this rank's block: the grid's rows split
    evenly over "y".  Raises on a mesh that also splits columns."""
    if axis_size(mesh, "x") > 1:
        raise NotImplementedError(f"column blocks (x = "
                                  f"{axis_size(mesh, 'x')}): {PART_C}")
    n = axis_size(mesh, "y")
    if cfg.ny % n:
        raise ValueError(f"{cfg.ny} rows do not split over y={n}")
    rows = cfg.ny // n
    return mesh.get_local_rank("y") * rows, rows


def _rows(x, fields, lo: int, hi: int, device):
    return dataclasses.replace(x, **{
        name: getattr(x, name)[..., lo:hi, :].to(device).contiguous()
        for name in fields})


def shard_spatial(cfg: SimConfig, mesh: DeviceMesh, scn: Scenario,
                  state: FluidState):
    """This rank's block of one (unbatched) scenario and state on its
    device: rows [r Yl, (r+1) Yl) of every plane, the slot store as
    [2, K, Yl, X] and [K, Yl, X]; scalars, the RNG and the source list
    whole (sources keep their global cells)."""
    lo, rows = row_block(cfg, mesh)
    dev = mesh_device(mesh)
    state = to_spatial(cfg, state)
    scn = _rows(scn, SCENARIO_PLANES, lo, lo + rows, dev)
    scn = dataclasses.replace(scn, source_yx=scn.source_yx.to(dev),
                              source_valid=scn.source_valid.to(dev))
    state = _rows(state, STATE_PLANES, lo, lo + rows, dev)
    return scn, state.replace(**{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state) if f.name not in STATE_PLANES})


def gather_spatial(cfg: SimConfig, mesh: DeviceMesh, state: FluidState):
    """Inverse of `shard_spatial` for the state: every rank's block
    all-gathered over "y", in row order, on every rank; the scalars are
    this rank's (the same on every rank)."""
    row_block(cfg, mesh)
    group = mesh.get_group("y")
    return state.replace(**{
        name: all_gather_cat(getattr(state, name), group, -2)
        for name in STATE_PLANES})
