"""Marker particles in the global layout (`euler_tpu/ops/markers.py`):
one flat store of M = markers_per_cell * Y * X positions (main.c:92's
capacity) with an alive mask, kept in the reference's marker order.

  * `refresh_marker_counts` (main.c:102-117): the per-cell histogram of
    the markers outside sink and solid cells, and the reference's
    swap-remove deletion order (`_swap_remove_compact`);
  * `advect_markers` (main.c:464-537): the DDA collision march of every
    marker, `marker_march_iters` masked iterations, with the reference's
    cross-marker dt carry (`marker_dt_carry`) as the JAX package's
    fixpoint: march with a per-marker dt, hand each marker's post-march
    dt to every later marker (last changed wins), repeat until the dt
    vector is bitwise stable or 16 passes have run;
  * `update_fluid_sources` (main.c:276-298): the ordered emission, each
    emitted marker into the first free slots in index order.

The functions here are the plain versions; the public entry points go
through the wrappers of G1 (the march, `ops/cuda/global_marker_kernel.
advect_global`), G2 (the refresh, `refresh_global`) and S1's global form
(`ops/cuda/source_kernel.emit_sources`), which launch the hand-written
kernels on CUDA tensors and take these versions on CPU tensors.
`get_marker_ops` and `get_marker_pass` pick the layout's functions as the
JAX package's do.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.interp import interpolate

_FLT_MAX = float(np.finfo(np.float32).max)
# the dt-carry fixpoint's pass cap (euler_tpu/ops/markers.py:166): part
# of the function, not a tuning knob
DT_CARRY_PASSES = 16


def marker_cells(cfg: SimConfig, markers):
    """floor(position / h) per marker (main.c:106-107), (yi, xi) int32;
    markers is coordinate-major [2, M]."""
    inv_h = float(np.float32(1.0) / np.float32(cfg.side_length))
    xi = torch.floor(markers[0] * inv_h).to(torch.int32)
    yi = torch.floor(markers[1] * inv_h).to(torch.int32)
    return yi, xi


def swap_remove_compact(markers, live_in, doomed):
    """The reference's deletion compaction (main.c:109-115): a doomed slot
    is overwritten by the last live marker, retrying while that one is
    doomed too.  Net permutation: survivors below the new length n2 stay;
    doomed head slots, in increasing order, take the tail survivors in
    decreasing order.  `live_in` must be a prefix mask.  Returns a new
    (markers, alive, n2)."""
    M = live_in.shape[0]
    idx = torch.arange(M, device=live_in.device)
    doomed = doomed & live_in
    surv = live_in & ~doomed
    n2 = surv.sum(dtype=torch.int32)
    head = idx < n2
    dh_idx = torch.nonzero(doomed & head, as_tuple=True)[0]
    ts_desc = torch.nonzero(surv & ~head, as_tuple=True)[0].flip(0)
    out = markers.clone()
    out[:, dh_idx] = markers[:, ts_desc]
    return out, head, n2


def refresh_plain(cfg: SimConfig, scn: Scenario, markers, alive):
    """The plain version of G2: (markers', alive', counts, n2) with the
    counts of the surviving markers at their (grid-clipped) cells and the
    compacted store."""
    yi, xi = marker_cells(cfg, markers)
    yi = torch.clamp(yi, 0, cfg.ny - 1).long()
    xi = torch.clamp(xi, 0, cfg.nx - 1).long()
    doomed = scn.sink[yi, xi] | scn.solid[yi, xi]
    surv = alive & ~doomed
    counts = torch.zeros(cfg.ny * cfg.nx, dtype=torch.int32,
                         device=markers.device)
    counts.index_add_(0, yi * cfg.nx + xi, surv.to(torch.int32))
    out, alive2, n2 = swap_remove_compact(markers, alive, doomed)
    return out, alive2, counts.view(cfg.ny, cfg.nx), n2


def refresh_marker_counts(cfg: SimConfig, scn: Scenario, state: FluidState):
    """main.c:102-117 through G2's wrapper: the histogram, the exact
    swap-remove compaction; the previous counts keep the old ones."""
    from euler_tpu_torch.ops.cuda.global_marker_kernel import refresh_global

    markers, alive, counts, n2 = refresh_global(cfg, scn, state.markers,
                                                state.alive)
    return state.replace(markers=markers, alive=alive,
                         prev_marker_count=state.marker_count,
                         marker_count=counts, alive_count=n2)


def velocity_at(cfg: SimConfig, u, v, fluid, px, py):
    """Staggered velocity at world positions (main.c:440-449), by the
    gather form of the bilinear sample."""
    inv_h = float(np.float32(1.0) / np.float32(cfg.side_length))
    vx = interpolate(cfg, u, fluid, px * inv_h - 1.0, py * inv_h - 0.5, "u")
    vy = interpolate(cfg, v, fluid, px * inv_h - 0.5, py * inv_h - 1.0, "v")
    return vx, vy


def _time_to(p0, p1, vel):
    """main.c:451-457: (p1 - p0) / v, FLT_MAX for zero velocity."""
    nz = vel.abs() > 0.0
    return torch.where(nz, (p1 - p0) / torch.where(nz, vel, 1.0), _FLT_MAX)


def march_markers(cfg: SimConfig, scn: Scenario, u, v, fluid, markers,
                  alive, dt):
    """One DDA march of every marker (main.c:464-537), `dt` a scalar or
    one per marker.  Returns (markers', dt_rem): the dead markers keep
    their positions; dt_rem is each marker's remaining dt after its
    collision decrements (what the reference's next marker sees)."""
    h = float(np.float32(cfg.side_length))
    inv_h = float(np.float32(1.0) / np.float32(cfg.side_length))
    solid = scn.solid
    px, py = markers[0], markers[1]
    vx, vy = velocity_at(cfg, u, v, fluid, px, py)

    def idx(p):
        return torch.floor(p * inv_h).to(torch.int32)

    def gather_solid(yy, xx):
        yy = torch.clamp(yy, 0, cfg.ny - 1).long()
        xx = torch.clamp(xx, 0, cfg.nx - 1).long()
        return solid[yy, xx]

    x_idx, y_idx = idx(px), idx(py)
    x_dir = torch.where(vx > 0, 1, -1).to(torch.int32)
    nx_idx = x_idx + (vx > 0).to(torch.int32)
    npx = nx_idx.to(px.dtype) * h
    t_x = _time_to(px, npx, vx)
    x_off = torch.where(vx < 0, -1, 0).to(torch.int32)
    y_dir = torch.where(vy > 0, 1, -1).to(torch.int32)
    ny_idx = y_idx + (vy > 0).to(torch.int32)
    npy = ny_idx.to(py.dtype) * h
    t_y = _time_to(py, npy, vy)
    y_off = torch.where(vy < 0, -1, 0).to(torch.int32)

    t_prev = torch.zeros_like(px)
    t_near = torch.minimum(t_x, t_y)
    dt_rem = torch.zeros_like(px) + dt
    mx, my = px, py
    for _ in range(cfg.marker_march_iters):
        active = t_near < dt_rem
        horiz = t_x < t_y
        hit_h = active & horiz & gather_solid(y_idx, nx_idx + x_off)
        adv_h = active & horiz & ~hit_h
        hit_v = active & ~horiz & gather_solid(ny_idx + y_off, x_idx)
        adv_v = active & ~horiz & ~hit_v
        hit = hit_h | hit_v

        mx = torch.where(hit, mx + t_prev * vx, mx)
        my = torch.where(hit, my + t_prev * vy, my)
        dt_rem = torch.where(hit, dt_rem - t_prev, dt_rem)
        vx = torch.where(hit_h, 0.0, vx)
        vy = torch.where(hit_v, 0.0, vy)

        x_idx = torch.where(adv_h, nx_idx, x_idx)
        nx_idx = torch.where(adv_h, nx_idx + x_dir, nx_idx)
        npx = torch.where(adv_h, nx_idx.to(px.dtype) * h, npx)
        y_idx = torch.where(adv_v, ny_idx, y_idx)
        ny_idx = torch.where(adv_v, ny_idx + y_dir, ny_idx)
        npy = torch.where(adv_v, ny_idx.to(py.dtype) * h, npy)

        t_x = torch.where(active, _time_to(mx, npx, vx), t_x)
        t_y = torch.where(active, _time_to(my, npy, vy), t_y)
        t_prev = torch.where(active, torch.where(hit, 0.0, t_near), t_prev)
        t_near = torch.where(active, torch.minimum(t_x, t_y), t_near)

    t = torch.where(t_near < _FLT_MAX, dt_rem, t_prev)
    new = torch.stack([torch.where(alive, mx + t * vx, px),
                       torch.where(alive, my + t * vy, py)])
    return new, dt_rem


def _propagate(alive, dt_vec, dt_out, dt):
    """One link of the dt-carry chain: each marker's dt becomes the
    post-march dt of the last marker before it whose dt changed (dead
    markers are identity links), else the call's dt."""
    M = dt_vec.shape[0]
    idx = torch.arange(M, device=dt_vec.device)
    dt_out = torch.where(alive, dt_out, dt_vec)
    j = torch.where(dt_out != dt_vec, idx, -1)
    last = torch.cummax(j, 0).values
    last_excl = torch.cat([last.new_full((1,), -1), last[:-1]])
    picked = dt_out[torch.clamp(last_excl, 0, M - 1)]
    return torch.where(last_excl >= 0, picked, dt)


def advect_plain(cfg: SimConfig, scn: Scenario, u, v, fluid, markers, alive,
                 dt):
    """The plain version of G1: the marched store and the number of march
    passes (an int32 tensor), with the dt-carry fixpoint of the JAX
    package (markers.py:142-175) when `marker_dt_carry` is on: passes
    until the per-marker dt vector is bitwise stable, at most
    DT_CARRY_PASSES; the store is the last pass's."""
    f = markers.dtype
    dt = torch.as_tensor(dt, device=markers.device).to(f)
    if not cfg.marker_dt_carry:
        new, _ = march_markers(cfg, scn, u, v, fluid, markers, alive, dt)
        return new, torch.ones((), dtype=torch.int32, device=dt.device)
    M = markers.shape[1]
    dt_vec = torch.zeros(M, dtype=f, device=markers.device) + dt
    passes = 0
    while True:
        new, dt_out = march_markers(cfg, scn, u, v, fluid, markers, alive,
                                    dt_vec)
        dt_next = _propagate(alive, dt_vec, dt_out, dt)
        passes += 1
        if passes >= DT_CARRY_PASSES or not bool((dt_next != dt_vec).any()):
            break
        dt_vec = dt_next
    return new, torch.tensor(passes, dtype=torch.int32, device=dt.device)


def advect_markers(cfg: SimConfig, scn: Scenario, state: FluidState, dt):
    """main.c:464-537 over every marker slot, through G1's wrapper."""
    from euler_tpu_torch.ops.cuda.global_marker_kernel import advect_global

    markers, _ = advect_global(cfg, scn, state, dt)
    return state.replace(markers=markers)


def source_pass_global(cfg: SimConfig, scn: Scenario, state: FluidState,
                       active=None, row_offset: int = 0, counts=None,
                       col_offset: int = 0) -> None:
    """Source emission in the global layout (main.c:276-298), the plain
    version of S1's global form, as the JAX `update_fluid_sources`
    computes it, in place on the state's colour planes, store, alive
    mask, counts, RNG, alive_count and source_exhausted:

      * the colour pass (`markers_slots.source_colours`);
      * the walk in source order: a valid source whose cell holds fewer
        than markers_per_cell markers emits, unless the stream is
        exhausted or `active` is False, drawing the Y jitter before the X
        jitter; the emitted markers, in walk order, go to the first free
        slots of the store in index order (the first S free slots, slot 0
        standing in where fewer are free, as jnp.nonzero pads).
    On a block (`parallel/spatial.py`) the planes are the block's cells
    from grid row `row_offset` and column `col_offset` and `counts` every
    source cell's count, all-reduced over the blocks: the walk reads
    those, the whole store (which every block holds) takes every emitted
    marker, and the block writes only its own cells' counts (S1's
    global form on a block)."""
    from euler_tpu_torch.core.rng import randf32
    from euler_tpu_torch.ops.markers_slots import source_colours

    source_colours(cfg, scn, state)
    f = state.r.dtype
    S = scn.num_sources
    if S == 0:
        return
    max_count = cfg.max_markers
    h = float(np.float32(cfg.side_length))
    dev = state.r.device
    ys = scn.source_yx[:, 0].long()
    xs = scn.source_yx[:, 1].long()
    ly, lx, mine = ys, xs, None  # the sources' cells on the planes
    if counts is None:
        counts = state.marker_count[ys, xs]
    else:
        ly, lx = ys - row_offset, xs - col_offset
        Yl, Xl = state.marker_count.shape
        mine = (ly >= 0) & (ly < Yl) & (lx >= 0) & (lx < Xl)
    if active is None:
        active = torch.ones((), dtype=torch.bool, device=dev)
    lanes = state.rng.to(torch.int64)
    alive_count = state.alive_count.clone()
    exhausted = state.source_exhausted | (alive_count == max_count - 1)
    rank = torch.zeros((), dtype=torch.int64, device=dev)
    cans, ranks, pos_x, pos_y = [], [], [], []
    for i in range(S):
        can = (scn.source_valid[i] & ~exhausted
               & (counts[i] < cfg.markers_per_cell) & active)
        ry, lanes_a = randf32(lanes)
        rx, lanes_b = randf32(lanes_a)
        lanes = torch.where(can, lanes_b, lanes)
        pos_x.append((xs[i].to(f) + rx) * h)
        pos_y.append((ys[i].to(f) + ry) * h)
        ranks.append(rank)
        rank = rank + can.to(torch.int64)
        alive_count = alive_count + can.to(torch.int32)
        exhausted = exhausted | (alive_count == max_count - 1)
        cans.append(can)

    free = torch.nonzero(~state.alive, as_tuple=True)[0][:S]
    free = torch.cat([free, free.new_zeros(S - free.numel())])
    can = torch.stack(cans)
    slots = free[torch.clamp(torch.stack(ranks), 0, S - 1)][can]
    state.markers[0, slots] = torch.stack(pos_x)[can]
    state.markers[1, slots] = torch.stack(pos_y)[can]
    state.alive[slots] = True
    if mine is not None:
        # a block writes its own cells' counts only (a host read: the
        # plain version runs on the CPU)
        keep = mine.nonzero()[:, 0]
        ly, lx, counts, can = ly[keep], lx[keep], counts[keep], can[keep]
    state.marker_count[ly, lx] = counts + can.to(torch.int32)
    state.rng.copy_(lanes.to(torch.uint32))
    state.alive_count.copy_(alive_count)
    state.source_exhausted.copy_(exhausted)


def update_fluid_sources(cfg: SimConfig, scn: Scenario, state: FluidState,
                         active=None):
    """Source emission through S1's wrapper, in place on the state's
    tensors (the caller hands it tensors it owns); returns the state."""
    from euler_tpu_torch.ops.cuda.source_kernel import emit_sources

    emit_sources(cfg, scn, state, active)
    return state


def get_marker_ops(cfg: SimConfig):
    """(advect, refresh, sources) of the configured marker layout."""
    if cfg.marker_layout == "slots":
        from euler_tpu_torch.ops import markers_slots as ms

        return (ms.advect_markers_slots, ms.refresh_marker_counts_slots,
                ms.update_fluid_sources_slots)
    return advect_markers, refresh_marker_counts, update_fluid_sources


def get_marker_pass(cfg: SimConfig):
    """The march + re-bin of a substep for the configured layout."""
    if cfg.marker_layout == "slots":
        from euler_tpu_torch.ops.markers_slots import marker_pass_slots

        return marker_pass_slots

    def _pass(cfg, scn, state, dt):
        state = advect_markers(cfg, scn, state, dt)
        return refresh_marker_counts(cfg, scn, state)

    return _pass
