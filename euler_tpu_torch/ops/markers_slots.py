"""Cell-slot marker layout (`euler_tpu/ops/markers_slots.py`): the plain
PyTorch version of the marker pass (the reference of kernels K1, K4, K5
and K6), and the state-level passes that run those kernels.

Markers are stored by home cell: the [2, K, Y, X] store holds marker k of
cell (y, x) at [:, k, y, x], and the first marker_count[y, x] slots of a
cell are live (front-compacted).  The CFL limit (0.75 cells per substep)
bounds every per-substep interaction to the 3x3 neighbourhood of the home
cell, so velocity sampling, the DDA collision march (main.c:464-537) and
the re-binning (refresh_marker_counts, main.c:102-117) are all 3x3
stencil operations.

A cell holds at most K markers; arrivals beyond K are dropped and counted
in `dropped_markers` (the layout's documented deviation from the
reference, whose count is bounded only by its uint8 counter).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.interp_stencil import interpolate_stencil

_FLT_MAX = float(np.finfo(np.float32).max)

# Re-binning insertion order: own cell first (stayers keep low slots),
# then the 8 neighbour offsets lexicographically.  The order defines slot
# assignment within a cell; the CUDA kernel walks it identically.
OFFSETS_OWN_FIRST = [(0, 0)] + [
    (dy, dx)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if (dy, dx) != (0, 0)
]


def live_slots(count, K: int):
    """Front-compacted validity: slot k of a cell is live iff k < count."""
    k = torch.arange(K, dtype=count.dtype, device=count.device)
    return k[:, None, None] < count[None]


def _shift2(a, dy: int, dx: int, fill=0):
    """out[..., y, x] = a[..., y - dy, x - dx] (fill beyond the edges)."""
    Y, X = a.shape[-2], a.shape[-1]
    is_bool = a.dtype == torch.bool
    p = F.pad(a.to(torch.uint8) if is_bool else a,
              (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0)),
              value=fill)
    out = p[..., max(-dy, 0):max(-dy, 0) + Y, max(-dx, 0):max(-dx, 0) + X]
    return out != 0 if is_bool else out


def velocity_at_slots(cfg: SimConfig, u, v, fluid, px, py,
                      clamp_ny: int | None = None, row_offset: int = 0,
                      clamp_nx: int | None = None, col_offset: int = 0):
    """Staggered velocity at per-slot positions (main.c:440-449);
    clamp_ny, row_offset, clamp_nx, col_offset as `interpolate_stencil`
    takes them."""
    inv_h = float(np.float32(1.0) / np.float32(cfg.side_length))
    at = (clamp_ny, row_offset, clamp_nx, col_offset)
    vx = interpolate_stencil(cfg, u, fluid, px * inv_h - 1.0,
                             py * inv_h - 0.5, "u", *at)
    vy = interpolate_stencil(cfg, v, fluid, px * inv_h - 0.5,
                             py * inv_h - 1.0, "v", *at)
    return vx, vy


def _time_to(p0, p1, vel):
    nz = vel.abs() > 0.0
    return torch.where(nz, (p1 - p0) / torch.where(nz, vel, 1.0), _FLT_MAX)


def march_slots(cfg: SimConfig, u, v, fluid, solid, px, py, valid, dt,
                clamp_ny: int | None = None, row_offset: int = 0,
                clamp_nx: int | None = None, col_offset: int = 0):
    """main.c:464-537 on the slot layout: the DDA collision march of every
    live slot, `marker_march_iters` masked iterations, then the advance.
    Dead slots keep their position.  On a block's plane, positions are
    global: `row_offset` / `col_offset` are the global row / column of
    plane row / column 0 and `clamp_ny` / `clamp_nx` the global row /
    column counts (`interpolate_stencil`)."""
    Y, X = cfg.ny, cfg.nx
    h = float(np.float32(cfg.side_length))
    inv_h = float(np.float32(1.0) / np.float32(cfg.side_length))
    dev = px.device
    dt = torch.as_tensor(dt, dtype=px.dtype, device=dev)

    vx, vy = velocity_at_slots(cfg, u, v, fluid, px, py, clamp_ny,
                               row_offset, clamp_nx, col_offset)

    site_x = torch.arange(X, dtype=torch.int32, device=dev)
    site_y = torch.arange(Y, dtype=torch.int32, device=dev)[:, None]
    solid_p = F.pad(solid.to(torch.uint8), (1, 1, 1, 1)) != 0

    def solid_at(yy, xx):
        dy = torch.clamp(yy - (site_y + row_offset), -1, 1)
        dx = torch.clamp(xx - (site_x + col_offset), -1, 1)
        return solid_p[(site_y + 1 + dy).long(), (site_x + 1 + dx).long()]

    def idx(p):
        return torch.floor(p * inv_h).to(torch.int32)

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
        hit_h = active & horiz & solid_at(y_idx, nx_idx + x_off)
        adv_h = active & horiz & ~hit_h
        hit_v = active & ~horiz & solid_at(ny_idx + y_off, x_idx)
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
    return (torch.where(valid, mx + t * vx, px),
            torch.where(valid, my + t * vy, py))


def rebin_slots(cfg: SimConfig, px, py, valid, dead, row_offset: int = 0,
                col_offset: int = 0):
    """Re-bin marched slots into their new home cells (main.c:102-117):
    nine shifted insert passes in OFFSETS_OWN_FIRST order; within a
    destination cell, arrivals are ranked by a running count and the
    first K kept.  Arrivals into a dead (sink or solid) cell are deleted
    and not counted.  Returns (px', py', count, drop) with drop the
    [Y, X] plane of per-destination capacity drops; slots at and beyond
    a cell's count are zero.  `row_offset` / `col_offset`: the global row
    / column of plane row / column 0 on a block's plane (positions are
    global)."""
    Y, X, K = cfg.ny, cfg.nx, px.shape[0]
    inv_h = float(np.float32(1.0) / np.float32(cfg.side_length))
    dev = px.device

    site_x = torch.arange(X, dtype=torch.int32, device=dev)
    site_y = torch.arange(Y, dtype=torch.int32, device=dev)[:, None]
    ody = torch.clamp(torch.floor(py * inv_h).to(torch.int32)
                      - (site_y + row_offset), -1, 1)
    odx = torch.clamp(torch.floor(px * inv_h).to(torch.int32)
                      - (site_x + col_offset), -1, 1)

    count = torch.zeros((Y, X), dtype=torch.int32, device=dev)
    drop = torch.zeros((Y, X), dtype=torch.int32, device=dev)
    per_offset = []
    for dy, dx in OFFSETS_OWN_FIRST:
        # markers held by cell (y-dy, x-dx) that are bound for (y, x)
        src_sel = _shift2(valid & (ody == dy) & (odx == dx), dy, dx, 0)
        rank = torch.cumsum(src_sel.to(torch.int32), 0, dtype=torch.int32) - 1
        dest = count[None] + rank
        ok = src_sel & (dest < K) & ~dead[None]
        drop = drop + (src_sel & (dest >= K) & ~dead[None]).sum(
            0, dtype=torch.int32)
        per_offset.append((ok, dest, _shift2(px, dy, dx), _shift2(py, dy, dx)))
        count = count + ok.sum(0, dtype=torch.int32)

    # each destination slot's (unique) candidate as masked sums
    out_px = torch.zeros_like(px)
    out_py = torch.zeros_like(py)
    for d in range(K):
        for ok, dest, src_px, src_py in per_offset:
            sel_d = ok & (dest == d)
            out_px[d] += torch.where(sel_d, src_px, 0.0).sum(0)
            out_py[d] += torch.where(sel_d, src_py, 0.0).sum(0)
    return out_px, out_py, count, drop


def advect_markers_slots(cfg: SimConfig, scn: Scenario, state: FluidState,
                         dt):
    """The march alone through the K5 wrapper (the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors): slots k < marker_count
    are marched, the rest keep their position.  The wrapper's new store
    becomes `state.markers` as it is."""
    from euler_tpu_torch.ops.cuda.marker_kernel import advect_markers

    return state.replace(markers=advect_markers(
        cfg, state.u, state.v, state.fluid, scn.solid, state.markers, dt,
        state.marker_count))


def refresh_marker_counts_slots(cfg: SimConfig, scn: Scenario,
                                state: FluidState):
    """Re-bin, drop markers in sink/solid cells and recount, through the
    K6 wrapper, on the state's alive plane; writes the new alive plane.
    The wrapper's new store becomes `state.markers` as it is."""
    from euler_tpu_torch.ops.cuda.rebin_kernel import rebin_markers

    markers, alive, count, drop = rebin_markers(cfg, state.markers,
                                                state.alive,
                                                scn.sink | scn.solid)
    return state.replace(
        markers=markers,
        alive=alive,
        prev_marker_count=state.marker_count,
        marker_count=count,
        alive_count=count.sum(dtype=torch.int32),
        dropped_markers=state.dropped_markers + drop.sum(dtype=torch.int32),
    )


def marker_pass_slots(cfg: SimConfig, scn: Scenario, state: FluidState, dt,
                      defer_alive: bool = False, route: str = "K1"):
    """March + re-bin by `route` (`sim.marker_route` names it):
      * "K1": the fused pass through the K1 wrapper; validity is
        k < count;
      * "K4": the same on the persistent padded store that
        `sim.step_frame` keeps in `state.markers` through a frame;
      * "K5+K6": `advect_markers_slots` then `refresh_marker_counts_slots`.
    Each wrapper runs its CUDA kernel on CUDA tensors and its plain
    version on CPU tensors.  defer_alive leaves `state.alive` stale for
    the caller to re-derive (the fused passes only)."""
    from euler_tpu_torch.ops.cuda.marker_fused_kernel import (
        march_rebin,
        march_rebin_padded,
    )

    if route == "K5+K6":
        state = advect_markers_slots(cfg, scn, state, dt)
        return refresh_marker_counts_slots(cfg, scn, state)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    args = (cfg, state.u, state.v, state.fluid, scn.solid)
    dead = scn.sink | scn.solid
    if route == "K4":
        assert defer_alive, "the padded store requires the deferred alive"
        oslots, count, drop = march_rebin_padded(
            *args, state.markers, dt, state.marker_count, dead=dead)
    else:
        oslots, count, drop = march_rebin(
            *args, state.markers.reshape(2 * K, Y, X), dt,
            state.marker_count, dead=dead)
    return finish_marker_pass(cfg, state, oslots, count, drop, defer_alive)


def finish_marker_pass(cfg: SimConfig, state: FluidState, oslots, count,
                       drop, defer_alive: bool):
    """Assemble the post-pass state from the fused pass's outputs."""
    K = cfg.slots_per_cell
    alive = state.alive if defer_alive else live_slots(count, K)
    return state.replace(
        markers=oslots.reshape(state.markers.shape),
        alive=alive,
        prev_marker_count=state.marker_count,
        marker_count=count,
        alive_count=count.sum(dtype=torch.int32),
        dropped_markers=state.dropped_markers + drop.sum(dtype=torch.int32),
    )


def source_colours(cfg: SimConfig, scn: Scenario, state: FluidState) -> None:
    """The colour pass of source emission (main.c:292-294), in place:
    r, g, b = hsv_basis(t + 2), (t), (t - 2) on the source cells, t =
    f32(0.6) / f32(source_color_period) * frame_count, in mono too."""
    from euler_tpu_torch.ops.color import hsv_basis

    q = float(np.float32(0.6) / np.float32(cfg.source_color_period))
    t = q * state.frame_count.to(state.r.dtype)
    for plane, phase in ((state.r, t + 2.0), (state.g, t),
                         (state.b, t - 2.0)):
        plane.copy_(torch.where(scn.source, hsv_basis(phase), plane))


def source_pass_slots(cfg: SimConfig, scn: Scenario, state: FluidState,
                      active=None, row_offset: int = 0, counts=None,
                      col_offset: int = 0) -> None:
    """Source emission on the slot layout (main.c:276-298), the plain
    version of S1 (`ops/cuda/source_kernel.py`), as the JAX package's
    `update_fluid_sources_slots` computes it.  Updates the state's colour
    planes, store, alive plane, counts, RNG, alive_count and
    source_exhausted in place:

      * the colour pass writes hsv_basis(t + 2), (t), (t - 2) on the
        source cells, t = f32(0.6) / f32(source_color_period) *
        frame_count, in mono too (markers_slots.py:431-439);
      * the emission walks the sources in order: a valid source whose
        cell holds fewer than markers_per_cell and K markers emits one
        marker into slot `count`, unless the stream is exhausted
        (alive_count reached max_markers - 1) or `active` is False; it
        draws the Y jitter before the X jitter (gcc's argument order at
        main.c:288) and keeps the old RNG state when it does not emit.
    Reads no device value on the host on a whole plane.  On a block
    (`parallel/spatial.py`) the planes are the block's cells from grid
    row `row_offset` and column `col_offset`, and `counts` every source
    cell's count, all-reduced over the blocks: the walk reads those, and
    the block writes only the sources whose row and column both lie in it
    (S1's block)."""
    from euler_tpu_torch.core.rng import randf32

    source_colours(cfg, scn, state)
    f = state.r.dtype
    S = scn.num_sources
    if S == 0:
        return
    K, max_count = cfg.slots_per_cell, cfg.max_markers
    h = float(np.float32(cfg.side_length))
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
        active = torch.ones((), dtype=torch.bool, device=state.r.device)
    lanes = state.rng.to(torch.int64)
    alive_count = state.alive_count.clone()
    exhausted = state.source_exhausted | (alive_count == max_count - 1)
    cans, pos_x, pos_y = [], [], []
    for i in range(S):
        can = (scn.source_valid[i] & ~exhausted
               & (counts[i] < cfg.markers_per_cell) & (counts[i] < K)
               & active)
        ry, lanes_a = randf32(lanes)
        rx, lanes_b = randf32(lanes_a)
        lanes = torch.where(can, lanes_b, lanes)
        pos_x.append((xs[i].to(f) + rx) * h)
        pos_y.append((ys[i].to(f) + ry) * h)
        alive_count = alive_count + can.to(torch.int32)
        exhausted = exhausted | (alive_count == max_count - 1)
        cans.append(can)

    # the emitted marker's slot is the cell's count (front-compacted
    # slots); a source that does not emit writes its slot's old value
    can = torch.stack(cans)
    if mine is not None:
        # a block writes its own cells' sources only (a host read: the
        # plain version runs on the CPU)
        keep = mine.nonzero()[:, 0]
        ly, lx, counts, can = ly[keep], lx[keep], counts[keep], can[keep]
        pos_x = [pos_x[i] for i in keep.tolist()]
        pos_y = [pos_y[i] for i in keep.tolist()]
    if len(ly):
        k = torch.clamp(counts, max=K - 1).long()
        for c, pos in ((0, pos_x), (1, pos_y)):
            plane = state.markers[c]
            plane[k, ly, lx] = torch.where(can, torch.stack(pos),
                                           plane[k, ly, lx])
        state.alive[k, ly, lx] = state.alive[k, ly, lx] | can
        state.marker_count[ly, lx] = counts + can.to(torch.int32)
    state.rng.copy_(lanes.to(torch.uint32))
    state.alive_count.copy_(alive_count)
    state.source_exhausted.copy_(exhausted)


def update_fluid_sources_slots(cfg: SimConfig, scn: Scenario,
                               state: FluidState, active=None):
    """Source emission through the S1 wrapper (the CUDA kernel on CUDA
    tensors, `source_pass_slots` on CPU tensors), in place on the state's
    tensors; returns the state.  The caller hands it tensors it owns:
    `sim.step_frame` copies the fields it carries from its input (colours,
    alive plane, RNG, source_exhausted) once at the start of a frame."""
    from euler_tpu_torch.ops.cuda.source_kernel import emit_sources

    emit_sources(cfg, scn, state, active)
    return state
