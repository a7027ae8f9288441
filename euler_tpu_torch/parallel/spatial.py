"""The slot store's two forms, the ("y", "x") mesh, and the frame on
blocks (`euler_tpu/parallel/spatial.py`).

The port keeps the slot store as spatial planes, positions [2, K, Y, X]
and validity [K, Y, X] (`core/state.py`); the JAX package's flat [2, M]
store (m = (k*Y + y)*X + x), as a JAX checkpoint or `convert` gives it,
is the same memory.  `to_spatial` and `to_flat` reshape between the two.

`spatial_mesh` lays the ranks out as a ("y", "x") mesh (spatial.py:64),
and `shard_spatial` gives each rank its block of rows and columns of
every [.., Y, X] plane, the slot planes included (spatial.py:80-110);
scalars and the source list stay whole on every rank.  `gather_spatial`
puts the blocks back together.  A block is a rank of a `DeviceMesh` or a
block of an in-process `comm.LocalGroup` (one card playing n blocks).
Both need the slot layout, as the JAX package asserts (spatial.py:43);
`shard_blocks` and `gather_blocks` also take the global layout, whose
[2, M] store, alive mask and RNG every block holds whole, in marker
order, as the JAX package's batch keeps them replicated over "y" and "x"
(mesh.py:70-74).

`make_block_step` is the frame on blocks, in either layout, and
`make_spatial_step` its slot-only form (spatial.py:113, which the JAX
package leaves to GSPMD): `Blocks`, through `sim.step_frame(...,
blocks=)`.  One substep on the block of rows [ry Yl, (ry+1) Yl) and
columns [rx Xl, (rx+1) Xl) (x = 1: every column, and nothing below
exchanges columns):
  * the marker pass: in the slot layout K1 per block (`cuda_shard`),
    alive_count and the drops summed over the blocks; in the global
    layout G1 + G2 on the whole grid, whose u, v and counts are
    all-gathered over "x", then "y" (solid and sink once a scenario):
    every block computes the same store, alive mask and alive_count, and
    keeps its own cells' counts;
  * rainbow colour: r, g and b extrapolated on the block with one ring of
    its neighbours' cells, before the sources (`sim.substep`);
  * the sources: S1 per block.  Whether a source emits depends on its
    cell's count and on alive_count, and the RNG advances only when it
    emits, so the [S] counts of the source cells are all-reduced (each
    block fills its own cells' entries), every block walks every source
    with the same RNG, and each writes only the sources whose row and
    column both lie in it (in the global layout every block appends the
    emitted markers to its whole store, and writes its own cells' counts
    and colours);
  * the grid stage: K7 on the block padded with H = 8 rows and columns
    of u, v, fluid, prev_fluid and solid from each neighbour (the
    corners from the diagonal ones, `cuda_shard.padded`), told the
    grid's rows and columns (`clamp_ny`, `row_offset`, `clamp_nx`,
    `col_offset`), the halo cropped; in rainbow K7's form that also
    returns the extrapolated velocities, with which `advect_p` advects the
    colours on the block padded likewise.  The colours are exchanged for
    that after S1, which may have written a neighbour's source cell in
    this block's halo;
  * the projection, as `ops/project.project` on the block padded with
    one row and one column (the RHS reads v of the row before and u of
    the column before, a_diag solid on all four sides, the face update p
    of the row and the column after), warm-started from the state's
    pressure as `project()` is.  The solve is the JAX frame's, the whole
    grid's `pcg_loop` with its `_make_preconditioner`: with MG one
    Galerkin cycle over the whole grid's hierarchy (`spatial_mg.
    solve_pressure_blocks`, P5), with IC(0) the whole grid's IC(0) swept
    across the blocks in stages (`spatial_ic0.solve_pressure_blocks_ic0`,
    P6), with Jacobi or none P4 over ("y", "x") with that preconditioner
    (`pcg_shard_kernel.solve_pressure_sharded`; not `halo.
    make_sharded_pressure_solver`, which runs Jacobi for "none", as
    halo.py does);
  * max_speed_sq: its u and v maxima all-reduced (max) before the sum, so
    dt, `active` and the frame's counts are the same on every block.
Every solver runs in f32 and in f64 (f64 MG: P5 in double precision).
Refused, naming its ROADMAP item: RB-GS and rediscretized MG (M14 part
b; both run on one card, P3 and P7).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.advect import advect_p
from euler_tpu_torch.ops.cuda import grid_kernel
from euler_tpu_torch.ops.cuda.pcg_shard_kernel import (
    check_solver,
    solve_pressure_sharded,
)
from euler_tpu_torch.ops.cuda.source_kernel import emit_sources
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.forces import max_speed_sq_parts
from euler_tpu_torch.ops.markers import get_marker_pass
from euler_tpu_torch.ops.project import (
    clamp_pressure,
    divergence_rhs,
    face_update,
    pressure_matrix_diag,
)
from euler_tpu_torch.parallel.comm import as_comm
from euler_tpu_torch.parallel.cuda_shard import (
    H,
    block_axes,
    make_sharded_marker_pass,
    padded,
    split_columns,
)
from euler_tpu_torch.parallel.spatial_ic0 import solve_pressure_blocks_ic0
from euler_tpu_torch.parallel.spatial_mg import make_block_mg_solver
from euler_tpu_torch.parallel.mesh import (
    SCENARIO_PLANES,
    block_span,
    cut_block,
    gather_block,
    square_factor,
    state_planes,
    world,
)


def check_slot_layout(cfg: SimConfig) -> None:
    """Raise ValueError unless cfg keeps the slot layout, as the JAX
    package's spatial sharding asserts."""
    if cfg.marker_layout != "slots":
        raise ValueError(
            "spatial sharding needs slot markers, got marker_layout "
            f"{cfg.marker_layout!r} (euler_tpu/parallel/spatial.py:43 "
            "asserts it); the global layout runs on blocks through "
            "spatial.Blocks and mesh.make_sharded_step")


def to_spatial(cfg: SimConfig, state: FluidState) -> FluidState:
    """Re-view flat [2, M] slot markers as spatial planes [2, K, Y, X]; a
    state already in that form is returned as it is."""
    check_slot_layout(cfg)
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


def block(cfg: SimConfig, mesh) -> tuple[int, int, int, int]:
    """(first row, rows, first column, columns) of this rank's block: the
    grid's rows split evenly over "y", its columns over "x"."""
    comm = as_comm(mesh)
    return (*block_span(cfg.ny, comm.size("y"), comm.rank("y"), "y"),
            *block_span(cfg.nx, comm.size("x"), comm.rank("x"), "x"))


def shard_blocks(cfg: SimConfig, mesh, scn: Scenario, state: FluidState):
    """This rank's block of one (unbatched) scenario and state on its
    device: rows [ry Yl, (ry+1) Yl) and columns [rx Xl, (rx+1) Xl) of
    every plane, the slot store as [2, K, Yl, Xl] and [K, Yl, Xl];
    scalars, the RNG, the source list and the global layout's [2, M]
    store and [M] alive mask whole (sources keep their global cells)."""
    r0, rows, c0, cols = block(cfg, mesh)
    dev = as_comm(mesh).device
    if cfg.marker_layout == "slots":
        state = to_spatial(cfg, state)
    planes = state_planes(state)
    scn = cut_block(scn, SCENARIO_PLANES, (r0, rows), (c0, cols), dev)
    scn = dataclasses.replace(scn, source_yx=scn.source_yx.to(dev),
                              source_valid=scn.source_valid.to(dev))
    state = cut_block(state, planes, (r0, rows), (c0, cols), dev)
    return scn, state.replace(**{
        f.name: getattr(state, f.name).to(dev)
        for f in dataclasses.fields(state) if f.name not in planes})


def gather_blocks(cfg: SimConfig, mesh, state: FluidState):
    """Inverse of `shard_blocks` for the state: every rank's block
    all-gathered over "x", in column order, then over "y", in row order,
    on every rank; the scalars are this rank's (the same on every rank),
    and so is the global layout's store, which is checked to be the same
    on every block."""
    block(cfg, mesh)
    comm = as_comm(mesh)
    return gather_block(state, comm.gather, block_axes(comm)[::-1])


def shard_spatial(cfg: SimConfig, mesh: DeviceMesh, scn: Scenario,
                  state: FluidState):
    """`shard_blocks` of the slot layout (spatial.py:80-110); ValueError
    on the global layout, as the JAX package asserts (spatial.py:43)."""
    check_slot_layout(cfg)
    return shard_blocks(cfg, mesh, scn, state)


def gather_spatial(cfg: SimConfig, mesh, state: FluidState):
    """Inverse of `shard_spatial`: `gather_blocks`."""
    check_slot_layout(cfg)
    return gather_blocks(cfg, mesh, state)


def check_block_frame(cfg: SimConfig) -> None:
    """Raise NotImplementedError for the solvers the frame on blocks does
    not run, naming their ROADMAP item: RB-GS and rediscretized MG
    (M14 part b)."""
    check_solver(cfg)


# the scenarios whose whole solid and sink planes a block keeps at most
GRIDS_KEPT = 64


class Blocks:
    """The frame on this block of rows and columns (see the top of this
    module): pass it to `sim.step_frame(cfg, scn, state, blocks=)` with
    the block's scenario and state (`shard_blocks`, or `mesh.shard_batch`
    an instance at a time).  `mesh`: a `DeviceMesh` (its "y" and "x"
    dimensions) or a block of an in-process `LocalGroup`.  On x = 1
    nothing exchanges columns."""

    def __init__(self, cfg: SimConfig, mesh):
        check_block_frame(cfg)
        self.cfg = cfg
        self.comm = as_comm(mesh)
        self.lo, self.rows, self.lo_x, self.cols = block(cfg, self.comm)
        self.split = split_columns(self.comm)
        if self.rows < H or (self.split and self.cols < H):
            raise ValueError(f"a block of {self.rows} x {self.cols} cells "
                             f"is shallower or narrower than the halo's {H}")
        self.axes = block_axes(self.comm)
        self.slots = cfg.marker_layout == "slots"
        self.marker_pass = (make_sharded_marker_pass(cfg, self.comm)
                            if self.slots else self.global_marker_pass)
        # the whole solid and sink planes of each scenario the global
        # layout's marker pass has seen (`whole_scenario`)
        self.grids = {}
        # the block's cells in the grid
        self.cut = (slice(self.lo, self.lo + self.rows),
                    slice(self.lo_x, self.lo_x + self.cols))
        self.mg = cfg.solver.preconditioner == "mg"
        if self.mg:
            self.solve = make_block_mg_solver(cfg, self.comm, self.axes)
        else:
            solve = (solve_pressure_blocks_ic0
                     if cfg.solver.preconditioner == "ic0"
                     else solve_pressure_sharded)
            self.solve = functools.partial(solve, cfg, self.comm, self.axes)
        self.cfg_block = dataclasses.replace(cfg, ny=self.rows)
        self.cfg_h = dataclasses.replace(cfg, ny=self.rows + 2 * H)
        self.cfg_1 = dataclasses.replace(cfg, ny=self.rows + 2)
        # where each of those planes lies in the grid
        self.at_block = dict(clamp_ny=cfg.ny, row_offset=self.lo)
        self.at_h = dict(clamp_ny=cfg.ny, row_offset=self.lo - H)
        self.at_1 = dict(clamp_ny=cfg.ny, row_offset=self.lo - 1)
        if self.split:
            self.cfg_block = dataclasses.replace(self.cfg_block,
                                                 nx=self.cols)
            self.cfg_h = dataclasses.replace(self.cfg_h,
                                             nx=self.cols + 2 * H)
            self.cfg_1 = dataclasses.replace(self.cfg_1, nx=self.cols + 2)
            self.at_block.update(clamp_nx=cfg.nx, col_offset=self.lo_x)
            self.at_h.update(clamp_nx=cfg.nx, col_offset=self.lo_x - H)
            self.at_1.update(clamp_nx=cfg.nx, col_offset=self.lo_x - 1)

    def keep(self, h: int, ring: int = 0):
        """The block's own cells, with `ring` more a side, in a plane
        padded with h a side."""
        rows = slice(h - ring, h + self.rows + ring)
        cols = slice(h - ring, h + self.cols + ring)
        return (rows, cols) if self.split else rows

    def whole(self, t):
        """The whole grid of the blocks' [.., Yl, Xl] `t`: all-gathered
        over "x", then "y", on every block."""
        for axis in self.axes[::-1]:
            t = self.comm.gather(t, -1 if axis == "x" else -2, axis)
        return t

    def whole_scenario(self, scn: Scenario) -> Scenario:
        """`scn` with its solid and sink planes whole: all-gathered the
        first time this block sees them, then kept, since a scenario's
        planes do not change.  The key is where the block's planes lie
        (a batch's instances are views at their own places); the entry
        holds those planes, so no other tensor takes their memory while
        it is kept.  Every block sees its scenarios in the same order, so
        all of them gather in the same calls."""
        key = (scn.solid.data_ptr(), scn.sink.data_ptr(),
               tuple(scn.solid.shape))
        if key not in self.grids:
            if len(self.grids) >= GRIDS_KEPT:
                self.grids.clear()
            cells = self.whole(scn.solid.to(torch.int32)
                               + 2 * scn.sink.to(torch.int32))
            self.grids[key] = (scn.solid, scn.sink, cells % 2 == 1,
                               cells >= 2)
        _, _, solid, sink = self.grids[key]
        return dataclasses.replace(scn, solid=solid, sink=sink)

    def global_marker_pass(self, cfg: SimConfig, scn: Scenario,
                           state: FluidState, dt, defer_alive: bool = False):
        """The global layout's marker pass, G1 + G2 through their wrappers,
        on the whole grid: u, v and the counts all-gathered (two gathers an
        axis), solid and sink whole (`whole_scenario`).  Every block
        marches the same store and keeps the same alive mask and
        alive_count; it keeps its own cells' counts."""
        uv = self.whole(torch.stack([state.u, state.v]))
        out = get_marker_pass(cfg)(
            cfg, self.whole_scenario(scn),
            state.replace(u=uv[0], v=uv[1],
                          marker_count=self.whole(state.marker_count)), dt)
        return out.replace(u=state.u, v=state.v,
                           marker_count=out.marker_count[self.cut].clone(),
                           prev_marker_count=state.marker_count)

    def colors(self, state: FluidState, fn, h: int) -> FluidState:
        """r, g and b exchanged with `h` rows and columns of each
        neighbour (one exchange of the three), fn applied to each padded
        plane, the block's own cells kept."""
        rgb = padded(torch.stack([state.r, state.g, state.b]), self.comm, h)
        keep = self.keep(h)
        r, g, b = (fn(q)[keep].contiguous() for q in rgb)
        return state.replace(r=r, g=g, b=b)

    def max_speed_sq(self, cfg: SimConfig, u, v):
        """`max_speed_sq` of the whole grid: the block's u and v maxima,
        each all-reduced (max), summed."""
        parts = torch.stack(max_speed_sq_parts(self.cfg_block, u, v,
                                               **self.at_block))
        self.comm.all_reduce(parts, "max", self.axes)
        return parts[0] + parts[1]

    def sources(self, cfg: SimConfig, scn: Scenario, state: FluidState,
                active):
        """S1 on the block: the source cells' counts all-reduced first."""
        ly = scn.source_yx[:, 0].long() - self.lo
        lx = scn.source_yx[:, 1].long()
        mine = scn.source_valid & (ly >= 0) & (ly < self.rows)
        if self.split:
            lx = lx - self.lo_x
            mine = mine & (lx >= 0) & (lx < self.cols)
            lx = lx.clamp(0, self.cols - 1)
        cells = state.marker_count[ly.clamp(0, self.rows - 1), lx]
        counts = torch.where(mine, cells, 0).to(torch.int32)
        self.comm.all_reduce(counts, "sum", self.axes)
        emit_sources(cfg, scn, state, active, row_offset=self.lo,
                     counts=counts, col_offset=self.lo_x)
        return state

    def ring(self, a, below=None, above=None, left=None, right=None):
        """[rows, cols] `a` with one row before and after it (`below`,
        `above`, or zeros) and, on column blocks, one column (`left`,
        `right`, [rows, 1], or zeros; zero corners): the plane the
        projection's glue reads."""
        z = None
        if below is None or above is None:
            z = torch.zeros_like(a[:1])
        a = torch.cat([z if below is None else below, a,
                       z if above is None else above], 0)
        if not self.split:
            return a
        zc = torch.zeros_like(a[:, :1])

        def column(c):
            return zc if c is None else torch.cat([zc[:1], c, zc[:1]], 0)

        return torch.cat([column(left), a, column(right)], 1)

    def project(self, cfg: SimConfig, dt, u, v, fluid, fluid1, solid1, p0):
        """`ops/project.project` on the block: fluid1, solid1 the block's
        masks with one row (and column) of each neighbour's.  Returns
        (u', v', pressure, iterations)."""
        comm, inner = self.comm, self.keep(1)
        below, _ = comm.exchange(v, 1)
        left = comm.exchange(u, 1, "x")[0] if self.split else None
        b = divergence_rhs(self.cfg_1, self.ring(u, left=left),
                           self.ring(v, below), fluid1, dt)[inner]
        a_diag = pressure_matrix_diag(self.cfg_1, solid1, fluid1)[inner]
        x0 = None
        if cfg.solver.warm_start:
            x0 = torch.where(fluid, p0, 0.0).to(b.dtype)
        b, a_diag = b.contiguous(), a_diag.contiguous()
        if self.mg:
            p, iters, _resid = self.solve(b, a_diag, fluid, fluid1, x0)
        else:
            p, iters, _resid = self.solve(b, a_diag, fluid, x0)
        p = clamp_pressure(p, fluid)
        p_below, p_above = comm.exchange(p, 1)
        p_left = p_right = None
        if self.split:
            p_left, p_right = comm.exchange(p, 1, "x")
        u1, v1 = face_update(
            self.cfg_1, self.ring(p, p_below, p_above, p_left, p_right),
            self.ring(u), self.ring(v), fluid1, solid1, dt, **self.at_1)
        return u1[inner].contiguous(), v1[inner].contiguous(), p, iters

    def substep(self, cfg: SimConfig, scn: Scenario, state: FluidState, dt,
                dt_proj, defer_alive: bool = False, active=None):
        """`sim.substep` on the block (`sim._step_frame_impl` calls it)."""
        if cfg != self.cfg:
            raise ValueError("the blocks were made for another "
                             "configuration")
        if (state.markers.ndim == 4) != self.slots:
            raise ValueError(
                f"a {cfg.marker_layout} state with a store of shape "
                f"{tuple(state.markers.shape)}: the slot layout's blocks "
                "hold [2, K, Yl, Xl] (to_spatial), the global layout's "
                "the whole [2, M]")
        state = self.marker_pass(cfg, scn, state, dt,
                                 defer_alive=defer_alive)
        if cfg.rainbow:
            # the colours extrapolate before the sources run (sim.substep),
            # on the block with one ring of its neighbours' cells
            masks = padded(torch.stack([state.fluid, state.prev_fluid]),
                           self.comm, 1)
            state = self.colors(state, lambda q: extrapolate(
                self.cfg_1, q, *masks, "p", **self.at_1), 1)
        if scn.num_sources:
            if not self.slots:
                # the frame selects the whole state: S1 gets its own copies
                # of what the marker pass did not make anew (sim.substep)
                state = state.replace(**{
                    name: getattr(state, name).clone()
                    for name in ("r", "g", "b", "rng", "source_exhausted")})
            state = self.sources(cfg, scn, state, active)
        fluid = state.fluid
        pad = [padded(a, self.comm) for a in
               (state.u, state.v, fluid, state.prev_fluid, scn.solid)]
        ut, vt, *ext = grid_kernel.grid_stage(
            self.cfg_h, *pad, dt, extrapolated=cfg.rainbow, **self.at_h)
        if cfg.rainbow:
            # exchanged after S1, which wrote its sources' colours: a
            # neighbour's source cell may lie in this block's halo
            uu, vv = ext
            state = self.colors(state, lambda q: advect_p(
                self.cfg_h, q, uu, vv, pad[2], dt, **self.at_h), H)
        keep, one = self.keep(H), self.keep(H, 1)
        u2, v2, p, iters = self.project(
            cfg, dt_proj, ut[keep].contiguous(), vt[keep].contiguous(), fluid,
            pad[2][one], pad[4][one], state.p)
        msq = self.max_speed_sq(cfg, u2, v2)
        return (state.replace(u=u2, v=v2, p=p.to(state.p.dtype)), msq,
                iters)


def make_block_step(cfg: SimConfig, mesh):
    """One frame of the full pipeline on this rank's block of rows and
    columns, in either marker layout: fn(scn, state) -> state on the
    blocks `shard_blocks` gives.  `mesh`: a ("y", "x") `DeviceMesh`, or a
    block of an in-process `LocalGroup`."""
    blocks = Blocks(cfg, mesh)

    def step(scn: Scenario, state: FluidState) -> FluidState:
        return sim.step_frame(cfg, scn, state, blocks=blocks)

    return step


def make_spatial_step(cfg: SimConfig, mesh):
    """`make_block_step` on the blocks `shard_spatial` gives
    (spatial.py:113): the slot layout only, as the JAX package asserts
    (ValueError)."""
    check_slot_layout(cfg)
    return make_block_step(cfg, mesh)
