"""K1 per block, and K2 per instance of the data axis
(`euler_tpu/parallel/pallas_shard.py`).

The sharded marker pass.  Each rank of the mesh's ("y", "x") dimensions
owns rows [ry Yl, (ry+1) Yl) and columns [rx Xl, (rx+1) Xl) of the grid
(`spatial.shard_spatial`; x = 1: all the columns).  The pass needs every
interior cell's arrivals, which come from at most one cell away, marched
with their own 3x3 stencils, whose u_property / v_property read one cell
more: so H = 2 rows and columns of each neighbour would do, and H = 8
are exchanged, as the JAX package exchanges rows for its DMA windows.
`padded` exchanges the block's first and last H rows with the blocks
before and after it along "y" (`comm.exchange`, `dist.batch_isend_irecv`
on the "y" group; zeros beyond the grid's edges, as the unsharded kernel
reads beyond the plane), then, where "x" splits the grid, the first and
last H columns of that row-padded block along "x": the corners so come
from the diagonal neighbours, which K1's 3x3 windows and the diagonal
re-bin read.  A block of an in-process `comm.LocalGroup` takes its
neighbours' cells from them.
K1 then runs unchanged on the padded [.., Yl + 2H, Xl + 2H] block, told
where that block lies: `clamp_ny` = Y and `clamp_nx` = X, the global row
and column counts of its interpolation clamps, and `row_offset` = ry Yl -
H and `col_offset` = rx Xl - H, the global row and column of the block's
cell (0, 0) (marker positions are global).  Cropping the halo leaves
every interior cell's slots, count and drop bit for bit those of the
unsharded K1 (tests/test_torch_shard.py and tests/test_torch_col_blocks.py
on the CPU; `chip_smoke.py` on the card).  A block shallower or narrower
than H is refused.

`make_sharded_marker_pass` is the drop-in for
`markers_slots.marker_pass_slots` that `sim.step_frame(...,
marker_pass=)` takes: it sums `alive_count` and the new drops over the
blocks (the JAX package's sums run over the whole plane); the slots,
counts and alive plane stay the rank's own cells.
`make_spatial_step_pallas` is the JAX package's frame on row blocks
(`parallel/spatial.py`), this pass included; on a mesh of one block the
pass also runs inside the ordinary frame.

`make_dp_substep_mg` runs K2 (`ops/cuda/substep_kernel.py`) on the one
instance each rank of the "data" dimension holds.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.distributed.device_mesh import DeviceMesh

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda.marker_fused_kernel import march_rebin
from euler_tpu_torch.ops.cuda.substep_kernel import project_substep_mg
from euler_tpu_torch.ops.markers_slots import finish_marker_pass
from euler_tpu_torch.parallel.comm import as_comm, exchange_rows
from euler_tpu_torch.parallel.mesh import axis_size, block_span

H = 8  # halo cells a side: >= 2 for the pass, 8 as the JAX package's rows


def block_with_halo(x: torch.Tensor, n: int, r: int, h: int = H,
                    m: int = 1, c: int = 0):
    """Rows [r Yl - h, (r+1) Yl + h) of a whole [.., Y, X] plane split
    into n x m blocks, and with m > 1 its columns [c Xl - h, (c+1) Xl +
    h), zeros beyond its edges: what block (r, c) holds once `padded`
    has padded it (one card holding every block)."""
    Yl = x.shape[-2] // n
    z = torch.zeros(x.shape[:-2] + (h, x.shape[-1]), dtype=x.dtype,
                    device=x.device)
    x = torch.cat([z, x, z], -2)[..., r * Yl:(r + 1) * Yl + 2 * h, :]
    if m > 1:
        Xl = x.shape[-1] // m
        z = torch.zeros(x.shape[:-1] + (h,), dtype=x.dtype, device=x.device)
        x = torch.cat([z, x, z], -1)[..., c * Xl:(c + 1) * Xl + 2 * h]
    return x.contiguous()


def split_columns(comm) -> bool:
    """Whether the blocks of `comm` split the grid's columns ("x") too."""
    return comm.size("x") > 1


def block_axes(comm) -> tuple[str, ...]:
    """The dimensions whose blocks split the grid: rows ("y"), and
    columns ("x") where they are split; the frame's sums and maxima run
    over these."""
    return ("y", "x") if split_columns(comm) else ("y",)


def padded(x, comm, h: int = H):
    """`x` with the `h` rows of each neighbour block along "y" before and
    after it, then, where "x" splits the columns, the `h` columns of each
    neighbour's row-padded block (zeros beyond the grid's edges)."""
    below, above = comm.exchange(x, h, "y")
    x = torch.cat([below, x, above], -2)
    if split_columns(comm):
        left, right = comm.exchange(x, h, "x")
        x = torch.cat([left, x, right], -1)
    return x


def make_sharded_march_rebin(cfg: SimConfig, mesh):
    """K1 on this rank's block (`pallas_shard.py:65`, which splits rows
    only): the grid's rows split over "y", its columns over "x".
    Returns fn(u, v, fluid, solid, slots, dt, count, dead) -> (slots',
    count', drop) on the block: [.., Yl, Xl] planes, slots the [2K, Yl,
    Xl] view of the store.  `mesh`: a `DeviceMesh` or a block of an
    in-process `comm.LocalGroup`."""
    comm = as_comm(mesh)
    Y, X = cfg.ny, cfg.nx
    r0, Yl = block_span(Y, comm.size("y"), comm.rank("y"), "y")
    c0, Xl = block_span(X, comm.size("x"), comm.rank("x"), "x")
    cols = split_columns(comm)
    if Yl < H or (cols and Xl < H):
        raise ValueError(f"a block of {Yl} x {Xl} cells is shallower or "
                         f"narrower than the halo's {H}")
    cfg_local = dataclasses.replace(cfg, ny=Yl + 2 * H)
    at = dict(clamp_ny=Y, row_offset=r0 - H)
    keep = (slice(H, H + Yl), slice(None))
    if cols:
        cfg_local = dataclasses.replace(cfg_local, nx=Xl + 2 * H)
        at.update(clamp_nx=X, col_offset=c0 - H)
        keep = (slice(H, H + Yl), slice(H, H + Xl))

    def march_rebin_block(u, v, fluid, solid, slots, dt, count, dead):
        padded_ = [padded(a, comm)
                   for a in (u, v, fluid, solid, slots, count, dead)]
        oslots, ocount, odrop = march_rebin(
            cfg_local, *padded_[:5], dt, padded_[5], dead=padded_[6], **at)
        return (oslots[(..., *keep)].contiguous(),
                ocount[keep].contiguous(), odrop[keep].contiguous())

    return march_rebin_block


def make_sharded_marker_pass(cfg: SimConfig, mesh):
    """A drop-in for `markers_slots.marker_pass_slots` running K1 per
    block (`pallas_shard.py:109`): pass it to `sim.step_frame(...,
    marker_pass=)`.  The scenario and state are this rank's block
    (`spatial.shard_spatial`); `alive_count` and the new drops are summed
    over the blocks."""
    kernel = make_sharded_march_rebin(cfg, mesh)
    comm = as_comm(mesh)
    over = block_axes(comm)

    def marker_pass(cfg_: SimConfig, scn, state, dt, defer_alive=False):
        if cfg_ != cfg:
            raise ValueError("the sharded marker pass was made for another "
                             "configuration")
        K = cfg.slots_per_cell
        Yl, Xl = state.u.shape
        dead = scn.sink | scn.solid
        oslots, count, drop = kernel(
            state.u, state.v, state.fluid, scn.solid,
            state.markers.reshape(2 * K, Yl, Xl), dt, state.marker_count,
            dead)
        out = finish_marker_pass(cfg, state, oslots, count, drop,
                                 defer_alive)
        sums = torch.stack([count.sum(dtype=torch.int32),
                            drop.sum(dtype=torch.int32)])
        comm.all_reduce(sums, "sum", over)
        return out.replace(alive_count=sums[0],
                           dropped_markers=state.dropped_markers + sums[1])

    return marker_pass


def make_spatial_step_pallas(cfg: SimConfig, mesh, axis: str = "y"):
    """The JAX package's frame on row blocks with the sharded marker pass
    (`pallas_shard.py:133`): fn(scn, state) -> state on this rank's
    block.  The JAX step runs K1 per shard and solves on its XLA path
    (pallas_shard.py:150-154, the jnp `pcg_loop` under GSPMD); the port's
    is `spatial.make_spatial_step`, whose marker pass is this module's
    K1 per block, its grid stage K7 and its solve the JAX step's on the
    blocks: P5 (MG, the whole grid's cycle), P6 (IC(0), the whole grid's
    sweeps in stages) or P4 (Jacobi, none).  Row
    blocks of the slot layout only, as the JAX package asserts
    (pallas_shard.py:146-148, spatial.py:43): ValueError on axis "x", on
    a mesh with x > 1 (the column blocks run through
    `spatial.make_spatial_step`) or on the global layout."""
    from euler_tpu_torch.parallel.spatial import (
        check_block_frame,
        check_slot_layout,
        make_spatial_step,
    )

    if axis != "y":
        raise ValueError(f"row blocks split 'y', not {axis!r}")
    check_slot_layout(cfg)
    check_block_frame(cfg)
    if split_columns(as_comm(mesh)):
        raise ValueError("the pallas marker sharding is row-(y-)sharded: "
                         "use an x = 1 mesh, or spatial.make_spatial_step "
                         "for column blocks")
    return make_spatial_step(cfg, mesh)


def make_dp_substep_mg(cfg: SimConfig, mesh: DeviceMesh, axis: str = "data"):
    """K2 on this rank's instance of the data axis (`pallas_shard.py:164`).

    Returns fn(dt, dt_proj, u, v, fluid, prev_fluid, solid, p0) ->
    (u2, v2, iters, resid, msq, p): the inputs this rank's slice of the
    batch, a leading axis of one instance (as `mesh.shard_batch` gives it
    when the batch has one instance a rank), the outputs with the same
    leading axis, as the JAX package's per-device function returns them."""
    n = axis_size(mesh, axis)

    def substep(dt, dt_proj, u, v, fluid, prev_fluid, solid, p0):
        if u.shape[0] != 1:
            raise ValueError(f"a rank of {axis}={n} holds one instance, "
                             f"not {u.shape[0]}")
        out = project_substep_mg(cfg, dt, dt_proj, u[0], v[0], fluid[0],
                                 prev_fluid[0], solid[0], p0[0])
        return tuple(a[None] for a in out)

    return substep
