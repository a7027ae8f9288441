"""K1 per row shard, and K2 per instance of the data axis
(`euler_tpu/parallel/pallas_shard.py`).

The row-sharded marker pass.  Each rank of the mesh's "y" dimension owns
rows [r Yl, (r+1) Yl) of the grid (`spatial.shard_spatial`).  The pass
needs every interior cell's arrivals, which come from at most one row
away, marched with their own 3x3 stencils, whose u_property / v_property
read one row more: so H = 2 rows of each neighbour would do, and H = 8
are exchanged, as the JAX package exchanges them for its DMA windows.
`exchange_rows` (`parallel/comm.py`) sends each rank's first and last H
rows to the ranks below and above it (`dist.batch_isend_irecv` on the
"y" group; zeros beyond the global edges, as the unsharded kernel reads
beyond the plane); a block of an in-process `comm.LocalGroup` takes its
neighbours' rows from them.
K1 then runs unchanged on the padded [.., Yl + 2H, X] block, told where
that block lies: `clamp_ny` = Y, the global row count of its
interpolation clamps, and `row_offset` = r Yl - H, the global row of the
block's row 0 (marker positions are global).  Cropping the halo rows
leaves every interior cell's slots, count and drop bit for bit those of
the unsharded K1 (tests/test_torch_shard.py on gloo ranks;
`chip_smoke.py` on the card).

`make_sharded_marker_pass` is the drop-in for
`markers_slots.marker_pass_slots` that `sim.step_frame(...,
marker_pass=)` takes: it sums `alive_count` and the new drops over "y"
(the JAX package's sums run over the whole plane); the slots, counts and
alive plane stay the rank's own rows.  `make_spatial_step_pallas` is the
whole frame on row blocks (`parallel/spatial.py`), this pass included;
on a "y" of one rank the pass also runs inside the ordinary frame.

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
from euler_tpu_torch.parallel.mesh import axis_size

H = 8  # halo rows a side: >= 2 for the pass, 8 as the JAX package's


def block_with_halo(x: torch.Tensor, n: int, r: int, h: int = H):
    """Rows [r Yl - h, (r+1) Yl + h) of a whole [.., Y, X] plane split
    into n blocks, zeros beyond its edges: what block r holds once
    `exchange_rows` has padded it (one card holding every block)."""
    Yl = x.shape[-2] // n
    z = torch.zeros(x.shape[:-2] + (h, x.shape[-1]), dtype=x.dtype,
                    device=x.device)
    return torch.cat([z, x, z], -2)[..., r * Yl:(r + 1) * Yl + 2 * h,
                                    :].contiguous()


def padded(x, comm, h: int = H, axis: str = "y"):
    """`x` with the `h` rows of each neighbour block before and after it
    (zeros beyond the grid's edges)."""
    below, above = comm.exchange(x, h, axis)
    return torch.cat([below, x, above], -2)


def make_sharded_march_rebin(cfg: SimConfig, mesh, axis: str = "y"):
    """K1 on this rank's block of rows (`pallas_shard.py:65`).  Returns
    fn(u, v, fluid, solid, slots, dt, count, dead) -> (slots', count',
    drop) on the block: [.., Yl, X] planes, slots the [2K, Yl, X] view
    of the store.  `mesh`: a `DeviceMesh` or a block of an in-process
    `comm.LocalGroup`."""
    comm = as_comm(mesh)
    n = comm.size(axis)
    Y = cfg.ny
    if Y % n:
        raise ValueError(f"{Y} rows do not split over {axis}={n}")
    Yl = Y // n
    if Yl < H:
        raise ValueError(f"a block of {Yl} rows is shallower than the "
                         f"halo's {H}")
    cfg_local = dataclasses.replace(cfg, ny=Yl + 2 * H)
    row_offset = comm.rank(axis) * Yl - H

    def march_rebin_block(u, v, fluid, solid, slots, dt, count, dead):
        padded_ = [padded(a, comm, H, axis)
                   for a in (u, v, fluid, solid, slots, count, dead)]
        oslots, ocount, odrop = march_rebin(
            cfg_local, *padded_[:5], dt, padded_[5], dead=padded_[6],
            clamp_ny=Y, row_offset=row_offset)
        return (oslots[:, H:H + Yl].contiguous(),
                ocount[H:H + Yl].contiguous(), odrop[H:H + Yl].contiguous())

    return march_rebin_block


def make_sharded_marker_pass(cfg: SimConfig, mesh, axis: str = "y"):
    """A drop-in for `markers_slots.marker_pass_slots` running K1 per row
    shard (`pallas_shard.py:109`): pass it to `sim.step_frame(...,
    marker_pass=)`.  The scenario and state are this rank's block
    (`spatial.shard_spatial`); `alive_count` and the new drops are summed
    over `axis`."""
    kernel = make_sharded_march_rebin(cfg, mesh, axis)
    comm = as_comm(mesh)

    def marker_pass(cfg_: SimConfig, scn, state, dt, defer_alive=False):
        if cfg_ != cfg:
            raise ValueError("the sharded marker pass was made for another "
                             "configuration")
        K = cfg.slots_per_cell
        Yl, X = state.u.shape
        dead = scn.sink | scn.solid
        oslots, count, drop = kernel(
            state.u, state.v, state.fluid, scn.solid,
            state.markers.reshape(2 * K, Yl, X), dt, state.marker_count,
            dead)
        out = finish_marker_pass(cfg, state, oslots, count, drop,
                                 defer_alive)
        sums = torch.stack([count.sum(dtype=torch.int32),
                            drop.sum(dtype=torch.int32)])
        comm.all_reduce(sums, "sum", (axis,))
        return out.replace(alive_count=sums[0],
                           dropped_markers=state.dropped_markers + sums[1])

    return marker_pass


def make_spatial_step_pallas(cfg: SimConfig, mesh, axis: str = "y"):
    """The JAX package's frame on row blocks with the sharded marker pass
    (`pallas_shard.py:133`): fn(scn, state) -> state on this rank's
    block.  The JAX step runs K1 per shard and solves on its XLA path
    (pallas_shard.py:150-154, the jnp `pcg_loop` under GSPMD); the port's
    is `spatial.make_spatial_step`, whose marker pass is this module's
    K1 per row shard, its grid stage K7 and its solve P4 on the blocks.
    Row blocks only ("y"; x = 1)."""
    if axis != "y":
        raise ValueError(f"row blocks split 'y', not {axis!r}")
    from euler_tpu_torch.parallel.spatial import make_spatial_step

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
