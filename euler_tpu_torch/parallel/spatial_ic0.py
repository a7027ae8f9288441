"""The frame's global IC(0) solve on ("y", "x") blocks (ROADMAP M12 part
d, item 2): what GSPMD makes of `euler_tpu/ops/ic0.py:35-76` and
`ops/project.py:115-181` in the JAX package's frame on blocks
(`parallel/spatial.py:113`, `jax.jit(step_frame)` on a sharded state).

The JAX frame on blocks solves the whole grid's system with its jnp
`pcg_loop`, apply_a's operator order and `make_ic0_preconditioner` over
the WHOLE grid, rebuilt from zeros for each solve: P1 + P2's function
(`ops/cuda/pcg_general_kernel`).  Here each block holds its own cells of
it.  The E_inv recurrence and the forward solve at (y, x) read (y, x - 1)
and (y - 1, x); the back solve reads z at (y, x + 1) and (y + 1, x) with
the cell's own E_inv.  So the blocks sweep in stages:
  * block (by, bx) runs its build and its forward solve at stage
    `by + bx`, its back solve at `(ny - 1 - by) + (nx - 1 - bx)`, of
    ny + nx - 1 stages (`schedule`);
  * before each stage but the first every block exchanges the edge row
    and column of the plane being swept (`comm.exchange`, a collective:
    every block joins every stage, its own or not), and the blocks of
    that stage read their neighbours' edges from it: the west and south
    E_inv (kept from the build for the forward solves) and q, or the
    east and north z; zeros at the grid's edges.
A cell's arithmetic is `ops/ic0.py`'s, operand for operand
(`ops/ic0.BlockIc0`), so the blocks' E_inv and z put together are the
whole grid's bit for bit, and the loop (`halo.pcg_sharded` with apply_a's
order, the dots summed and the maxima maxed over the blocks) is P1 + P2's
on one block and within an iteration of it on more.

`solve_pressure_blocks_ic0(cfg, comm, axes, b, a_diag, fluid, x0)`:
(p, iterations, residual), the last two the same on every block.  CUDA
tensors run P6 (`ops/cuda/pcg_ic0_blocks_kernel.py`), CPU tensors the
plain version, `pcg_sharded` with `block_ic0`'s sweeps.  A gloo group
with CUDA tensors raises.  `precondition_blocks` runs the sweeps alone:
(E_inv, z) of one application, for checks.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.pcg_shard_kernel import check_solver
from euler_tpu_torch.ops.ic0 import BlockIc0
from euler_tpu_torch.parallel.comm import as_comm
from euler_tpu_torch.parallel.halo import pcg_sharded


def schedule(comm, axes) -> tuple[int, int, int]:
    """(stages, this block's build and forward stage, its back stage)."""
    ny, by = comm.size("y"), comm.rank("y")
    nx, bx = ((comm.size("x"), comm.rank("x")) if "x" in axes else (1, 0))
    return ny + nx - 1, by + bx, (ny - 1 - by) + (nx - 1 - bx)


def edges(comm, axes, plane, after: bool = False):
    """The neighbours' edges of `plane` (every block calls it): (west
    column [Y], south row [X]), or with `after` (east, north); None on an
    axis no block splits."""
    k = int(after)
    row = comm.exchange(plane, 1, "y")[k][0]
    col = comm.exchange(plane, 1, "x")[k][:, 0] if "x" in axes else None
    return col, row


def sweep(comm, axes, stages: int, stage: int, plane, run,
          after: bool = False) -> None:
    """One staged sweep: `run(edges)` at this block's `stage`, the edges of
    `plane()` exchanged before every stage but the first."""
    got = (None, None)
    for s in range(stages):
        if s:
            got = edges(comm, axes, plane(), after)
        if s == stage:
            run(got)


def block_ic0(cfg: SimConfig, comm, axes, a_diag, fluid):
    """The whole grid's IC(0) on this block (every block calls it): E_inv
    built here in stages, and z = M^-1 r, the forward and back solves in
    stages, for each call of the function it returns."""
    comm = as_comm(comm)
    blk = BlockIc0(a_diag, fluid, getattr(torch, cfg.solver.dtype))
    stages, fwd, back = schedule(comm, axes)
    sweep(comm, axes, stages, fwd, lambda: blk.e_inv,
          lambda e: blk.build(*e))

    def apply(r):
        out = [torch.zeros_like(r)]

        def forward(e):
            out[0] = blk.forward(r, *e)

        sweep(comm, axes, stages, fwd, lambda: out[0], forward)
        q, out[0] = out[0], torch.zeros_like(r)

        def backward(e):
            out[0] = blk.back(q, *e)

        sweep(comm, axes, stages, back, lambda: out[0], backward, True)
        return out[0]

    apply.e_inv = blk.e_inv
    return apply


def precondition_blocks(cfg: SimConfig, comm, axes, a_diag, fluid, r):
    """The whole grid's IC(0) alone on this block (every block calls it):
    (E_inv, z = M^-1 r), this block's cells.  CUDA tensors run P6's
    sweeps, CPU tensors `block_ic0`."""
    comm = as_comm(comm)
    if r.device.type == "cpu":
        _build.PLAIN_CALLS["P6"] += 1
        apply = block_ic0(cfg, comm, axes, a_diag, fluid)
        z = apply(r)
        return apply.e_inv, z
    from euler_tpu_torch.ops.cuda.pcg_ic0_blocks_kernel import (
        precondition_ic0_blocks,
    )

    return precondition_ic0_blocks(cfg, comm, axes, a_diag, fluid, r)


def solve_pressure_blocks_ic0(cfg: SimConfig, comm, axes, b, a_diag, fluid,
                              x0=None):
    """PCG with the whole grid's IC(0) for A p = b on this block (see the
    top of this module); `x0` (zero outside the fluid) a warm start.
    Returns (p, iterations, residual), the last two the same on every
    block."""
    check_solver(cfg)
    if cfg.solver.preconditioner != "ic0":
        raise ValueError("the global IC(0) solve on blocks takes "
                         "preconditioner='ic0', not "
                         f"{cfg.solver.preconditioner!r}")
    comm = as_comm(comm)
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["P6"] += 1
        return pcg_sharded(cfg, comm, axes, b, a_diag, fluid, x0,
                           precon=block_ic0(cfg, comm, axes, a_diag, fluid),
                           grid_order=True)
    from euler_tpu_torch.ops.cuda.pcg_ic0_blocks_kernel import (
        solve_ic0_blocks,
    )

    return solve_ic0_blocks(cfg, comm, axes, b, a_diag, fluid, x0)

