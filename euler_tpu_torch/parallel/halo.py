"""The pressure solve on blocks of the grid
(`euler_tpu/parallel/halo.py`).

The JAX package row-shards (or block-shards) the grid over a mesh axis
under shard_map: the 5-point operator reads its neighbours' edge rows
(and columns) through ppermute, and the PCG reductions are psum / pmax.
The port holds one block a rank (`parallel/spatial.shard_spatial`), or
one block a thread of an in-process `comm.LocalGroup`, and talks to the
neighbours through a `comm` (`parallel/comm.py`):

  * `halo_exchange_rows` / `halo_exchange_cols`: the neighbour blocks'
    edge row (column) on either side, zeros at the grid's edges;
  * `apply_a_local`: the operator on a block, a s - (((left + right) +
    up) + down) masked by fluid, in halo.py:84's order (or, with
    `grid_order`, `ops/project.apply_a`'s: the order of the single-device
    function GSPMD partitions in the frame on blocks, P5's), with the
    block's a_diag the global one, cut;
  * `pcg_sharded`: the port's `ops/project.pcg_loop` with that operator,
    the dots summed and the maxima maxed over the blocks, and the
    preconditioner of `block_preconditioner`, halo.py:113-139's rule:
    block-Jacobi additive Schwarz MG for "mg" (one Galerkin cycle on each
    block's own hierarchy), and the jnp-form Jacobi for every other
    preconditioner, "none" and "ic0" included; or a given one (P4's own
    none / Jacobi, P5's global cycle and P6's global IC(0) sweep pass
    theirs);
  * `make_sharded_pressure_solver(cfg, mesh, axes, stats)`: the entry
    point, whose function takes this block's b, a_diag, fluid (and a
    warm start x0) and runs halo.py's function: P4
    (`ops/cuda/pcg_shard_kernel.py`) with Jacobi, or block MG, on CUDA
    tensors, `pcg_sharded` on CPU tensors.  Every block returns the same
    iterations and residual.

The frame on blocks keeps its own rule (`parallel/spatial.Blocks`: the
JAX frame's "none" is no preconditioner and its "ic0" the whole grid's
IC(0)), so it calls P4, P5 and P6 directly.  Every solve here runs in
f32 and in f64, block MG included (its hierarchy and cycle in the solver
dtype).
"""

from __future__ import annotations

import dataclasses

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import shift_left, shift_right
from euler_tpu_torch.ops.cuda.pcg_shard_kernel import (
    check_solver,
    solve_pressure_sharded,
)
from euler_tpu_torch.ops.project import jacobi_preconditioner_jnp, pcg_loop
from euler_tpu_torch.parallel.comm import as_comm


def halo_exchange_rows(x, comm):
    """(below, above): the last row of the block before this one along
    "y" and the first row of the block after it, zeros at the grid's
    bottom and top."""
    return comm.exchange(x, 1, "y")


def halo_exchange_cols(x, comm):
    """(left, right): the last column of the block before this one along
    "x" and the first column of the block after it, zeros at the grid's
    edges."""
    return comm.exchange(x, 1, "x")


def apply_a_local(a_diag, fluid, s, comm, axes=("y",),
                  grid_order: bool = False):
    """The masked 5-point operator on this block (halo.py:71-85), its
    neighbour rows (and, with "x" in axes, columns) exchanged; with
    `grid_order` in `ops/project.apply_a`'s order."""
    below, above = halo_exchange_rows(s, comm)
    up = torch.cat([s[1:], above], 0)
    down = torch.cat([below, s[:-1]], 0)
    if "x" in axes:
        lh, rh = halo_exchange_cols(s, comm)
        left = torch.cat([lh, s[:, :-1]], 1)
        right = torch.cat([s[:, 1:], rh], 1)
    else:
        left, right = shift_left(s), shift_right(s)
    nb = (left + right + down + up) if grid_order else (left + right + up
                                                         + down)
    lap = a_diag.to(s.dtype) * s - nb
    return torch.where(fluid, lap, 0.0)


def block_preconditioner(cfg: SimConfig, a_diag, fluid, dtype):
    """z = M^-1 r on this block by halo.py:113-139's rule: "mg", one
    Galerkin cycle on the block's own hierarchy masked by fluid; every
    other preconditioner ("jacobi", "none", "ic0") the jnp-form Jacobi
    (halo.py:136-139)."""
    if cfg.solver.preconditioner != "mg":
        return jacobi_preconditioner_jnp(a_diag, fluid)
    from euler_tpu_torch.ops.multigrid import (
        build_galerkin_hierarchy,
        cycle_galerkin,
        cycle_kwargs,
    )

    levels = build_galerkin_hierarchy(a_diag, fluid, dtype,
                                      min_size=cfg.solver.mg_min_size)
    kw = cycle_kwargs(cfg)
    return lambda r: torch.where(fluid, cycle_galerkin(levels, r, **kw), 0.0)


def pcg_sharded(cfg: SimConfig, comm, axes, b, a_diag, fluid, x0=None,
                precon=None, grid_order: bool = False):
    """halo.py's `_pcg_sharded`: `pcg_loop` on this block with the
    exchanging operator and the all-reduced dots and maxima, and
    `block_preconditioner` (or `precon`; `grid_order`: the operator in
    apply_a's order).  The plain version of P4, P5 and P6.  Returns (p,
    iterations, residual)."""

    def dot(x, y):
        t = (x * y).sum()
        comm.all_reduce(t, "sum", axes)
        return t

    def inf_norm(r):
        t = r.abs().max()
        comm.all_reduce(t, "max", axes)
        return t

    if precon is None:
        precon = block_preconditioner(cfg, a_diag, fluid, b.dtype)
    return pcg_loop(cfg, b, lambda s: apply_a_local(a_diag, fluid, s, comm,
                                                    axes, grid_order),
                    precon, x0=x0, dot=dot, inf_norm=inf_norm)


def make_sharded_pressure_solver(cfg: SimConfig, mesh, axes=("y",),
                                 stats: bool = False):
    """The domain-decomposed pressure solve over `mesh[axes]` (halo.py:
    151): axes ("y",) splits the grid's rows, ("y", "x") its rows and
    columns.  `mesh` is a `DeviceMesh` (this rank's block) or a block of
    an in-process `comm.LocalGroup`.  Returns fn(b, a_diag, fluid,
    x0=None) -> p, or (p, iterations, residual) with `stats`, on this
    block's [Yl, Xl] planes (`x0`, zero outside the fluid, warm-starts
    it, as `project()`'s).  Every preconditioner but "mg" runs the
    jnp-form Jacobi, as halo.py's does."""
    axes = tuple(axes)
    if axes not in (("y",), ("y", "x")):
        raise ValueError(f"axes {axes}: ('y',) or ('y', 'x')")
    check_solver(cfg)
    comm = as_comm(mesh)
    if cfg.solver.preconditioner != "mg":
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, preconditioner="jacobi"))

    def solve(b, a_diag, fluid, x0=None):
        p, iters, resid = solve_pressure_sharded(cfg, comm, axes, b, a_diag,
                                                 fluid, x0)
        return (p, iters, resid) if stats else p

    return solve
