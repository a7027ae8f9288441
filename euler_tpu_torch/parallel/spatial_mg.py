"""The frame's global MG solve on ("y", "x") blocks (ROADMAP M12 part d,
item 1): what GSPMD makes of `euler_tpu/ops/multigrid.py:239-489` and
`ops/project.py:115-181` in the JAX package's frame on blocks
(`parallel/spatial.py:113`, `jax.jit(step_frame)` on a sharded state).

The JAX frame on blocks solves the whole grid's system with its jnp
`pcg_loop` and one Galerkin W-cycle over the WHOLE grid's hierarchy as
the preconditioner (`make_mg_preconditioner`), partitioned by XLA.  That
is P3's function (`ops/cuda/pcg_general_kernel`), not P4's block-Jacobi
Schwarz MG (`parallel/halo.py`), whose iterations grow with the blocks.
Here each block holds its cells of it:
  * `block_plan`: where the block lies, and the gather level G: the first
    level where P3's coarse cluster launch takes over (`fused_level`:
    `GATHER_CELLS`, csrc/mg_levels.cuh kFusedCells, or in f64 a level
    lower, where the levels below fit a CTA's shared memory), or an
    earlier one where a block's extent turns odd or under `MIN_EXTENT`
    cells.  Levels 0 .. G - 1 are distributed (every one of them even on
    the block, so its restriction and prolongation stay in the block);
    from G the whole coarse grid is gathered onto every block.  At 1024²
    that keeps 1024², 512² and 256² on the blocks and gathers 128² and
    below (f64: 128² on the blocks too).  A block with an odd side
    (1080 x 1920 on 8 row blocks of 135 rows, 999² on 3 x 3) gathers at
    level 0: every block holds the whole grid's hierarchy, level 0 padded
    where the grid is odd, and runs the whole cycle;
  * `build_block_hierarchy`: the block's levels 0 .. G - 1 (level 0's
    couplings across the block's edges from the fluid ring, each level's
    west e and south n edges from the neighbours, each Gershgorin bound
    maxed over the blocks), and the whole levels from G down (level G's
    c, e, n, active all-gathered, then `ops/multigrid.extend_hierarchy`,
    which pads an odd level before coarsening it); the hierarchy is
    exact, so it is the whole grid's bit for bit;
  * `block_cycle`: z = M r on the block: `cycle_galerkin` with the
    operator's neighbours exchanged, and at level G the restricted
    residual (at G = 0 r itself) all-gathered, the cycle run on the whole
    coarse grid (zero-padded where it is odd, and cropped), and the
    block's part of the correction kept: bit for bit the single-device
    cycle;
  * `solve_pressure_blocks(cfg, comm, axes, b, a_diag, fluid, fluid1,
    x0)`: (p, iterations, residual), the last two the same on every
    block.  CUDA tensors run P5 (`ops/cuda/pcg_mg_blocks_kernel.py`), CPU
    tensors the plain version `pcg_blocks_plain`: `halo.pcg_sharded`
    with apply_a's operator order and `block_cycle` (the dots summed and
    the maxima maxed over the blocks).  A gloo group with CUDA tensors
    raises.
Galerkin MG with Chebyshev smoothing, in f32 or f64 (`solver.dtype`:
every level, bound and Chebyshev row in that precision, as P3's); RB-GS
and rediscretized MG are ROADMAP M14 part b
(`pcg_shard_kernel.check_solver`).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import cycle_args, padded_level_shapes
from euler_tpu_torch.ops.cuda.pcg_shard_kernel import check_solver
from euler_tpu_torch.ops.multigrid import (
    _blocks,
    _edge_level,
    cheby_smooth,
    coarsen_planes,
    cycle_galerkin,
    cycle_kwargs,
    extend_hierarchy,
)
from euler_tpu_torch.parallel.comm import as_comm
from euler_tpu_torch.parallel.halo import pcg_sharded
from euler_tpu_torch.parallel.mesh import block_span

# P3's coarse cluster launch takes over at the first level of at most this
# many cells that the truncated W visits once (csrc/mg_levels.cuh
# kFusedCells): the levels from there down are gathered
GATHER_CELLS = 128 * 128
# ... or lower, where the 9 planes of every level below it do not fit a
# CTA's shared memory in the solver dtype (`make_solve`; f64 at 1024²).
# The card's limit is the H100's opt-in, 227 KiB, less the launch's static
# shared memory: taking the whole opt-in here can only gather at a level
# at or above the card's fused one, which the gathered `Solve` accepts
FUSED_SMEM = 227 * 1024
FUSED_PLANES = 9
# a level where a block is thinner than this is gathered
MIN_EXTENT = 8


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """The grid's MG levels as stored (`mg_kernel.padded_level_shapes`),
    the gather level, and the block's place at level 0: rows [r0, r0 +
    rows), columns [c0, c0 + cols)."""

    shapes: tuple
    gather: int
    r0: int
    rows: int
    c0: int
    cols: int

    def block_shape(self, l: int) -> tuple[int, int]:
        """The block's extent at a level <= the gather level."""
        return self.rows >> l, self.cols >> l

    def offset(self, l: int) -> tuple[int, int]:
        """The block's first row and column at a level <= the gather
        level."""
        return self.r0 >> l, self.c0 >> l


def fused_level(cfg: SimConfig, shapes) -> int:
    """Where P3's `Solve` runs its coarse cluster launch (`make_solve`):
    the first level below 0 of at most GATHER_CELLS cells that the
    truncated W visits once, or the first below it whose lower levels fit
    FUSED_SMEM in the solver dtype; len(shapes) where there is none."""
    L = len(shapes)
    _, _, w, w_depth = cycle_args(cfg)
    item = torch.finfo(getattr(torch, cfg.solver.dtype)).bits // 8
    level = next((l for l in range(1, L)
                  if shapes[l][0] * shapes[l][1] <= GATHER_CELLS), L)
    while level < L and w != 1 and level < w_depth and level + 1 < L - 1:
        level += 1
    while level < L and FUSED_PLANES * item * sum(
            Y * X for Y, X in shapes[level + 1:]) > FUSED_SMEM:
        level += 1
    return level


def block_plan(cfg: SimConfig, comm, axes, gather: int | None = None):
    """This block's `BlockPlan` (`gather`: an earlier gather level, which
    changes no bit of the result)."""
    shapes = tuple(padded_level_shapes(cfg.ny, cfg.nx,
                                       cfg.solver.mg_min_size))
    r0, rows = block_span(cfg.ny, comm.size("y"), comm.rank("y"), "y")
    c0, cols = (block_span(cfg.nx, comm.size("x"), comm.rank("x"), "x")
                if "x" in axes else (0, cfg.nx))
    if len(shapes) < 2:
        raise ValueError(f"MG on blocks of a {cfg.ny} x {cfg.nx} grid: its "
                         f"hierarchy has one level (mg_min_size "
                         f"{cfg.solver.mg_min_size}); nothing to gather")
    # level 1 is made from the blocks' 2 x 2 cells only where both sides
    # are even; else the blocks gather level 0
    top = (0 if rows % 2 or cols % 2
           else min(fused_level(cfg, shapes), len(shapes) - 1))
    for l in range(1, top):
        y, x = rows >> l, cols >> l
        if y % 2 or x % 2 or min(y, x) < MIN_EXTENT:
            top = l
            break
    if gather is not None:
        if not 0 <= gather <= top:
            raise ValueError(f"gather level {gather}: 0 .. {top} here")
        top = gather
    return BlockPlan(shapes, top, r0, rows, c0, cols)


def fluid_ring(fluid1, split: bool):
    """(below, above, left, right): the fluid one cell beyond each edge of
    the block, from `fluid1`, the block with one row (and, `split`, one
    column) of each neighbour's; False on an axis no block splits."""
    if split:
        ring = (fluid1[0, 1:-1], fluid1[-1, 1:-1], fluid1[1:-1, 0],
                fluid1[1:-1, -1])
    else:
        none = torch.zeros(fluid1.shape[0] - 2, dtype=torch.bool,
                           device=fluid1.device)
        ring = (fluid1[0], fluid1[-1], none, none)
    return tuple(t.contiguous() for t in ring)


def gather_plane(t, comm, axes):
    """The whole grid's plane from every block's `t` ([.., Yl, Xl]):
    gathered over "x" in column order, then over "y" in row order."""
    if "x" in axes:
        t = comm.gather(t, -1, "x")
    return comm.gather(t, -2, "y")


@dataclasses.dataclass
class BlockHierarchy:
    """The block's levels 0 .. G - 1 (`EdgeLevel`s, each `lmax` the grid's)
    and their (west e, south n) edges (none at G = 0); `gather`, G;
    `coarse`: the grid's level list with the whole levels G .. L - 1
    (None below G)."""

    plan: BlockPlan
    levels: list
    edges: list
    coarse: list

    @property
    def gather(self) -> int:
        return self.plan.gather


def _neighbour_edges(e, n, comm, axes):
    """(west, south): e of the column before the block and n of the row
    before it, from the neighbours (zeros at the grid's edges)."""
    south = comm.exchange(n, 1, "y")[0][0]
    if "x" not in axes:
        return torch.zeros_like(e[:, 0]), south
    return comm.exchange(e, 1, "x")[0][:, 0], south


def _block_level(comm, axes, c, e, n, active, west, south):
    """The block's `EdgeLevel`, its Gershgorin bound maxed over the
    blocks."""
    level = _edge_level(c, e, n, active, west, south)
    comm.all_reduce(level.lmax, "max", axes)
    return level


def build_block_hierarchy(cfg: SimConfig, comm, axes, a_diag, fluid, ring,
                          gather: int | None = None) -> BlockHierarchy:
    """The grid's Galerkin hierarchy (`build_galerkin_hierarchy`) on this
    block (see the top of this module); `ring` as `fluid_ring` gives it."""
    comm = as_comm(comm)
    plan = block_plan(cfg, comm, axes, gather)
    dtype = getattr(torch, cfg.solver.dtype)
    below, above, left, right = ring
    fl = fluid
    # level 0 (fine_edge_level) with the couplings across the block's edges
    c = torch.where(fl, a_diag, 0).to(dtype)
    e = torch.where(fl & torch.cat([fl[:, 1:], right[:, None]], 1), -1.0,
                    0.0).to(dtype)
    n = torch.where(fl & torch.cat([fl[1:], above[None]], 0), -1.0,
                    0.0).to(dtype)
    act, levels, edges = fl, [], []
    if plan.gather:
        edges.append((torch.where(left & fl[:, 0], -1.0, 0.0).to(dtype),
                      torch.where(below & fl[0], -1.0, 0.0).to(dtype)))
        levels.append(_block_level(comm, axes, c, e, n, fl, *edges[0]))
        for _ in range(1, plan.gather):
            c, e, n, act = coarsen_planes(levels[-1])
            edges.append(_neighbour_edges(e, n, comm, axes))
            levels.append(_block_level(comm, axes, c, e, n, act,
                                       *edges[-1]))
        c, e, n, act = coarsen_planes(levels[-1])
    whole = gather_plane(torch.stack([c, e, n, act.to(dtype)]), comm, axes)
    top = _edge_level(whole[0], whole[1], whole[2], whole[3] != 0)
    coarse = extend_hierarchy([None] * plan.gather + [top],
                              cfg.solver.mg_min_size)
    return BlockHierarchy(plan, levels, edges, coarse)


def _apply_block(level, west, south, comm, axes, x):
    """`apply_edge` on the block: x's neighbours beyond it, and the
    products of the couplings across its west and south edges, from the
    neighbours (the single-device function's operands and order)."""
    below, above = comm.exchange(x, 1, "y")
    if "x" in axes:
        left, right = comm.exchange(x, 1, "x")
    else:
        left = right = torch.zeros_like(x[:, :1])
    return (level.c * x
            + level.e * torch.cat([x[:, 1:], right], 1)
            + torch.cat([west[:, None] * left, (level.e * x)[:, :-1]], 1)
            + level.n * torch.cat([x[1:], above], 0)
            + torch.cat([south[None] * below, (level.n * x)[:-1]], 0))


def block_cycle(cfg: SimConfig, comm, axes, h: BlockHierarchy, b,
                lvl: int = 0):
    """z = M b on this block: `cycle_galerkin` from level `lvl` (<= G) of
    the hierarchy `h`."""
    kw = cycle_kwargs(cfg)
    G = h.gather
    if lvl == G:
        z = cycle_galerkin(h.coarse, gather_plane(b, comm, axes), lvl=G,
                           **kw)
        (r0, c0), (Yl, Xl) = h.plan.offset(G), h.plan.block_shape(G)
        return z[r0:r0 + Yl, c0:c0 + Xl]
    level = h.levels[lvl]
    apply = functools.partial(_apply_block, level, *h.edges[lvl], comm, axes)
    smooth = functools.partial(cheby_smooth, level, degree=kw["cheby_degree"],
                               ratio=kw["cheby_ratio"], apply=apply)
    x = smooth(torch.zeros_like(b), b)
    L = len(h.coarse)
    visits = kw["w"] if (lvl < kw["w_depth"] and lvl + 1 < L - 1) else 1
    for _ in range(visits):
        r = b - apply(x)
        ec = block_cycle(cfg, comm, axes, h, _blocks(r).sum((1, 3)),
                         lvl + 1)
        x = x + ec.repeat_interleave(2, 0).repeat_interleave(2, 1)
    x = smooth(x, b)
    return torch.where(level.active, x, 0.0)


def pcg_blocks_plain(cfg: SimConfig, comm, axes, b, a_diag, fluid, ring,
                     x0=None):
    """The plain version of P5: `pcg_loop` on this block with apply_a's
    operator, the all-reduced dots and maxima, and `block_cycle` on the
    block's hierarchy.  Returns (p, iterations, residual)."""
    h = build_block_hierarchy(cfg, comm, axes, a_diag, fluid, ring)
    return pcg_sharded(cfg, comm, axes, b, a_diag, fluid, x0,
                       precon=lambda r: block_cycle(cfg, comm, axes, h, r),
                       grid_order=True)


def solve_pressure_blocks(cfg: SimConfig, comm, axes, b, a_diag, fluid,
                          fluid1, x0=None):
    """PCG with the global MG cycle for A p = b on this block of the grid
    (see the top of this module): `fluid1` is the block's fluid with one
    row (and column, where "x" splits) of each neighbour's, `x0` (zero
    outside the fluid) a warm start.  Returns (p, iterations, residual),
    the last two the same on every block."""
    check_solver(cfg)
    if cfg.solver.preconditioner != "mg":
        raise ValueError("the global MG solve on blocks takes "
                         f"preconditioner='mg', not "
                         f"{cfg.solver.preconditioner!r}")
    comm = as_comm(comm)
    ring = fluid_ring(fluid1, "x" in axes)
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["P5"] += 1
        return pcg_blocks_plain(cfg, comm, axes, b, a_diag, fluid, ring, x0)
    from euler_tpu_torch.ops.cuda.pcg_mg_blocks_kernel import solve_mg_blocks

    return solve_mg_blocks(cfg, comm, axes, block_plan(cfg, comm, axes), b,
                           a_diag, fluid, ring, x0)


def make_block_mg_solver(cfg: SimConfig, mesh, axes):
    """The frame's MG solve on this block of `mesh` over `axes`: checks the
    configuration and the blocks (`block_plan`) now, and returns fn(b,
    a_diag, fluid, fluid1, x0=None) -> (p, iterations, residual)."""
    comm = as_comm(mesh)
    check_solver(cfg)
    block_plan(cfg, comm, axes)

    def solve(b, a_diag, fluid, fluid1, x0=None):
        return solve_pressure_blocks(cfg, comm, axes, b, a_diag, fluid,
                                     fluid1, x0)

    return solve
