"""K7: the grid stage of a substep (`euler_tpu/ops/pallas/grid_kernel.py`).

`grid_stage` replaces the Pallas kernel `_grid_kernel` launched by
`grid_stage_pallas` (grid_kernel.py:172-221), same contract: extrapolate
-> zero_bounds -> advect -> gravity -> zero_bounds (main.c:865-889) of
(u, v), returning (ut, vt).  On the card it is the grid stage of every
substep route that is not fused (the JAX package's K7 route, and the
routes where it leaves the grid stage to XLA); with `extrapolated=True`
(rainbow) it also returns the extrapolated, zeroed velocities, which the
colours' advection reads.

On an H100 it is bound by bytes: u and v in, three u8 masks, ut and vt
out, 19 bytes a cell (20 MB at 1024²).  It is one launch of
`csrc/grid_stage.cuh` `grid_passes` (K2's and K10's grid stage too): one
CTA per tile of `grid_tile_plan`, which stages the tile's window in
shared memory and keeps the extrapolated velocities there, so nothing
but ut and vt (and uu, vv) is written.

`grid_stage_plain` is the plain version, the op sequence of
tests/test_pallas_grid.py:27-36; its first half `extrapolate_zero` is
also what the rainbow form returns beside it.  `grid_lib` builds and
binds `csrc/grid_stage.cu`, which K2 also uses.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.advect import advect_u, advect_v
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.forces import apply_body_forces, zero_bounds

# K7's tiles (csrc/grid_stage.cuh `GridTile`): TILE_Y x TILE_X cells and
# TILE_THREADS threads a CTA, or TILE_X_WIDE cells across where the grid
# holds at least WIDE_MIN_TILES such tiles: the fastest of the sweep in
# PERF.md §6 at 1024², 2048² and 4096² (tools/grid_tile_lab.py).  Wider
# tiles load less halo a cell, but below ~4096 tiles (about 5 rounds of
# the 6 CTAs an H100 SM holds at 40 registers a thread) the last round's
# tail costs more than that saves.  The kernel is built for the widths of
# TILE_XS; a tile must fit the SMEM_BYTES_MAX bytes of shared memory a
# launch gets without opting in to more.
TILE_Y = 16
TILE_X = 32
TILE_X_WIDE = 64
WIDE_MIN_TILES = 4096
TILE_THREADS = 256
TILE_XS = (32, 64, 128)
SMEM_BYTES_MAX = 48 * 1024


class GridTilePlan(NamedTuple):
    """K7's launch (csrc/grid_stage.cuh `GridTile`) and the shared memory
    of one CTA."""
    tile_y: int
    tile_x: int
    tiles_y: int  # CTAs down the grid
    tiles_x: int  # CTAs across it
    threads: int
    smem_bytes: int


def grid_tile_smem_bytes(tile_y: int, tile_x: int) -> int:
    """The shared memory of one K7 tile (csrc/grid_stage.cuh
    `grid_tile_smem`): u and v (4 bytes each) and the u/v property bits
    (1) over the window of (tile_y + 4) x (tile_x + 4) cells, the
    extrapolated u and v (4 each) over the tile and its one-cell ring, and
    the mask bits (1) over (tile_y + 5) x (tile_x + 5) cells."""
    return (9 * (tile_y + 4) * (tile_x + 4) + 8 * (tile_y + 2) * (tile_x + 2)
            + (tile_y + 5) * (tile_x + 5))


@functools.lru_cache(maxsize=64)
def grid_tile_plan(Y: int, X: int, tile_y: int = TILE_Y,
                   tile_x: int | None = None,
                   threads: int = TILE_THREADS) -> GridTilePlan:
    """K7's launch over a [Y, X] grid: tiles of tile_y x tile_x cells
    (by default as the comment above TILE_Y says; the ragged edge tiles,
    and grids smaller than one tile, are masked in the kernel).  Raises
    for a tile the kernel does not take."""
    if tile_x is None:
        wide = -(-Y // tile_y) * -(-X // TILE_X_WIDE) >= WIDE_MIN_TILES
        tile_x = TILE_X_WIDE if wide else TILE_X
    smem = grid_tile_smem_bytes(tile_y, tile_x)
    if (tile_x not in TILE_XS or tile_y < 1 or threads % 32
            or not 32 <= threads <= 512 or smem > SMEM_BYTES_MAX):
        raise ValueError(f"no K7 tile of {tile_y} x {tile_x} cells and "
                         f"{threads} threads ({smem} bytes of shared "
                         "memory)")
    return GridTilePlan(tile_y, tile_x, -(-Y // tile_y), -(-X // tile_x),
                        threads, smem)


def extrapolate_zero(cfg: SimConfig, u, v, fluid, prev_fluid, solid,
                     clamp_ny=None, row_offset=0, clamp_nx=None,
                     col_offset=0):
    """extrapolate -> zero_bounds (main.c:865-870): the velocities the
    advection reads (the colours' advection too).  `clamp_ny`,
    `row_offset`, `clamp_nx`, `col_offset`: on a block padded with its
    neighbours' cells, the grid's row and column counts and the grid row
    and column of its cell (0, 0) (see `grid_stage`)."""
    at = dict(clamp_ny=clamp_ny, row_offset=row_offset, clamp_nx=clamp_nx,
              col_offset=col_offset)
    uu = extrapolate(cfg, u, fluid, prev_fluid, "u", **at)
    vv = extrapolate(cfg, v, fluid, prev_fluid, "v", **at)
    return (zero_bounds(cfg, uu, fluid, solid, "u", **at),
            zero_bounds(cfg, vv, fluid, solid, "v", **at))


def advect_forces(cfg: SimConfig, uu, vv, fluid, solid, dt, clamp_ny=None,
                  row_offset=0, clamp_nx=None, col_offset=0):
    """advect -> gravity -> zero_bounds (main.c:871-889)."""
    at = dict(clamp_ny=clamp_ny, row_offset=row_offset, clamp_nx=clamp_nx,
              col_offset=col_offset)
    ut = advect_u(cfg, uu, vv, fluid, dt, **at)
    vt = advect_v(cfg, uu, vv, fluid, dt, **at)
    vt = apply_body_forces(cfg, vt, dt, **at)
    return (zero_bounds(cfg, ut, fluid, solid, "u", **at),
            zero_bounds(cfg, vt, fluid, solid, "v", **at))


def grid_stage_plain(cfg: SimConfig, dt, u, v, fluid, prev_fluid, solid,
                     clamp_ny=None, row_offset=0, clamp_nx=None,
                     col_offset=0):
    """extrapolate -> zero_bounds -> advect -> gravity -> zero_bounds
    (main.c:865-889): the velocities the projection starts from."""
    at = (clamp_ny, row_offset, clamp_nx, col_offset)
    uu, vv = extrapolate_zero(cfg, u, v, fluid, prev_fluid, solid, *at)
    return advect_forces(cfg, uu, vv, fluid, solid, dt, *at)


@functools.cache
def grid_lib():
    """csrc/grid_stage.cu: K7 (`eu_grid_passes`), K2's grid stage + RHS
    (`eu_grid_stage`) and its tail (`eu_project_tail`), built and bound
    once."""
    lib = _build.load("grid_stage", flags=["-fmad=false"])
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_grid_passes", [I] * 6 + [F, F] + [P] * 10
                + [I] * 3 + [P])
    _build.bind(lib, "eu_grid_stage", [I, I, F, F, F] + [P] * 13 + [I] * 3
                + [P])
    _build.bind(lib, "eu_project_tail", [I, I, F] + [P] * 10)
    return lib


def grid_stage(cfg: SimConfig, u, v, fluid, prev_fluid, solid, dt, *,
               extrapolated: bool = False, clamp_ny=None, row_offset=0,
               clamp_nx=None, col_offset=0):
    """The grid stage of one substep.  Returns (ut, vt), with
    `extrapolated` (ut, vt, uu, vv): uu, vv the extrapolated, zeroed
    velocities (`extrapolate_zero`).  CUDA tensors run the kernel; CPU
    tensors the plain version.

    On a block (`parallel/spatial.py`) the planes are the block's cells
    with H of each neighbour's rows and columns around them (cfg.ny,
    cfg.nx their counts), `clamp_ny` / `clamp_nx` the grid's row and
    column counts and `row_offset` / `col_offset` the grid row and
    column of the planes' cell (0, 0): the interpolation clamps, the u
    and v sample regions, the sites' grid coordinates, gravity and the
    zero beyond the grid take grid rows and columns, and the cells H
    away from the planes' edges are those of the whole grid's stage, bit
    for bit (the stage reads 3 cells around a cell at most).  cfg.ny,
    cfg.nx and 0, the defaults, are a whole plane."""
    at = (clamp_ny, row_offset, clamp_nx, col_offset)
    if u.device.type == "cpu":
        _build.PLAIN_CALLS["K7"] += 1
        uu, vv = extrapolate_zero(cfg, u, v, fluid, prev_fluid, solid, *at)
        ut, vt = advect_forces(cfg, uu, vv, fluid, solid, dt, *at)
        return (ut, vt, uu, vv) if extrapolated else (ut, vt)
    Y, X = cfg.ny, cfg.nx
    plane = (Y, X)
    f = torch.float32
    dev = u.device
    ptr = [_build.require(fluid, "fluid", torch.bool, plane),
           _build.require(prev_fluid, "prev_fluid", torch.bool, plane, dev),
           _build.require(solid, "solid", torch.bool, plane, dev),
           _build.require(u, "u", f, plane, dev),
           _build.require(v, "v", f, plane, dev),
           _build.require(dt, "dt", f, (), dev)]
    out = [torch.empty(plane, dtype=f, device=dev)
           for _ in range(4 if extrapolated else 2)]
    ptr += [t.data_ptr() for t in out] + [None] * (4 - len(out))
    plan = grid_tile_plan(Y, X)
    lib = grid_lib()
    _build.LAUNCHES["K7"] += 1
    rc = lib.eu_grid_passes(Y, X, Y if clamp_ny is None else clamp_ny,
                            row_offset, X if clamp_nx is None else clamp_nx,
                            col_offset, 1.0 / cfg.side_length, cfg.gravity,
                            *ptr,
                            plan.tile_y, plan.tile_x, plan.threads,
                            _build.stream())
    _build.check(lib, rc, "eu_grid_passes")
    return tuple(out)
