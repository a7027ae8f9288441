"""K1 and K4: the fused marker pass
(`euler_tpu/ops/pallas/marker_fused_kernel.py`), the tile plan that K1,
K4, K5 and K6 share, and the loader of their library.

`march_rebin` replaces the Pallas kernel `_fused_kernel` launched by
`march_rebin_pallas` (marker_fused_kernel.py:823-970), same contract:
slots [2K, Y, X] (px planes, then py planes), the live count per cell
(validity is k < count: slots are front-compacted), and a dead plane
(sink | solid) in; (slots', count', drop) out, where drop is the [Y, X]
plane of per-destination capacity drops.

On an H100 the pass is bound by bytes: it writes the whole new store (64
MB at 1024², K = 8) and reads the inputs and the live positions once.
The CUDA source (`csrc/marker_pass.cu` `march_rebin_tiles`) is one
launch of one CTA per tile of destination cells: it marches the live
markers of the tile and a one-cell halo into shared memory, then
re-bins from there as a per-destination gather in OFFSETS_OWN_FIRST
order, which needs no atomics and gives the plain version's slot
assignment exactly; it is built with -fmad=false so positions match the
plain version bit for bit.  `tile_plan` sizes the tiles for (Y, X, K)
and the kernel: K5 (`marker_kernel`) and K6 (`rebin_kernel`) run the
same tiled pass with a layout of their own.  With dt = 0 the pass is a
bitwise identity on the store.

`march_rebin_plain` is the plain version: `markers_slots.march_slots`
followed by `markers_slots.rebin_slots`.

K1 also runs on one block's plane (`parallel/cuda_shard.py`, the JAX
`march_rebin_pallas(..., clamp_ny=, row_offset=)`,
marker_fused_kernel.py:823-876, on rows; the port also splits columns):
cfg.ny and cfg.nx are then the block's rows and columns with their halo,
`clamp_ny` / `clamp_nx` the global row and column counts of the
interpolation clamps and `row_offset` / `col_offset` the global row and
column of plane cell (0, 0).  Their defaults (cfg.ny, 0, cfg.nx, 0) are
the whole plane's, the same launch as before they existed.

`march_rebin_padded` (K4) replaces the same Pallas kernel launched by
`march_rebin_padded` (marker_fused_kernel.py:973-1062): K1's function on
the persistent padded store [2K, Y+16, X+256] with the interior at
(8, 128), which `pad_slot_store` makes once a frame and
`unpad_slot_store` undoes.  The pads may hold anything: they are neither
read nor written.  Count, dead and the outputs count' and drop stay
unpadded [Y, X].  It launches K1's kernel with the store addressed
through a row pitch of X+256.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.markers_slots import (
    live_slots,
    march_slots,
    rebin_slots,
)

# the padded store's interior offset (rows, columns): the store is
# [2K, Y + 2 PAD_Y, X + 2 PAD_X]
PAD_Y, PAD_X = 8, 128

# The marker tiles are TILE_X cells wide (a warp's stores of one slot
# plane are one tile row).  K1 / K4: TILE_THREADS threads a CTA and the
# tallest of TILE_YS that leaves room for a second CTA on an H100 SM, else
# the tallest that fits alone.  K5 / K6: the (rows, threads) of
# UNFUSED_TILES that keeps the most threads resident on an SM, the first
# on a tie (smaller CTAs overlap more of each other's load latency).  The
# kernels ask for at most REGISTERS_MAX registers a thread; an SM holds
# SM_REGISTERS registers and SM_THREADS threads.  A CTA may use 227 KB of
# shared memory, an SM holds 228 KB and keeps 1 KB of it for each CTA.
TILE_X = 32
TILE_YS = (32, 16, 8)
TILE_THREADS = 512
UNFUSED_TILES = ((8, 256), (16, 512), (32, 512))
REGISTERS_MAX = 64
SM_REGISTERS = 65_536
SM_THREADS = 2_048
SMEM_BYTES_MAX = 232_448
SM_SMEM_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
# the kernels of the tiled pass (csrc/marker_pass.cu `Pass`): K1 and K4
# march and re-bin, K6 re-bins by the alive plane, K5 marches
TILE_KERNELS = ("K1", "K4", "K5", "K6")


class TilePlan(NamedTuple):
    """A marker kernel's launch (csrc/marker_pass.cu `TilePlan`) and the
    shared memory of one CTA."""
    tile_y: int
    tile_x: int
    tiles_y: int  # CTAs down the grid
    tiles_x: int  # CTAs across it
    threads: int
    smem_bytes: int


def tile_smem_bytes(tile_y: int, tile_x: int, K: int,
                    kernel: str = "K1") -> int:
    """The shared memory of one tile of `kernel` (csrc/marker_pass.cu
    `TileLayout`).  The re-bins (K1, K4, K6) read a one-cell halo, K5
    none: the tile's H = (tile_y + 2 halo)(tile_x + 2 halo) cells hold up
    to H K live markers, each a position (8 bytes) and, for the re-bins, a
    destination code (1); the prefix of the cells' live numbers (H + 1
    ints) and 32 warp sums; for the re-bins each destination cell's K
    picks (2 bytes each); for K6 each halo cell's alive mask (8 bytes)."""
    if kernel not in TILE_KERNELS:
        raise ValueError(f"no tiled marker kernel {kernel!r}")
    halo = 0 if kernel == "K5" else 1
    h = (tile_y + 2 * halo) * (tile_x + 2 * halo)
    nbytes = 8 * h * K + 4 * (h + 1) + 4 * 32
    if kernel != "K5":
        nbytes += h * K + 2 * tile_y * tile_x * K
    if kernel == "K6":
        nbytes += 8 * h
    return nbytes


def resident_ctas(tile_y: int, threads: int, K: int, kernel: str) -> int:
    """The CTAs of `kernel`'s tiles of tile_y x TILE_X cells and `threads`
    threads that an H100 SM holds at once (0: the tile does not fit a
    CTA: its shared memory, or a re-bin's 16-bit halo marker index, or
    K6's 64-bit alive mask)."""
    nbytes = tile_smem_bytes(tile_y, TILE_X, K, kernel)
    if (nbytes > SMEM_BYTES_MAX
            or (kernel != "K5" and (tile_y + 2) * (TILE_X + 2) * K > 2**16)
            or (kernel == "K6" and K > 64)):
        return 0
    return min(SM_SMEM_BYTES // (nbytes + CTA_RESERVED_BYTES),
               SM_REGISTERS // (threads * REGISTERS_MAX),
               SM_THREADS // threads)


def tile_plan(Y: int, X: int, K: int, kernel: str = "K1") -> TilePlan:
    """`kernel`'s launch over a [Y, X] grid with K slots a cell: tiles of
    tile_y x TILE_X cells (the ragged edge tiles are masked in the
    kernel), chosen as the comment above TILE_X says.  Raises when no
    tile fits a CTA."""
    if kernel in ("K5", "K6"):
        fits = [(resident_ctas(ty, n, K, kernel) * n, -i, ty, n)
                for i, (ty, n) in enumerate(UNFUSED_TILES)]
        resident, _, ty, threads = max(fits)
    else:
        resident, threads = 0, TILE_THREADS
        for ctas in (2, 1):
            ty = next((ty for ty in TILE_YS if resident_ctas(
                ty, threads, K, kernel) >= ctas), None)
            if ty is not None:
                resident = ctas
                break
    if not resident:
        ty = UNFUSED_TILES[0][0] if kernel in ("K5", "K6") else TILE_YS[-1]
        raise ValueError(
            f"{kernel} with slots_per_cell {K}: a tile of {ty} x {TILE_X} "
            f"cells needs {tile_smem_bytes(ty, TILE_X, K, kernel)} bytes "
            f"of shared memory, more than the {SMEM_BYTES_MAX} a block may "
            "use on an H100, or more halo markers than 16 bits index")
    return TilePlan(ty, TILE_X, -(-Y // ty), -(-X // TILE_X), threads,
                    tile_smem_bytes(ty, TILE_X, K, kernel))


def _block_at(cfg: SimConfig, clamp_ny, row_offset, clamp_nx, col_offset):
    """(clamp_ny, row_offset, clamp_nx, col_offset) checked: cfg.ny, 0,
    cfg.nx and 0 by default."""
    clamp_ny = cfg.ny if clamp_ny is None else int(clamp_ny)
    if clamp_ny < 2:
        raise ValueError(f"clamp_ny {clamp_ny}: the global grid needs two "
                         "rows at least")
    if clamp_nx is not None and int(clamp_nx) < 2:
        raise ValueError(f"clamp_nx {clamp_nx}: a grid split into column "
                         "blocks needs two columns at least")
    clamp_nx = cfg.nx if clamp_nx is None else int(clamp_nx)
    return clamp_ny, int(row_offset), clamp_nx, int(col_offset)


def march_rebin_plain(cfg: SimConfig, u, v, fluid, solid, slots, dt, count,
                      *, dead, clamp_ny=None, row_offset=0, clamp_nx=None,
                      col_offset=0):
    """March + re-bin as plain PyTorch ops."""
    at = _block_at(cfg, clamp_ny, row_offset, clamp_nx, col_offset)
    K = slots.shape[0] // 2
    valid = live_slots(count, K)
    px, py = march_slots(cfg, u, v, fluid, solid, slots[:K], slots[K:],
                         valid, dt, *at)
    opx, opy, ocount, drop = rebin_slots(cfg, px, py, valid, dead, at[1],
                                         at[3])
    return torch.cat([opx, opy]), ocount, drop


@functools.cache
def marker_lib():
    """csrc/marker_pass.cu: K1 (`eu_march_rebin`), K4
    (`eu_march_rebin_padded`), K5 (`eu_march`) and K6 (`eu_rebin`), built
    and bound once (binding costs the host ~10 µs a call)."""
    lib = _build.load("marker_pass", flags=["-fmad=false"])
    P, I, Fl = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_march_rebin", [I, I, I, I, Fl, Fl, I, I, I, I]
                + [P] * 11 + [I] * 5 + [P])
    _build.bind(lib, "eu_march_rebin_padded", [I, I, I, I, Fl, Fl]
                + [P] * 11 + [I] * 5 + [P])
    _build.bind(lib, "eu_march", [I, I, I, I, Fl, Fl] + [P] * 8 + [I] * 5
                + [P])
    _build.bind(lib, "eu_rebin", [I, I, I, Fl] + [P] * 7 + [I] * 5 + [P])
    return lib


def march_rebin(cfg: SimConfig, u, v, fluid, solid, slots, dt, count, *,
                dead, clamp_ny=None, row_offset=0, clamp_nx=None,
                col_offset=0):
    """Fused marker pass.  Returns (slots', count', drop).  CUDA tensors
    run the kernel; CPU tensors the plain version.  clamp_ny, row_offset,
    clamp_nx and col_offset place a block's plane in the global grid (see
    the top of this module)."""
    at = dict(clamp_ny=clamp_ny, row_offset=row_offset, clamp_nx=clamp_nx,
              col_offset=col_offset)
    if slots.device.type == "cpu":
        _build.PLAIN_CALLS["K1"] += 1
        return march_rebin_plain(cfg, u, v, fluid, solid, slots, dt, count,
                                 dead=dead, **at)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return _launch("K1", "eu_march_rebin", cfg, u, v, fluid, solid, slots,
                   (2 * K, Y, X), dt, count, dead, _block_at(cfg, **at))


def _launch(kernel, entry, cfg, u, v, fluid, solid, slots, store_shape, dt,
            count, dead, block_at=()):
    """K1's launch through `entry`, on a store of `store_shape`, counted
    as `kernel`'s; `block_at` is K1's (clamp_ny, row_offset, clamp_nx,
    col_offset), which K4's entry does not take."""
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    f = torch.float32
    dev = slots.device
    plane = (Y, X)
    p_slots = _build.require(slots, "slots", f, store_shape)
    p_u = _build.require(u, "u", f, plane, dev)
    p_v = _build.require(v, "v", f, plane, dev)
    p_count = _build.require(count, "count", torch.int32, plane, dev)
    p_fluid = _build.require(fluid, "fluid", torch.bool, plane, dev)
    p_solid = _build.require(solid, "solid", torch.bool, plane, dev)
    p_dead = _build.require(dead, "dead", torch.bool, plane, dev)
    p_dt = _build.require(dt, "dt", f, (), dev)

    plan = tile_plan(Y, X, K)
    out = torch.empty_like(slots)
    out_count = torch.empty(plane, dtype=torch.int32, device=dev)
    out_drop = torch.empty(plane, dtype=torch.int32, device=dev)
    h = np.float32(cfg.side_length)
    lib = marker_lib()
    _build.LAUNCHES[kernel] += 1
    rc = getattr(lib, entry)(
        Y, X, K, cfg.marker_march_iters, float(h),
        float(np.float32(1.0) / h), *block_at, p_u, p_v, p_count, p_fluid,
        p_solid, p_dead, p_slots, p_dt, out.data_ptr(), out_count.data_ptr(),
        out_drop.data_ptr(), plan.tile_y, plan.tile_x, plan.tiles_y,
        plan.tiles_x, plan.threads, _build.stream())
    _build.check(lib, rc, entry)
    return out, out_count, out_drop


def pad_slot_store(cfg: SimConfig, markers):
    """[2, K, Y, X] marker store -> the persistent padded store
    [2K, Y+16, X+256] with the interior at (8, 128) and zero pads."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return F.pad(markers.reshape(2 * K, Y, X), (PAD_X, PAD_X, PAD_Y, PAD_Y))


def unpad_slot_store(cfg: SimConfig, padded):
    """Inverse of `pad_slot_store`: the contiguous [2, K, Y, X] store."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return padded[:, PAD_Y:PAD_Y + Y, PAD_X:PAD_X + X].contiguous().reshape(
        2, K, Y, X)


def march_rebin_padded_plain(cfg: SimConfig, u, v, fluid, solid,
                             slots_padded, dt, count, *, dead):
    """K4 as plain PyTorch ops: unpad, `march_rebin_plain`, pad."""
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    slots = slots_padded[:, PAD_Y:PAD_Y + Y, PAD_X:PAD_X + X]
    out, ocount, drop = march_rebin_plain(cfg, u, v, fluid, solid, slots, dt,
                                          count, dead=dead)
    return F.pad(out, (PAD_X, PAD_X, PAD_Y, PAD_Y)), ocount, drop


def march_rebin_padded(cfg: SimConfig, u, v, fluid, solid, slots_padded, dt,
                       count, *, dead):
    """K4: the fused marker pass on the persistent padded store.  Returns
    (slots_padded', count', drop) with count' and drop unpadded; the
    kernel leaves the output's pads unwritten.  CUDA tensors run the
    kernel; CPU tensors the plain version."""
    if slots_padded.device.type == "cpu":
        _build.PLAIN_CALLS["K4"] += 1
        return march_rebin_padded_plain(cfg, u, v, fluid, solid,
                                        slots_padded, dt, count, dead=dead)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return _launch("K4", "eu_march_rebin_padded", cfg, u, v, fluid, solid,
                   slots_padded, (2 * K, Y + 2 * PAD_Y, X + 2 * PAD_X), dt,
                   count, dead)
