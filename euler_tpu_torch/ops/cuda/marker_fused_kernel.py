"""K1 and K4: the fused marker pass
(`euler_tpu/ops/pallas/marker_fused_kernel.py`), and the loader of the
marker library that K5 and K6 share.

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
plain version bit for bit.  `tile_plan` sizes the tiles for (Y, X, K).
With dt = 0 the pass is a bitwise identity on the store.

`march_rebin_plain` is the plain version: `markers_slots.march_slots`
followed by `markers_slots.rebin_slots`.

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

# K1 / K4 tiles: TILE_X cells wide (a warp's stores of one slot plane are
# one tile row), TILE_THREADS threads a CTA, and the tallest of TILE_YS
# that leaves room for a second CTA on an H100 SM (the kernel asks for two
# CTAs an SM at most 64 registers a thread), else the tallest that fits
# alone.  A CTA may use 227 KB of shared memory, an SM holds 228 KB and
# keeps 1 KB of it for each CTA.
TILE_X = 32
TILE_YS = (32, 16, 8)
TILE_THREADS = 512
SMEM_BYTES_MAX = 232_448
SM_SMEM_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024


class TilePlan(NamedTuple):
    """K1 / K4's launch (csrc/marker_pass.cu `TilePlan`) and the shared
    memory of one CTA."""
    tile_y: int
    tile_x: int
    tiles_y: int  # CTAs down the grid
    tiles_x: int  # CTAs across it
    threads: int
    smem_bytes: int


def tile_smem_bytes(tile_y: int, tile_x: int, K: int) -> int:
    """The shared memory of one tile (csrc/marker_pass.cu `TileLayout`):
    the halo's H = (tile_y + 2)(tile_x + 2) cells hold up to H K live
    markers, each a marched position (8 bytes) and a destination code (1);
    the prefix of the halo's counts (H + 1 ints) and 32 warp sums; each
    destination cell's K picks (2 bytes each)."""
    h = (tile_y + 2) * (tile_x + 2)
    return 9 * h * K + 4 * (h + 1) + 4 * 32 + 2 * tile_y * tile_x * K


def tile_plan(Y: int, X: int, K: int) -> TilePlan:
    """K1 / K4's launch over a [Y, X] grid with K slots a cell: tiles of
    tile_y x TILE_X cells (the ragged edge tiles are masked in the
    kernel).  Raises when no tile height of TILE_YS fits: the kernel
    addresses a halo marker in 16 bits and a CTA's shared memory is
    bounded."""
    def fits(ty, ctas):
        nbytes = tile_smem_bytes(ty, TILE_X, K)
        return (nbytes <= SMEM_BYTES_MAX
                and ctas * (nbytes + CTA_RESERVED_BYTES) <= SM_SMEM_BYTES
                and (ty + 2) * (TILE_X + 2) * K <= 2**16)

    for ctas in (2, 1):
        for ty in TILE_YS:
            if fits(ty, ctas):
                return TilePlan(ty, TILE_X, -(-Y // ty), -(-X // TILE_X),
                                TILE_THREADS, tile_smem_bytes(ty, TILE_X, K))
    raise ValueError(
        f"slots_per_cell {K}: a tile of {TILE_YS[-1]} x {TILE_X} cells "
        f"needs {tile_smem_bytes(TILE_YS[-1], TILE_X, K)} bytes of shared "
        f"memory, more than the {SMEM_BYTES_MAX} a block may use on an "
        "H100")


def march_rebin_plain(cfg: SimConfig, u, v, fluid, solid, slots, dt, count,
                      *, dead):
    """March + re-bin as plain PyTorch ops."""
    K = slots.shape[0] // 2
    valid = live_slots(count, K)
    px, py = march_slots(cfg, u, v, fluid, solid, slots[:K], slots[K:],
                         valid, dt)
    opx, opy, ocount, drop = rebin_slots(cfg, px, py, valid, dead)
    return torch.cat([opx, opy]), ocount, drop


@functools.cache
def marker_lib():
    """csrc/marker_pass.cu: K1 (`eu_march_rebin`), K4
    (`eu_march_rebin_padded`), K5 (`eu_march`) and K6 (`eu_rebin`), built
    and bound once (binding costs the host ~10 µs a call)."""
    lib = _build.load("marker_pass", flags=["-fmad=false"])
    P, I, Fl = _build.PTR, _build.INT, _build.FLOAT
    for name in ("eu_march_rebin", "eu_march_rebin_padded"):
        _build.bind(lib, name, [I, I, I, I, Fl, Fl] + [P] * 11 + [I] * 5
                    + [P])
    _build.bind(lib, "eu_march", [I, I, I, I, Fl, Fl] + [P] * 11)
    _build.bind(lib, "eu_rebin", [I, I, I, Fl] + [P] * 10)
    return lib


def march_rebin(cfg: SimConfig, u, v, fluid, solid, slots, dt, count, *,
                dead):
    """Fused marker pass.  Returns (slots', count', drop).  CUDA tensors
    run the kernel; CPU tensors the plain version."""
    if slots.device.type == "cpu":
        _build.PLAIN_CALLS["K1"] += 1
        return march_rebin_plain(cfg, u, v, fluid, solid, slots, dt, count,
                                 dead=dead)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    return _launch("K1", "eu_march_rebin", cfg, u, v, fluid, solid, slots,
                   (2 * K, Y, X), dt, count, dead)


def _launch(kernel, entry, cfg, u, v, fluid, solid, slots, store_shape, dt,
            count, dead):
    """K1's launch through `entry`, on a store of `store_shape`, counted
    as `kernel`'s."""
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
        float(np.float32(1.0) / h), p_u, p_v, p_count, p_fluid, p_solid,
        p_dead, p_slots, p_dt, out.data_ptr(), out_count.data_ptr(),
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
