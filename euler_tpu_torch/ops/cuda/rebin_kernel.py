"""K6: the marker re-bin alone (`euler_tpu/ops/pallas/rebin_kernel.py`).

`rebin_markers` replaces the Pallas kernel `_rebin_kernel` launched by
`rebin_markers_pallas` (rebin_kernel.py:144-191), the re-bin of the
unfused marker pass (`fuse_marker_pass=False`, main.c:102-117): the
marched [2, K, Y, X] store, its alive plane and the dead plane (sink |
solid) in; (store', alive', count, drop) out.  A source slot takes part
where the alive plane says so (every k < K is tested, not k < count:
the plane may have holes); arrivals are inserted in OFFSETS_OWN_FIRST
order, arrivals in dead cells are deleted, and those beyond K slots are
dropped and counted in the [Y, X] plane `drop`.  Slots at and beyond a
cell's new count are zero, and alive'[d] = d < count.

The Pallas kernel takes and gives the alive plane as f32 0/1; here it is
a bool [K, Y, X] tensor both ways (the state's own `alive`), which is
the same contract: `valid_f != 0` in, `alive' == (valid_f' != 0)` out.

On an H100 the re-bin is bound by bytes: the alive plane and the live
positions read once, the new store and alive plane written once.  The
CUDA source (`csrc/marker_pass.cu` `rebin_tiles`) is K1's tiled pass
without the march: one CTA per tile with a one-cell halo makes each
halo cell's alive mask, takes the block prefix of their popcounts, loads
each live marker's position and destination code once into shared
memory, and gathers in K1's order; it needs no atomics and gives the
plain version's slot assignment exactly.

`rebin_markers_plain` is the plain version: `markers_slots.rebin_slots`.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.marker_fused_kernel import marker_lib, tile_plan
from euler_tpu_torch.ops.markers_slots import live_slots, rebin_slots


def rebin_markers_plain(cfg: SimConfig, markers, alive, dead):
    """The re-bin as plain PyTorch ops."""
    opx, opy, count, drop = rebin_slots(cfg, markers[0], markers[1], alive,
                                        dead)
    return (torch.stack([opx, opy]), live_slots(count, markers.shape[1]),
            count, drop)


def rebin_markers(cfg: SimConfig, markers, alive, dead):
    """The marker re-bin.  Returns (store', alive', count, drop), the store
    [2, K, Y, X].  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if markers.device.type == "cpu":
        _build.PLAIN_CALLS["K6"] += 1
        return rebin_markers_plain(cfg, markers, alive, dead)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    dev = markers.device
    plane = (Y, X)
    p_markers = _build.require(markers, "markers", torch.float32,
                               (2, K, Y, X), dev)
    p_alive = _build.require(alive, "alive", torch.bool, (K, Y, X), dev)
    p_dead = _build.require(dead, "dead", torch.bool, plane, dev)

    plan = tile_plan(Y, X, K, "K6")
    out = torch.empty_like(markers)
    out_alive = torch.empty((K, Y, X), dtype=torch.bool, device=dev)
    out_count = torch.empty(plane, dtype=torch.int32, device=dev)
    out_drop = torch.empty(plane, dtype=torch.int32, device=dev)
    inv_h = np.float32(1.0) / np.float32(cfg.side_length)
    lib = marker_lib()
    _build.LAUNCHES["K6"] += 1
    rc = lib.eu_rebin(
        Y, X, K, float(inv_h), p_markers, p_alive, p_dead, out.data_ptr(),
        out_alive.data_ptr(), out_count.data_ptr(), out_drop.data_ptr(),
        plan.tile_y, plan.tile_x, plan.tiles_y, plan.tiles_x, plan.threads,
        _build.stream())
    _build.check(lib, rc, "eu_rebin")
    return out, out_alive, out_count, out_drop
