"""K5: the marker march alone (`euler_tpu/ops/pallas/marker_kernel.py`).

`advect_markers` replaces the Pallas kernel `_march_kernel` launched by
`advect_markers_pallas` (marker_kernel.py:286-352), the march of the
unfused marker pass (`fuse_marker_pass=False`): velocity interpolation,
the DDA collision march (main.c:464-537) and the advance.  The [2, K, Y,
X] marker store and the live count per cell in; a new store out.  Slot k
of a cell is marched when k < count; every other slot keeps its input
position, as `markers_slots.advect_markers_slots` keeps it (the Pallas
kernel copies slots >= its tile's largest count through).

On an H100 the march is bound by bytes: it reads and writes the whole
store (64 MB each way at 1024², K = 8).  The CUDA source
(`csrc/marker_pass.cu` `march_tiles`) is K1's tiled pass without a halo:
one CTA per tile takes the block prefix of its cells' counts, marches
one thread per live marker (none for a dead slot) through K1's
`march_marker` into shared memory, and writes the store plane by plane,
the dead slots copied through.  Built with -fmad=false, so positions
match the plain version bit for bit.  With dt = 0 it is a bitwise
identity.

`advect_markers_plain` is the plain version: `markers_slots.march_slots`
on `live_slots(count)`.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.marker_fused_kernel import marker_lib, tile_plan
from euler_tpu_torch.ops.markers_slots import live_slots, march_slots


def advect_markers_plain(cfg: SimConfig, u, v, fluid, solid, markers, dt,
                         count):
    """The march as plain PyTorch ops."""
    return torch.stack(march_slots(cfg, u, v, fluid, solid, markers[0],
                                   markers[1],
                                   live_slots(count, markers.shape[1]), dt))


def advect_markers(cfg: SimConfig, u, v, fluid, solid, markers, dt, count):
    """The marker march.  Returns the new [2, K, Y, X] store.  CUDA tensors
    run the kernel; CPU tensors the plain version."""
    if markers.device.type == "cpu":
        _build.PLAIN_CALLS["K5"] += 1
        return advect_markers_plain(cfg, u, v, fluid, solid, markers, dt,
                                    count)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    f = torch.float32
    dev = markers.device
    plane = (Y, X)
    p_markers = _build.require(markers, "markers", f, (2, K, Y, X), dev)
    p_u = _build.require(u, "u", f, plane, dev)
    p_v = _build.require(v, "v", f, plane, dev)
    p_count = _build.require(count, "count", torch.int32, plane, dev)
    p_fluid = _build.require(fluid, "fluid", torch.bool, plane, dev)
    p_solid = _build.require(solid, "solid", torch.bool, plane, dev)
    p_dt = _build.require(dt, "dt", f, (), dev)

    plan = tile_plan(Y, X, K, "K5")
    out = torch.empty_like(markers)
    h = np.float32(cfg.side_length)
    lib = marker_lib()
    _build.LAUNCHES["K5"] += 1
    rc = lib.eu_march(
        Y, X, K, cfg.marker_march_iters, float(h),
        float(np.float32(1.0) / h), p_u, p_v, p_count, p_fluid, p_solid,
        p_markers, p_dt, out.data_ptr(), plan.tile_y, plan.tile_x,
        plan.tiles_y, plan.tiles_x, plan.threads, _build.stream())
    _build.check(lib, rc, "eu_march")
    return out
