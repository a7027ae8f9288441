"""K5: the marker march alone (`euler_tpu/ops/pallas/marker_kernel.py`).

`advect_markers` replaces the Pallas kernel `_march_kernel` launched by
`advect_markers_pallas` (marker_kernel.py:286-352), the march of the
unfused marker pass (`fuse_marker_pass=False`): velocity interpolation,
the DDA collision march (main.c:464-537) and the advance.  px, py
[K, Y, X] and the live count per cell in; (px', py') out.  Slot k of a
cell is marched when k < count; every other slot keeps its input
position, as `markers_slots.advect_markers_slots` keeps it (the Pallas
kernel copies slots >= its tile's largest count through), so the output
is a whole new store.

On an H100 the march is bound by bytes: it reads and writes the whole
store (64 MB each way at 1024², K = 8).  The CUDA source
(`csrc/marker_pass.cu` `march_kernel`) runs one thread per slot, marches
a live slot through K1's `march_marker` and copies a dead one; it is
built with -fmad=false, so positions match the plain version bit for
bit.  With dt = 0 it is a bitwise identity.

`advect_markers_plain` is the plain version: `markers_slots.march_slots`
on `live_slots(count)`.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.marker_fused_kernel import marker_lib
from euler_tpu_torch.ops.markers_slots import live_slots, march_slots


def advect_markers_plain(cfg: SimConfig, u, v, fluid, solid, px, py, dt,
                         count):
    """The march as plain PyTorch ops."""
    return march_slots(cfg, u, v, fluid, solid, px, py,
                       live_slots(count, px.shape[0]), dt)


def advect_markers(cfg: SimConfig, u, v, fluid, solid, px, py, dt, count):
    """The marker march.  Returns (px', py') [K, Y, X].  CUDA tensors run
    the kernel; CPU tensors the plain version."""
    if px.device.type == "cpu":
        _build.PLAIN_CALLS["K5"] += 1
        return advect_markers_plain(cfg, u, v, fluid, solid, px, py, dt,
                                    count)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    f = torch.float32
    dev = px.device
    plane = (Y, X)
    store = (K, Y, X)
    p_px = _build.require(px, "px", f, store, dev)
    p_py = _build.require(py, "py", f, store, dev)
    p_u = _build.require(u, "u", f, plane, dev)
    p_v = _build.require(v, "v", f, plane, dev)
    p_count = _build.require(count, "count", torch.int32, plane, dev)
    p_fluid = _build.require(fluid, "fluid", torch.bool, plane, dev)
    p_solid = _build.require(solid, "solid", torch.bool, plane, dev)
    p_dt = _build.require(dt, "dt", f, (), dev)

    out = torch.empty((2, K, Y, X), dtype=f, device=dev)
    h = np.float32(cfg.side_length)
    lib = marker_lib()
    _build.LAUNCHES["K5"] += 1
    rc = lib.eu_march(
        Y, X, K, cfg.marker_march_iters, float(h),
        float(np.float32(1.0) / h), p_u, p_v, p_count, p_fluid, p_solid,
        p_px, p_py, p_dt, out[0].data_ptr(), out[1].data_ptr(),
        _build.stream())
    _build.check(lib, rc, "eu_march")
    return out[0], out[1]
