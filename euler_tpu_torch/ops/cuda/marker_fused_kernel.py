"""K1: the fused marker pass (`euler_tpu/ops/pallas/marker_fused_kernel.py`).

`march_rebin` replaces the Pallas kernel `_fused_kernel` launched by
`march_rebin_pallas` (marker_fused_kernel.py:823-970), same contract:
slots [2K, Y, X] (px planes, then py planes), the live count per cell
(validity is k < count: slots are front-compacted), and a dead plane
(sink | solid) in; (slots', count', drop) out, where drop is the [Y, X]
plane of per-destination capacity drops.

On an H100 the pass is bound by bytes: the 64 MB store at 1024², K = 8,
is read, marched into scratch, gathered back and written.  The CUDA
source (`csrc/marker_pass.cu`) marches one thread per live slot and
re-bins as a per-destination gather in OFFSETS_OWN_FIRST order, which
needs no atomics and gives the plain version's slot assignment exactly;
it is built with -fmad=false so positions match the plain version bit
for bit.  With dt = 0 the pass is a bitwise identity on the store.

`march_rebin_plain` is the plain version: `markers_slots.march_slots`
followed by `markers_slots.rebin_slots`.
"""

from __future__ import annotations

import numpy as np
import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.markers_slots import (
    live_slots,
    march_slots,
    rebin_slots,
)

def march_rebin_plain(cfg: SimConfig, u, v, fluid, solid, slots, dt, count,
                      *, dead):
    """March + re-bin as plain PyTorch ops."""
    K = slots.shape[0] // 2
    valid = live_slots(count, K)
    px, py = march_slots(cfg, u, v, fluid, solid, slots[:K], slots[K:],
                         valid, dt)
    opx, opy, ocount, drop = rebin_slots(cfg, px, py, valid, dead)
    return torch.cat([opx, opy]), ocount, drop


def _lib():
    lib = _build.load("marker_pass", flags=["-fmad=false"])
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_march_rebin",
                [I, I, I, I, F, F] + [P] * 13)
    return lib


def march_rebin(cfg: SimConfig, u, v, fluid, solid, slots, dt, count, *,
                dead):
    """Fused marker pass.  Returns (slots', count', drop).  CUDA tensors
    run the kernel; CPU tensors the plain version."""
    if slots.device.type == "cpu":
        _build.PLAIN_CALLS["K1"] += 1
        return march_rebin_plain(cfg, u, v, fluid, solid, slots, dt, count,
                                 dead=dead)
    Y, X, K = cfg.ny, cfg.nx, cfg.slots_per_cell
    f = torch.float32
    dev = slots.device
    plane = (Y, X)
    p_slots = _build.require(slots, "slots", f, (2 * K, Y, X))
    p_u = _build.require(u, "u", f, plane, dev)
    p_v = _build.require(v, "v", f, plane, dev)
    p_count = _build.require(count, "count", torch.int32, plane, dev)
    p_fluid = _build.require(fluid, "fluid", torch.bool, plane, dev)
    p_solid = _build.require(solid, "solid", torch.bool, plane, dev)
    p_dead = _build.require(dead, "dead", torch.bool, plane, dev)
    p_dt = _build.require(dt, "dt", f, (), dev)

    marched = torch.empty_like(slots)
    out = torch.empty_like(slots)
    out_count = torch.empty(plane, dtype=torch.int32, device=dev)
    out_drop = torch.empty(plane, dtype=torch.int32, device=dev)
    h = np.float32(cfg.side_length)
    lib = _lib()
    _build.LAUNCHES["K1"] += 1
    rc = lib.eu_march_rebin(
        Y, X, K, cfg.marker_march_iters, float(h),
        float(np.float32(1.0) / h), p_u, p_v, p_count, p_fluid, p_solid,
        p_dead, p_slots, p_dt, marched.data_ptr(), out.data_ptr(),
        out_count.data_ptr(), out_drop.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_march_rebin")
    return out, out_count, out_drop
