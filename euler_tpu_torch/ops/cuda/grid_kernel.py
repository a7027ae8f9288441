"""K7: the grid stage of a substep (`euler_tpu/ops/pallas/grid_kernel.py`).

`grid_stage` replaces the Pallas kernel `_grid_kernel` launched by
`grid_stage_pallas` (grid_kernel.py:172-221), same contract: extrapolate
-> zero_bounds -> advect -> gravity -> zero_bounds (main.c:865-889) of
(u, v), returning (ut, vt).  The substep takes it on the unfused mono
route when `use_pallas_grid` is set, as the JAX package does.

On an H100 it is bound by bytes: u and v in, three u8 masks, ut and vt
out, 19 bytes a cell (20 MB at 1024²).  It is passes A and B of
`csrc/grid_stage.cuh` (K2's grid stage; the advection reads the
extrapolated planes' 3x3 neighbourhood, so pass A materialises them),
launched alone from `csrc/grid_stage.cu`.

`grid_stage_plain` is the plain version, the op sequence of
tests/test_pallas_grid.py:27-36; its two halves `extrapolate_zero` and
`advect_forces` are also the unfused routes' grid stage where K7 is not
taken (rainbow advects its colours with the extrapolated velocities).
`grid_lib` builds and binds `csrc/grid_stage.cu`, which K2 also uses.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.advect import advect_u, advect_v
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.forces import apply_body_forces, zero_bounds


def extrapolate_zero(cfg: SimConfig, u, v, fluid, prev_fluid, solid):
    """extrapolate -> zero_bounds (main.c:865-870): the velocities the
    advection reads (the colours' advection too)."""
    uu = extrapolate(cfg, u, fluid, prev_fluid, "u")
    vv = extrapolate(cfg, v, fluid, prev_fluid, "v")
    return (zero_bounds(cfg, uu, fluid, solid, "u"),
            zero_bounds(cfg, vv, fluid, solid, "v"))


def advect_forces(cfg: SimConfig, uu, vv, fluid, solid, dt):
    """advect -> gravity -> zero_bounds (main.c:871-889)."""
    ut = advect_u(cfg, uu, vv, fluid, dt)
    vt = advect_v(cfg, uu, vv, fluid, dt)
    vt = apply_body_forces(cfg, vt, dt)
    return (zero_bounds(cfg, ut, fluid, solid, "u"),
            zero_bounds(cfg, vt, fluid, solid, "v"))


def grid_stage_plain(cfg: SimConfig, dt, u, v, fluid, prev_fluid, solid):
    """extrapolate -> zero_bounds -> advect -> gravity -> zero_bounds
    (main.c:865-889): the velocities the projection starts from."""
    uu, vv = extrapolate_zero(cfg, u, v, fluid, prev_fluid, solid)
    return advect_forces(cfg, uu, vv, fluid, solid, dt)


def grid_lib():
    lib = _build.load("grid_stage", flags=["-fmad=false"])
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_grid_passes", [I, I, F, F] + [P] * 11)
    _build.bind(lib, "eu_grid_stage", [I, I, F, F, F] + [P] * 16)
    _build.bind(lib, "eu_project_tail", [I, I, F] + [P] * 10)
    return lib


def grid_stage(cfg: SimConfig, u, v, fluid, prev_fluid, solid, dt):
    """The grid stage of one substep.  Returns (ut, vt).  CUDA tensors run
    the kernel; CPU tensors the plain version."""
    if u.device.type == "cpu":
        _build.PLAIN_CALLS["K7"] += 1
        return grid_stage_plain(cfg, dt, u, v, fluid, prev_fluid, solid)
    plane = (cfg.ny, cfg.nx)
    f = torch.float32
    dev = u.device
    ptr = [_build.require(fluid, "fluid", torch.bool, plane),
           _build.require(prev_fluid, "prev_fluid", torch.bool, plane, dev),
           _build.require(solid, "solid", torch.bool, plane, dev),
           _build.require(u, "u", f, plane, dev),
           _build.require(v, "v", f, plane, dev),
           _build.require(dt, "dt", f, (), dev)]
    zu, zv, ut, vt = (torch.empty(plane, dtype=f, device=dev)
                      for _ in range(4))
    lib = grid_lib()
    _build.LAUNCHES["K7"] += 1
    rc = lib.eu_grid_passes(
        cfg.ny, cfg.nx, 1.0 / cfg.side_length, cfg.gravity, *ptr,
        zu.data_ptr(), zv.data_ptr(), ut.data_ptr(), vt.data_ptr(),
        _build.stream())
    _build.check(lib, rc, "eu_grid_passes")
    return ut, vt
