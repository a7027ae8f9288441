"""K2 and K10: the grid half of a substep
(`euler_tpu/ops/pallas/substep_kernel.py`).

`project_substep_mg` (K2) replaces the Pallas kernel `_substep_kernel`
launched by `project_substep_mg` (substep_kernel.py:325-384), same
contract: (u2, v2, iterations, residual, msq, p).  dt drives the grid
stage and the face update, dt_proj the RHS scale (+inf on inactive
substeps, so the RHS is exactly zero and the solve exits with 0
iterations); p is the clamped pressure, the next substep's warm start.
`project_substep_jacobi` (K10) replaces `_substep_jacobi_kernel`
launched by `project_substep_jacobi` (substep_kernel.py:403-459): the
same grid stage in front of K9's Jacobi projection, returning (u2, v2,
iterations, residual, msq) and no pressure.

On an H100 the head and tail (`csrc/grid_stage.cu`) are bound by bytes:
one-thread-per-cell stencils over a few 4 MB planes at 1024².  The
middle is K3's MG-PCG (`csrc/mg_pcg.cu`) on K3's cached workspace
(`mg_kernel.workspace`), bound by launches and barriers.  The grid stage
is K7's tiled launch (`csrc/grid_stage.cuh` `grid_passes`, on
`grid_kernel.grid_tile_plan`'s tiles, the extrapolated velocities in
shared memory only); the head writes the RHS, the warm-start guess and
the packed matrix straight into the workspace, the solve builds the
hierarchy there, and the tail clamps the workspace's pressure into a
fresh plane; see the source.  K10 is bound as K9 is (`pcg_kernel.py`):
its grid stage is the same launch, then about 100 Jacobi iterations of
9.5 plane passes each (`csrc/jacobi_pcg.cu`), on K9's cached workspace
(`pcg_kernel.workspace`).

`project_substep_mg_plain` is K2's plain version, the op sequence of
tests/test_substep_fused.py:31-68 with the plain MG-PCG;
`project_substep_jacobi_plain` is `grid_stage_plain` (`grid_kernel.py`)
followed by K9's plain version.

`substep_fused_fits` and `substep_jacobi_fused_fits` are the JAX
package's gates for these routes (substep_kernel.py:387, :462), kept as
integer arithmetic: see `pcg_kernel._VMEM_BUDGET`.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.grid_kernel import (
    grid_lib,
    grid_stage_plain,
    grid_tile_plan,
)
from euler_tpu_torch.ops.cuda.mg_kernel import (
    mg_fits,
    mg_pallas_fits,
    solve_pressure_mg_plain,
    workspace,
)
from euler_tpu_torch.ops.cuda import pcg_kernel
from euler_tpu_torch.ops.cuda.pcg_kernel import (
    _VMEM_BUDGET,
    project_jacobi_plain,
    solver_args,
)
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.project import (
    clamp_pressure,
    divergence_rhs,
    face_update,
    pressure_matrix_diag,
)


def substep_fused_fits(cfg: SimConfig) -> bool:
    """The MG solve fits (`mg_pallas_fits`) and 18 fine planes fit the
    budget: true through ~1277²."""
    return (mg_pallas_fits(cfg)
            and int(cfg.ny * cfg.nx * 4 * 18.0) <= _VMEM_BUDGET)


def substep_jacobi_fused_fits(cfg: SimConfig) -> bool:
    """Jacobi, f32, and 13 fine planes fit the budget: through ~1502²."""
    return (cfg.solver.preconditioner == "jacobi"
            and cfg.solver.dtype == "float32"
            and int(cfg.ny * cfg.nx * 4 * 13.0) <= _VMEM_BUDGET)


def project_substep_mg_plain(cfg: SimConfig, dt, dt_proj, u, v, fluid,
                             prev_fluid, solid, p0=None):
    """The substep's grid half as plain PyTorch ops."""
    ut, vt = grid_stage_plain(cfg, dt, u, v, fluid, prev_fluid, solid)
    b = divergence_rhs(cfg, ut, vt, fluid, dt_proj)
    a_diag = pressure_matrix_diag(cfg, solid, fluid)
    x0 = p0 if cfg.solver.warm_start else None
    p, iters, resid = solve_pressure_mg_plain(cfg, b, a_diag, fluid, x0)
    p = clamp_pressure(p, fluid)
    u2, v2 = face_update(cfg, p, ut, vt, fluid, solid, dt)
    return u2, v2, iters, resid, max_speed_sq(cfg, u2, v2), p


def project_substep_jacobi_plain(cfg: SimConfig, dt, dt_proj, u, v, fluid,
                                 prev_fluid, solid):
    """K10 as plain PyTorch ops: the grid stage, then K9's plain sequence
    with dt_proj for the RHS and dt for the face update."""
    ut, vt = grid_stage_plain(cfg, dt, u, v, fluid, prev_fluid, solid)
    return project_jacobi_plain(cfg, dt, ut, vt, fluid, solid, dt_proj)


def project_substep_mg(cfg: SimConfig, dt, dt_proj, u, v, fluid,
                       prev_fluid, solid, p0=None):
    """Grid stage + MG-PCG projection of one substep.  Returns
    (u2, v2, iterations, residual, msq, p).  CUDA tensors run the
    kernels; CPU tensors the plain version."""
    if u.device.type == "cpu":
        _build.PLAIN_CALLS["K2"] += 1
        return project_substep_mg_plain(cfg, dt, dt_proj, u, v, fluid,
                                        prev_fluid, solid, p0)
    if not mg_fits(cfg):
        raise NotImplementedError(
            "the CUDA substep needs f32 galerkin + cheby and level sizes "
            "that halve evenly to mg_min_size (`sim.substep` takes the "
            "unfused grid stage and P3 where they do not)")
    Y, X = cfg.ny, cfg.nx
    f = torch.float32
    dev = u.device
    plane = (Y, X)
    ptr = {
        "u": _build.require(u, "u", f, plane),
        "v": _build.require(v, "v", f, plane, dev),
        "fl": _build.require(fluid, "fluid", torch.bool, plane, dev),
        "pfl": _build.require(prev_fluid, "prev_fluid", torch.bool, plane,
                              dev),
        "so": _build.require(solid, "solid", torch.bool, plane, dev),
        "dt": _build.require(dt, "dt", f, (), dev),
        "dtp": _build.require(dt_proj, "dt_proj", f, (), dev),
    }
    warm = bool(cfg.solver.warm_start) and p0 is not None
    p0_ptr = _build.require(p0, "p0", f, plane, dev) if warm else None

    ws = workspace(cfg, dev)
    ut, vt, p = (torch.empty(plane, dtype=f, device=dev) for _ in range(3))
    msq = torch.empty((), dtype=f, device=dev)
    h = cfg.side_length
    plan = grid_tile_plan(Y, X)
    lib = grid_lib()
    _build.LAUNCHES["K2"] += 1
    rc = lib.eu_grid_stage(
        Y, X, 1.0 / h, cfg.gravity, h * h * cfg.density,
        ptr["fl"], ptr["pfl"], ptr["so"], ptr["u"], ptr["v"], ptr["dt"],
        ptr["dtp"], p0_ptr, ut.data_ptr(), vt.data_ptr(), ws.r.data_ptr(),
        ws.p.data_ptr(), ws.packed0.data_ptr(), plan.tile_y, plan.tile_x,
        plan.threads, _build.stream())
    _build.check(lib, rc, "eu_grid_stage")

    iters, resid = ws.solve(warm)

    rc = lib.eu_project_tail(
        Y, X, -1.0 / (cfg.density * h), ptr["fl"], ptr["so"], ptr["dt"],
        ws.p.data_ptr(), p.data_ptr(), ut.data_ptr(), vt.data_ptr(),
        ws.tail_part.data_ptr(), msq.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_project_tail")
    return ut, vt, iters, resid, msq, p


def project_substep_jacobi(cfg: SimConfig, dt, dt_proj, u, v, fluid,
                           prev_fluid, solid):
    """Grid stage + Jacobi-PCG projection of one substep.  Returns (u2,
    v2, iterations, residual, msq).  CUDA tensors run the kernels on K9's
    cached workspace; CPU tensors the plain version."""
    if u.device.type == "cpu":
        _build.PLAIN_CALLS["K10"] += 1
        return project_substep_jacobi_plain(cfg, dt, dt_proj, u, v, fluid,
                                            prev_fluid, solid)
    plane = (cfg.ny, cfg.nx)
    f = torch.float32
    dev = u.device
    ptr = [_build.require(fluid, "fluid", torch.bool, plane),
           _build.require(prev_fluid, "prev_fluid", torch.bool, plane, dev),
           _build.require(solid, "solid", torch.bool, plane, dev),
           _build.require(dt, "dt", f, (), dev),
           _build.require(dt_proj, "dt_proj", f, (), dev),
           _build.require(u, "u", f, plane, dev),
           _build.require(v, "v", f, plane, dev)]
    ws = pcg_kernel.workspace(cfg, dev)
    u2, v2 = ws.plane(), ws.plane()
    msq = ws.scal.new_empty(())
    h = cfg.side_length
    plan = grid_tile_plan(cfg.ny, cfg.nx)
    _build.LAUNCHES["K10"] += 1
    rc = ws.lib.eu_jacobi_substep(
        ws.handle, *solver_args(cfg), 1.0 / h, cfg.gravity,
        h * h * cfg.density, -1.0 / (cfg.density * h), *ptr, u2.data_ptr(),
        v2.data_ptr(), msq.data_ptr(), plan.tile_y, plan.tile_x,
        plan.threads, _build.stream())
    _build.check(ws.lib, rc, "eu_jacobi_substep")
    return (u2, v2, *ws.result(), msq)
