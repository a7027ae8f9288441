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
middle is K3's MG-PCG (`csrc/mg_pcg.cu`), bound by launches.  The design
keeps the two grid-stage passes the Pallas kernel has (the advection
reads the extrapolated planes' 3x3 neighbourhood) and fuses the rest per
launch; see the source.  K10 is bound as K9 is (`pcg_kernel.py`): its
grid stage is two of K2's passes (`csrc/grid_stage.cuh`), then about
100 Jacobi iterations of 14 plane passes each (`csrc/jacobi_pcg.cu`).

`project_substep_mg_plain` is K2's plain version, the op sequence of
tests/test_substep_fused.py:31-68 with the plain MG-PCG;
`project_substep_jacobi_plain` is `grid_stage_plain` followed by K9's
plain version.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.advect import advect_u, advect_v
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.mg_kernel import (
    mg_fits,
    mg_host_operands,
    mg_pcg_cuda,
    solve_pressure_mg_plain,
)
from euler_tpu_torch.ops.cuda.pcg_kernel import (
    Workspace,
    jacobi_lib,
    project_jacobi_plain,
    solver_args,
)
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.forces import (
    apply_body_forces,
    max_speed_sq,
    zero_bounds,
)
from euler_tpu_torch.ops.project import (
    clamp_pressure,
    divergence_rhs,
    face_update,
    pressure_matrix_diag,
)

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


def _lib():
    lib = _build.load("grid_stage", flags=["-fmad=false"])
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_grid_stage",
                [I, I, F, F, F] + [P] * 15)
    _build.bind(lib, "eu_project_tail",
                [I, I, F] + [P] * 9)
    return lib


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
            "that halve evenly to mg_min_size (ROADMAP queue 1 item M11)")
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

    a_diag = pressure_matrix_diag(cfg, solid, fluid)
    operands = mg_host_operands(cfg, a_diag, fluid)

    zu, zv, ut, vt, r, p = (torch.empty(plane, dtype=f, device=dev)
                            for _ in range(6))
    part = torch.empty(2 * (-(-Y * X // 256)), dtype=f, device=dev)
    msq = torch.empty((), dtype=f, device=dev)
    h = cfg.side_length
    lib = _lib()
    _build.LAUNCHES["K2"] += 1
    rc = lib.eu_grid_stage(
        Y, X, 1.0 / h, cfg.gravity, h * h * cfg.density,
        ptr["fl"], ptr["pfl"], ptr["so"], ptr["u"], ptr["v"], ptr["dt"],
        ptr["dtp"], p0_ptr, zu.data_ptr(), zv.data_ptr(), ut.data_ptr(),
        vt.data_ptr(), r.data_ptr(), p.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_grid_stage")

    iters, resid = mg_pcg_cuda(cfg, operands, r, p, warm)

    rc = lib.eu_project_tail(
        Y, X, -1.0 / (cfg.density * h), ptr["fl"], ptr["so"], ptr["dt"],
        p.data_ptr(), ut.data_ptr(), vt.data_ptr(), part.data_ptr(),
        msq.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_project_tail")
    return ut, vt, iters, resid, msq, p


def project_substep_jacobi(cfg: SimConfig, dt, dt_proj, u, v, fluid,
                           prev_fluid, solid):
    """Grid stage + Jacobi-PCG projection of one substep.  Returns (u2,
    v2, iterations, residual, msq).  CUDA tensors run the kernels; CPU
    tensors the plain version."""
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
    zu, zv, u2, v2 = (torch.empty(plane, dtype=f, device=dev)
                      for _ in range(4))
    msq = torch.empty((), dtype=f, device=dev)
    ws = Workspace(*plane, dev)
    h = cfg.side_length
    lib = jacobi_lib()
    _build.LAUNCHES["K10"] += 1
    rc = lib.eu_jacobi_substep(
        *solver_args(cfg), 1.0 / h, cfg.gravity, h * h * cfg.density,
        -1.0 / (cfg.density * h), *ptr, zu.data_ptr(), zv.data_ptr(),
        u2.data_ptr(), v2.data_ptr(), *ws.pointers(), msq.data_ptr(),
        _build.stream())
    _build.check(lib, rc, "eu_jacobi_substep")
    return (u2, v2, *ws.result(), msq)
