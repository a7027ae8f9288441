"""K8 and K9: the one-launch Jacobi-PCG solve and projection
(`euler_tpu/ops/pallas/pcg_kernel.py`).

`solve_pressure_jacobi` (K8) replaces the Pallas kernel `_pcg_kernel`
launched by `solve_pressure_pallas` (pcg_kernel.py:163-204), same
contract: (p, iterations, residual) for A p = b from p = 0 (it takes no
warm start, as the Pallas kernel takes none).  `project_jacobi` (K9)
replaces `_project_kernel` launched by `project_pallas`
(pcg_kernel.py:402-443): the packed matrix and the divergence RHS, the
same solve, the pressure clamp, the face update and the CFL maxsq,
returning (u2, v2, iterations, residual, msq).

On an H100 an iteration is bound by bytes: three sweeps that move 14
[Y, X] f32 planes (59 MB at 1024², 17.5 us at 3.35 TB/s; the five live
planes fit the 50 MB L2, so that is an upper bound on the floor), and
two grid-wide reductions, each a launch boundary.  The design
(`csrc/jacobi_pcg.cu`) runs one thread per cell in five launches per
iteration with deterministic two-stage reductions, keeps the stop flag
and the iteration count on the device, and reads the flag on the host
once every 8 iterations.

The plain versions: `solve_pressure_jacobi_plain` is `pcg_loop` with the
Jacobi preconditioner and `apply_a`, and `project_jacobi_plain` is the
K9 sequence of plain ops plus `max_speed_sq`.

`pallas_solver_fits` and `fused_projection_fits` are the JAX package's
gates for K8 and K9 (pcg_kernel.py:207, :446).
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.project import (
    apply_a,
    clamp_pressure,
    divergence_rhs,
    face_update,
    jacobi_preconditioner,
    pcg_loop,
    pressure_matrix_diag,
)

# The JAX package's VMEM budget (pcg_kernel.py:43) and the route gates
# built on it are the TPU's: the H100 has no such ceiling.  The port keeps
# them, as plain integer arithmetic, only so that a configuration takes
# the route the JAX package takes and so computes the same function.
_VMEM_BUDGET = 112 * 1024 * 1024

_S_N = 5       # scal floats of one solve (csrc/jacobi_pcg.cu)
_S_RESID = 4   # scal index of the final max|r|
_F_N = 2       # flags ints
_F_ITERS = 1   # flags index of the iteration count


def pallas_solver_fits(cfg: SimConfig) -> bool:
    """Jacobi, f32, and 6.5 fine planes fit the budget: through 2125²."""
    return (cfg.solver.preconditioner == "jacobi"
            and cfg.solver.dtype == "float32"
            and int(cfg.ny * cfg.nx * 4 * 6.5) <= _VMEM_BUDGET)


def fused_projection_fits(cfg: SimConfig) -> bool:
    """Jacobi, f32, and 9.5 fine planes fit the budget: through 1758²."""
    return (cfg.solver.preconditioner == "jacobi"
            and cfg.solver.dtype == "float32"
            and int(cfg.ny * cfg.nx * 4 * 9.5) <= _VMEM_BUDGET)


def solve_pressure_jacobi_plain(cfg: SimConfig, b, a_diag, fluid):
    """Plain Jacobi-PCG from p = 0."""
    return pcg_loop(cfg, b, lambda s: apply_a(a_diag, fluid, s),
                    jacobi_preconditioner(a_diag, fluid))


def project_jacobi_plain(cfg: SimConfig, dt, ut, vt, fluid, solid,
                         dt_proj=None):
    """The K9 sequence as plain PyTorch ops: RHS, plain Jacobi-PCG, clamp,
    face update, maxsq.  `dt_proj` (default `dt`) scales the RHS, `dt`
    the face update."""
    if dt_proj is None:
        dt_proj = dt
    b = divergence_rhs(cfg, ut, vt, fluid, dt_proj)
    a_diag = pressure_matrix_diag(cfg, solid, fluid)
    p, iters, resid = solve_pressure_jacobi_plain(cfg, b, a_diag, fluid)
    u2, v2 = face_update(cfg, clamp_pressure(p, fluid), ut, vt, fluid,
                         solid, dt)
    return u2, v2, iters, resid, max_speed_sq(cfg, u2, v2)


def jacobi_lib():
    lib = _build.load("jacobi_pcg", flags=["-fmad=false"])
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    _build.bind(lib, "eu_jacobi_solve", [I, I, I, F, F] + [P] * 12)
    _build.bind(lib, "eu_jacobi_stream_solve", [I, I, I, F, F] + [P] * 12)
    _build.bind(lib, "eu_jacobi_project", [I, I, I, F, F, F, F, F]
                + [P] * 18)
    _build.bind(lib, "eu_jacobi_substep", [I, I, I, F, F, F, F, F, F]
                + [P] * 21)
    return lib


class Workspace:
    """The device buffers of one Jacobi solve (csrc/jacobi_pcg.cu): the
    packed matrix, r, p, s and As planes, the block partials, and the
    solver's scalars and flags."""

    def __init__(self, Y: int, X: int, device):
        f = torch.float32
        self.planes = [torch.empty((Y, X), dtype=f, device=device)
                       for _ in range(5)]
        self.p = self.planes[2]
        self.part = torch.empty(2 * (-(-Y * X // 256)), dtype=f,
                                device=device)
        self.scal = torch.empty(_S_N, dtype=f, device=device)
        self.flags = torch.empty(_F_N, dtype=torch.int32, device=device)

    def pointers(self):
        """packed, r, p, s, As, part, scal, flags."""
        return [t.data_ptr() for t in
                (*self.planes, self.part, self.scal, self.flags)]

    def result(self):
        """(iterations, residual) as device tensors."""
        return self.flags[_F_ITERS].clone(), self.scal[_S_RESID].clone()


def solver_args(cfg: SimConfig):
    s = cfg.solver
    return [cfg.ny, cfg.nx, s.max_iterations, float(s.tol), float(s.tol_rel)]


def solve_pressure_jacobi(cfg: SimConfig, b, a_diag, fluid):
    """One Jacobi-PCG solve from p = 0.  Returns (p, iterations,
    residual).  CUDA tensors run the kernel; CPU tensors the plain
    version."""
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["K8"] += 1
        return solve_pressure_jacobi_plain(cfg, b, a_diag, fluid)
    plane = (cfg.ny, cfg.nx)
    dev = b.device
    p_b = _build.require(b, "b", torch.float32, plane)
    p_a = _build.require(a_diag, "a_diag", torch.int32, plane, dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, plane, dev)
    ws = Workspace(*plane, dev)
    lib = jacobi_lib()
    _build.LAUNCHES["K8"] += 1
    rc = lib.eu_jacobi_solve(*solver_args(cfg), p_a, p_fl, p_b,
                             *ws.pointers(), _build.stream())
    _build.check(lib, rc, "eu_jacobi_solve")
    return (ws.p, *ws.result())


def project_jacobi(cfg: SimConfig, dt, ut, vt, fluid, solid):
    """Jacobi projection of (ut, vt) with one dt for the RHS and the face
    update.  Returns (u2, v2, iterations, residual,
    msq).  CUDA tensors run the kernel; CPU tensors the plain version."""
    if ut.device.type == "cpu":
        _build.PLAIN_CALLS["K9"] += 1
        return project_jacobi_plain(cfg, dt, ut, vt, fluid, solid)
    plane = (cfg.ny, cfg.nx)
    dev = ut.device
    f = torch.float32
    ptr = [_build.require(fluid, "fluid", torch.bool, plane),
           _build.require(solid, "solid", torch.bool, plane, dev)]
    p_dt = _build.require(dt, "dt", f, (), dev)
    ptr += [p_dt, p_dt,
            _build.require(ut, "ut", f, plane, dev),
            _build.require(vt, "vt", f, plane, dev)]
    u2 = torch.empty(plane, dtype=f, device=dev)
    v2 = torch.empty(plane, dtype=f, device=dev)
    msq = torch.empty((), dtype=f, device=dev)
    ws = Workspace(*plane, dev)
    h = cfg.side_length
    lib = jacobi_lib()
    _build.LAUNCHES["K9"] += 1
    rc = lib.eu_jacobi_project(
        *solver_args(cfg), 1.0 / h, h * h * cfg.density,
        -1.0 / (cfg.density * h), *ptr, u2.data_ptr(), v2.data_ptr(),
        *ws.pointers(), msq.data_ptr(), _build.stream())
    _build.check(lib, rc, "eu_jacobi_project")
    return (u2, v2, *ws.result(), msq)
