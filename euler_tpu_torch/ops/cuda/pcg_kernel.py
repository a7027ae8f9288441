"""K8 and K9: the Jacobi-PCG solve and projection
(`euler_tpu/ops/pallas/pcg_kernel.py`).

`solve_pressure_jacobi` (K8) replaces the Pallas kernel `_pcg_kernel`
launched by `solve_pressure_pallas` (pcg_kernel.py:163-204), same
contract: (p, iterations, residual) for A p = b from p = 0 (it takes no
warm start, as the Pallas kernel takes none).  `project_jacobi` (K9)
replaces `_project_kernel` launched by `project_pallas`
(pcg_kernel.py:402-443): the packed matrix and the divergence RHS, the
same solve, the pressure clamp, the face update and the CFL maxsq,
returning (u2, v2, iterations, residual, msq).

On an H100 an iteration is bound by bytes: two sweeps that move 9.5
[Y, X] plane passes (40 MB at 1024², 11.9 us at 3.35 TB/s; the live
planes fit the 50 MB L2, so that is an upper bound on the floor), and
two grid-wide reductions.  The design (`csrc/jacobi_pcg.cu`) runs an
iteration as two sweeps whose last CTA ends the reduction, in the plain
loop's kernels' reduction order, reads the operator as one byte a cell,
keeps s in two planes and defers p += alpha s into the next iteration.
Every buffer lives in a workspace cached per device and grid
(`workspace`), with a CUDA graph of 8 iterations that a solve replays up
to its cap: the cap, the tolerance and the stop flag live on the device,
and the host reads the flag only between batches of 13 replays (104
iterations), so a solve at the speed mode's budget of 100 never waits
on the card and one that stops early replays at most 12 chunks of
no-ops.  K8 writes p into a fresh plane; K9 and K10
(`substep_kernel.py`) solve on the same workspace.

The plain versions: `solve_pressure_jacobi_plain` is `pcg_loop` with the
Jacobi preconditioner and `apply_a`, and `project_jacobi_plain` is the
K9 sequence of plain ops plus `max_speed_sq`.

`pallas_solver_fits` and `fused_projection_fits` are the JAX package's
gates for K8 and K9 (pcg_kernel.py:207, :446).
"""

from __future__ import annotations

import collections
import ctypes

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

# csrc/chain_reduce.cuh's layout of a solve's device scalars and flags
_S_N = 5       # scal floats
_S_RESID = 4   # scal index of the final max|r|
_F_N = 5       # flags ints: done, iterations, p update pending, ticket, cap
_F_ITERS = 1   # flags index of the iteration count
_CHAINS = 1024  # running partial sums a reduction keeps
_MAX_WORKSPACES = 4
# a workspace holds 21 bytes a cell: ~22 MB at 1024², ~95 MB at K8's
# largest grid (2125²)
_MAX_WORKSPACE_BYTES = 256 * 2**20


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
    _build.bind(lib, "eu_jacobi_create",
                [I, I] + [P] * 9 + [ctypes.POINTER(ctypes.c_void_p)])
    _build.bind(lib, "eu_jacobi_destroy", [P])
    _build.bind(lib, "eu_jacobi_solve", [P, I, F, F] + [P] * 5)
    _build.bind(lib, "eu_jacobi_project", [P, I, F, F, F, F, F] + [P] * 10)
    _build.bind(lib, "eu_jacobi_substep", [P, I, F, F, F, F, F, F]
                + [P] * 10 + [I] * 3 + [P])
    return lib


class JacobiWorkspace:
    """The device buffers of one grid's Jacobi solves and the CUDA solver
    over them (csrc/jacobi_pcg.cu): the operator code, r, p, As and two s
    planes, the chain values of
    the reductions, the scalars and flags, K9/K10's tail partials, and the
    graph of one chunk of iterations.  A solve reads and writes only
    these, so nothing it returns may alias them."""

    def __init__(self, Y: int, X: int, device):
        f = torch.float32
        self.code = torch.empty((Y, X), dtype=torch.uint8, device=device)
        self.r, self.p, self.As = (torch.empty((Y, X), dtype=f,
                                               device=device)
                                   for _ in range(3))
        self.s = torch.empty((2, Y, X), dtype=f, device=device)
        self.chains = torch.empty(2 * _CHAINS, dtype=f, device=device)
        self.scal = torch.empty(_S_N, dtype=f, device=device)
        self.flags = torch.empty(_F_N, dtype=torch.int32, device=device)
        self.part = torch.empty(2 * (-(-Y * X // 256)), dtype=f,
                                device=device)
        self.lib = jacobi_lib()
        self.handle = None
        handle = ctypes.c_void_p()
        with torch.cuda.device(device):
            rc = self.lib.eu_jacobi_create(
                Y, X, *(t.data_ptr() for t in self.buffers()),
                ctypes.byref(handle))
        _build.check(self.lib, rc, "eu_jacobi_create")
        self.handle = handle.value

    def buffers(self):
        """code, r, p, As, s, chains, scal, flags, part: the order
        eu_jacobi_create takes them in."""
        return (self.code, self.r, self.p, self.As, self.s, self.chains,
                self.scal, self.flags, self.part)

    @property
    def nbytes(self) -> int:
        """Device bytes of the workspace's buffers."""
        return sum(t.numel() * t.element_size() for t in self.buffers())

    def close(self):
        """Free the solver and its graph once the last solve's replays have
        run; raises when that fails."""
        handle, self.handle = self.handle, None
        if handle:
            _build.check(self.lib, self.lib.eu_jacobi_destroy(handle),
                         "eu_jacobi_destroy")

    def plane(self):
        """A fresh [Y, X] f32 plane on the workspace's device."""
        return torch.empty_like(self.p)

    def result(self):
        """(iterations, residual) of the last solve as fresh device
        tensors."""
        return self.flags[_F_ITERS].clone(), self.scal[_S_RESID].clone()


_WORKSPACES: collections.OrderedDict = collections.OrderedDict()


def workspace_key(cfg: SimConfig, device) -> tuple:
    """What a workspace's buffers and captured launches depend on: the
    device and the grid (the stopping rule lives on the device)."""
    return (str(device), cfg.ny, cfg.nx)


def workspace(cfg: SimConfig, device) -> JacobiWorkspace:
    """The cached workspace of `cfg`'s grid on `device`: at most
    _MAX_WORKSPACES entries and _MAX_WORKSPACE_BYTES (`_build.cached`)."""
    return _build.cached(_WORKSPACES, workspace_key(cfg, device),
                         lambda: JacobiWorkspace(cfg.ny, cfg.nx, device),
                         _MAX_WORKSPACES, _MAX_WORKSPACE_BYTES)


def cached_bytes() -> int:
    """Device bytes held by the cached workspaces."""
    return sum(ws.nbytes for ws in _WORKSPACES.values())


def clear_workspaces() -> None:
    """Close and drop every cached workspace."""
    _build.close_all(_WORKSPACES)


def solver_args(cfg: SimConfig):
    """max_iterations, tol, tol_rel."""
    s = cfg.solver
    return [s.max_iterations, float(s.tol), float(s.tol_rel)]


def solve_pressure_jacobi(cfg: SimConfig, b, a_diag, fluid):
    """One Jacobi-PCG solve from p = 0.  Returns (p, iterations,
    residual).  CUDA tensors run the kernel on the cached workspace;
    CPU tensors the plain version."""
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["K8"] += 1
        return solve_pressure_jacobi_plain(cfg, b, a_diag, fluid)
    plane = (cfg.ny, cfg.nx)
    dev = b.device
    p_b = _build.require(b, "b", torch.float32, plane)
    p_a = _build.require(a_diag, "a_diag", torch.int32, plane, dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, plane, dev)
    ws = workspace(cfg, dev)
    p = ws.plane()
    _build.LAUNCHES["K8"] += 1
    rc = ws.lib.eu_jacobi_solve(ws.handle, *solver_args(cfg), p_a, p_fl,
                                p_b, p.data_ptr(), _build.stream())
    _build.check(ws.lib, rc, "eu_jacobi_solve")
    return (p, *ws.result())


def project_jacobi(cfg: SimConfig, dt, ut, vt, fluid, solid):
    """Jacobi projection of (ut, vt) with one dt for the RHS and the face
    update.  Returns (u2, v2, iterations, residual, msq).  CUDA tensors
    run the kernel on the cached workspace; CPU tensors the plain
    version."""
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
    ws = workspace(cfg, dev)
    u2, v2 = ws.plane(), ws.plane()
    msq = ws.scal.new_empty(())
    h = cfg.side_length
    _build.LAUNCHES["K9"] += 1
    rc = ws.lib.eu_jacobi_project(
        ws.handle, *solver_args(cfg), 1.0 / h, h * h * cfg.density,
        -1.0 / (cfg.density * h), *ptr, u2.data_ptr(), v2.data_ptr(),
        msq.data_ptr(), _build.stream())
    _build.check(ws.lib, rc, "eu_jacobi_project")
    return (u2, v2, *ws.result(), msq)
