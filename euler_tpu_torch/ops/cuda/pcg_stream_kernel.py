"""K12: Jacobi-PCG with the As recurrence
(`euler_tpu/ops/pallas/pcg_stream_kernel.py`).

`solve_pressure_stream` replaces the Pallas kernel `_stream_kernel`
launched by `solve_pressure_stream` (pcg_stream_kernel.py:249-290), same
contract: (p, iterations, residual) for A p = b from p = 0.  The JAX
package routes Jacobi solves to it beyond K8's VMEM budget, from about
2125² (`ops/project.solve_pressure`).  It computes K8's solve another way:
s' = z + beta s and As' = A z + beta As with z = invd r recomputed on the
fly, so an iteration is two sweeps, not three, and its rounding differs
from K8's.

On an H100 it is bound by bytes: the two sweeps move 13 [Y, X] f32
planes an iteration (872 MB at 4096², 0.26 ms at 3.35 TB/s), with two
grid-wide reductions between them.  The CUDA side is K8's
(`csrc/jacobi_pcg.cu`: head, reductions, the p/r sweep, the stop flag on
the device read by the host every 8 iterations) with the s/As sweep in
place of K8's apply and direction sweeps: four launches an iteration.

`solve_pressure_stream_plain` is the plain version, the two-sweep
recurrence written out; `stream_solver_fits` is the JAX package's gate
(:293), kept as integer arithmetic: see `pcg_kernel._VMEM_BUDGET`.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.pcg_kernel import (
    Workspace,
    jacobi_lib,
    solver_args,
)
from euler_tpu_torch.ops.project import apply_a, jacobi_preconditioner


def stream_solver_fits(cfg: SimConfig) -> bool:
    """Jacobi, f32, and rows that split into 8-row blocks."""
    return (cfg.solver.preconditioner == "jacobi"
            and cfg.solver.dtype == "float32"
            and cfg.ny % 8 == 0)


def solve_pressure_stream_plain(cfg: SimConfig, b, a_diag, fluid):
    """Plain K12 from p = 0, with d the search direction: d = invd b,
    As = 0, sigma = <invd b, b>; per iteration z = invd r, d = z + beta d,
    As = A z + beta As, alpha = sigma / <As, d>, p += alpha d,
    r -= alpha As, then the NaN-robust stop test on max|r| and
    beta = <invd r, r> / sigma.  Reads the stop flag on the host once per
    iteration."""
    s = cfg.solver
    precon = jacobi_preconditioner(a_diag, fluid)
    r = b
    p = torch.zeros_like(b)
    d = precon(b)
    As = torch.zeros_like(b)
    sigma = (d * b).sum()
    rmax0 = b.abs().max()
    tol = torch.maximum(torch.tensor(s.tol, dtype=b.dtype, device=b.device),
                        s.tol_rel * rmax0)
    done = ~(rmax0 != 0)
    beta = torch.zeros((), dtype=b.dtype, device=b.device)
    iters = 0
    while iters < s.max_iterations and not bool(done):
        z = precon(r)
        d = z + beta * d
        As = apply_a(a_diag, fluid, z) + beta * As
        zs = (As * d).sum()
        alpha = sigma / torch.where(zs != 0, zs, 1.0)
        p = p + alpha * d
        r = r - alpha * As
        done = ~(r.abs().max() > tol)
        sigma_new = (precon(r) * r).sum()
        beta = sigma_new / torch.where(sigma != 0, sigma, 1.0)
        sigma = sigma_new
        iters += 1
    return (p, torch.tensor(iters, dtype=torch.int32, device=b.device),
            r.abs().max())


def solve_pressure_stream(cfg: SimConfig, b, a_diag, fluid):
    """One Jacobi-PCG solve in the two-sweep form, from p = 0.  Returns
    (p, iterations, residual).  CUDA tensors run the kernel; CPU tensors
    the plain version."""
    if b.device.type == "cpu":
        _build.PLAIN_CALLS["K12"] += 1
        return solve_pressure_stream_plain(cfg, b, a_diag, fluid)
    plane = (cfg.ny, cfg.nx)
    dev = b.device
    p_b = _build.require(b, "b", torch.float32, plane)
    p_a = _build.require(a_diag, "a_diag", torch.int32, plane, dev)
    p_fl = _build.require(fluid, "fluid", torch.bool, plane, dev)
    ws = Workspace(*plane, dev)
    lib = jacobi_lib()
    _build.LAUNCHES["K12"] += 1
    rc = lib.eu_jacobi_stream_solve(*solver_args(cfg), p_a, p_fl, p_b,
                                    *ws.pointers(), _build.stream())
    _build.check(lib, rc, "eu_jacobi_stream_solve")
    return (ws.p, *ws.result())
