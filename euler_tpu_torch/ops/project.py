"""Pressure projection (`euler_tpu/ops/project.py`, main.c:554-575,
679-806): the divergence right-hand side, the matrix diagonal, the
5-point operator, the PCG loop, the solver dispatch and the projection.

The dispatch is that of the JAX package with `use_pallas=True`
(`solver_route`): the JAX size gates pick K8 (`ops/cuda/pcg_kernel.py`),
K3 (`ops/cuda/mg_kernel.py`), K11 (`ops/cuda/mg_stream_kernel.py`) or K12
(`ops/cuda/pcg_stream_kernel.py`), in that order; where none fits, the
JAX package runs its jnp `pcg_loop`, and the port runs P1
(`ops/cuda/pcg_general_kernel.py`, the same loop as one CUDA solver, in
f32 or f64, with no preconditioner, the jnp-form Jacobi or IC(0)), for
Galerkin MG with Chebyshev or RB-GS smoothing P3 (the CLI's converged
mode at sizes whose levels do not halve evenly: 1080 x 1920, 1200²,
1448²; f64 and RB-GS at every size), the same loop with the MG cycle on
padded levels as its preconditioner, and for the rediscretized hierarchy
P7, the same loop with its V-cycle.  Every iterate stays exactly zero
outside the fluid, so dense reductions equal the reference's
fluid-masked ones.

The RHS is taken in the grid's dtype and widened to the solver's, and
the face update takes the pressure difference in the solver's dtype and
narrows it to the grid's, as the JAX package does (an f64 solve of f32
velocities: the reference's double-precision CG, main.c:577-578, 716).
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import (
    shift_down,
    shift_left,
    shift_right,
    shift_up,
    u_property,
    v_property,
    valid_region,
)


def divergence_rhs(cfg: SimConfig, u, v, fluid, dt):
    """b = -div(u) * density * h^2 / dt on fluid cells (main.c:713-724),
    in the solver's dtype: div and h^2 rho / dt are computed in the grid's
    dtype (C's float) and widened before the product."""
    f = u.dtype
    sdt = getattr(torch, cfg.solver.dtype)
    # scalars as fills on the device, not copies from the host (a copy is
    # a stream sync)
    inv_h = torch.full((), 1.0 / cfg.side_length, dtype=f, device=u.device)
    div = (u - shift_left(u) + v - shift_down(v)) * inv_h
    scale = torch.full((), cfg.side_length * cfg.side_length * cfg.density,
                       dtype=f, device=u.device)
    k_inv_scale = scale / torch.as_tensor(dt, device=u.device).to(f)
    b = -div.to(sdt) * k_inv_scale.to(sdt)
    return torch.where(fluid, b, 0.0)


def pressure_matrix_diag(cfg: SimConfig, solid, fluid):
    """a_diag = 4 - #solid neighbours, on fluid cells (main.c:554-559)."""
    s = solid.to(torch.int32)
    diag = 4 - (shift_left(s) + shift_right(s) + shift_down(s) + shift_up(s))
    return torch.where(fluid, diag, 0).to(torch.int32)


def apply_a(a_diag, fluid, s):
    """5-point Laplacian application (main.c:679-691); `s` must be zero
    outside the fluid."""
    lap = a_diag.to(s.dtype) * s - (
        shift_left(s) + shift_right(s) + shift_down(s) + shift_up(s)
    )
    return torch.where(fluid, lap, 0.0)


def jacobi_preconditioner(a_diag, fluid):
    """z = invd * r with invd = fl / max(a, 1), the form of the Pallas
    kernels the port's Jacobi routes K8-K12 replace (pcg_kernel.py:72-75):
    a fluid cell with a = 0 keeps r."""
    fl = fluid.to(torch.float32)
    invd = fl / torch.clamp_min(a_diag.to(torch.float32), 1.0)
    return lambda r: invd * r


def jacobi_preconditioner_jnp(a_diag, fluid):
    """z = r / d, the JAX package's jnp form (project.py:80-86), which its
    `pcg_loop` runs where no Pallas kernel fits: r / a on fluid cells with
    a > 0, r on the other fluid cells, 0 elsewhere.  It rounds apart from
    `jacobi_preconditioner`'s invd * r in the last bit for many r (a = 3,
    say)."""
    keep = fluid & (a_diag > 0)

    def precon(r):
        d = a_diag.to(r.dtype)
        z = r / torch.where(d > 0, d, 1.0)
        return torch.where(keep, z, torch.where(fluid, r, 0.0))

    return precon


def make_preconditioner(cfg: SimConfig, a_diag, fluid, solid=None):
    """z = M^-1 r of the JAX `_make_preconditioner` for `pcg_loop` (the
    plain version of P1, P3 and P7): "jacobi" in its jnp form, "none",
    "ic0", "mg" (`multigrid.make_mg_preconditioner`: the Galerkin cycle
    with Chebyshev or RB-GS smoothing, or the rediscretized V-cycle, which
    needs the solid mask)."""
    kind = cfg.solver.preconditioner
    dtype = getattr(torch, cfg.solver.dtype)
    if kind == "jacobi":
        return jacobi_preconditioner_jnp(a_diag, fluid)
    if kind == "none":
        return lambda r: torch.where(fluid, r, 0.0)
    if kind == "ic0":
        from euler_tpu_torch.ops.ic0 import make_ic0_preconditioner

        return make_ic0_preconditioner(a_diag, fluid, dtype)
    if kind == "mg":
        from euler_tpu_torch.ops.multigrid import make_mg_preconditioner

        if solid is None and cfg.solver.mg_scheme != "galerkin":
            raise ValueError("mg preconditioner needs the solid mask")
        return make_mg_preconditioner(cfg, solid, fluid, dtype,
                                      a_diag=a_diag)
    raise NotImplementedError(f"preconditioner {kind!r} has no pcg_loop "
                              "form in the port")


def _masked_dot(a, b):
    # iterates are zero outside the fluid: the dense sum is the
    # reference's fluid-masked dot (main.c:629-639)
    return (a * b).sum()


def _inf_norm(r):
    return r.abs().max()


def pcg_loop(cfg: SimConfig, b, apply_fn, precon, x0=None, dot=None,
             inf_norm=None):
    """The PCG recurrence of main.c:738-767 (JAX `pcg_loop`): the
    all-zero early-out, the tolerance max(tol, tol_rel * ||b||_inf) with
    ||b|| taken before any warm-start subtraction, and the NaN-robust stop
    test not (max|r| > tol) after the p/r update.  `x0` (zero outside the
    fluid) warm-starts it.  `dot` and `inf_norm` are its reductions
    (the local sums and maxima by default; `parallel/halo.py` passes
    them all-reduced over the blocks, as the JAX package's psum and
    pmax).  Reads the stop flag on the host once per iteration.  Returns
    (p, iterations, residual)."""
    s = cfg.solver
    dot = _masked_dot if dot is None else dot
    inf_norm = _inf_norm if inf_norm is None else inf_norm
    b_norm = inf_norm(b)
    tol = torch.maximum(torch.tensor(s.tol, dtype=b.dtype, device=b.device),
                        s.tol_rel * b_norm)
    nonzero = b_norm != 0
    if x0 is None:
        p = torch.zeros_like(b)
        r = b
        done = ~nonzero
    else:
        p = torch.where(nonzero, x0.to(b.dtype), 0.0)
        r = b - apply_fn(p)
        done = ~nonzero | ~(inf_norm(r) > tol)
    z = precon(r)
    d = z
    sigma = dot(z, r)
    iters = 0
    while iters < s.max_iterations and not bool(done):
        Ad = apply_fn(d)
        zs = dot(Ad, d)
        alpha = sigma / torch.where(zs != 0, zs, 1.0)
        p = p + alpha * d
        r = r - alpha * Ad
        done = ~(inf_norm(r) > tol)
        z = precon(r)
        sigma_new = dot(z, r)
        beta = sigma_new / torch.where(sigma != 0, sigma, 1.0)
        d = z + beta * d
        sigma = sigma_new
        iters += 1
    return (p, torch.tensor(iters, dtype=torch.int32, device=b.device),
            inf_norm(r))


def solver_route(cfg: SimConfig, solid_given: bool = True):
    """The kernel `solve_pressure` runs, by the JAX package's chain
    (ops/project.py:191-223): "K8", "K3" (only with the solid mask),
    "K11", "K12", or where it falls through to its jnp `pcg_loop`, "P1"
    (no preconditioner, Jacobi, IC(0)), "P3" (Galerkin MG with Chebyshev
    or RB-GS smoothing, f32 or f64: no f64 or RB-GS solve passes the gates
    of K3 or K11, which are f32 Chebyshev as the JAX package's Pallas MG
    is), "P7" (the rediscretized V-cycle, f32 or f64) or None (MG the
    JAX package does not name)."""
    from euler_tpu_torch.ops.cuda import (
        mg_kernel,
        mg_stream_kernel,
        pcg_kernel,
        pcg_stream_kernel,
    )

    if pcg_kernel.pallas_solver_fits(cfg):
        return "K8"
    if solid_given and mg_kernel.mg_pallas_fits(cfg):
        return "K3"
    if mg_stream_kernel.stream_mg_fits(cfg):
        return "K11"
    if pcg_stream_kernel.stream_solver_fits(cfg):
        return "K12"
    if cfg.solver.preconditioner in ("none", "jacobi", "ic0"):
        return "P1"
    if mg_kernel.galerkin_cheby(cfg) or mg_kernel.galerkin_rbgs(cfg):
        return "P3"
    if mg_kernel.rediscretized(cfg):
        return "P7"
    return None


def solve_pressure(cfg: SimConfig, b, a_diag, fluid, solid=None, x0=None):
    """PCG for A p = b (main.c:738-767).  Returns (p, iterations, resid).
    Runs the kernel `solver_route` names; K3, P1, P3 and P7 read `x0`, as
    the JAX package's Pallas MG kernel and jnp loop do; P7 needs `solid`,
    as the JAX package's rediscretized hierarchy does."""
    route = solver_route(cfg, solid is not None)
    if route == "K8":
        from euler_tpu_torch.ops.cuda.pcg_kernel import solve_pressure_jacobi

        return solve_pressure_jacobi(cfg, b, a_diag, fluid)
    if route == "K3":
        from euler_tpu_torch.ops.cuda.mg_kernel import solve_pressure_mg

        return solve_pressure_mg(cfg, b, a_diag, fluid, solid, x0=x0)
    if route == "K11":
        from euler_tpu_torch.ops.cuda.mg_stream_kernel import (
            solve_pressure_mg_stream,
        )

        return solve_pressure_mg_stream(cfg, b, a_diag, fluid)
    if route == "K12":
        from euler_tpu_torch.ops.cuda.pcg_stream_kernel import (
            solve_pressure_stream,
        )

        return solve_pressure_stream(cfg, b, a_diag, fluid)
    if route in ("P1", "P3", "P7"):
        from euler_tpu_torch.ops.cuda.pcg_general_kernel import (
            solve_pressure_general,
        )

        return solve_pressure_general(cfg, b, a_diag, fluid, x0=x0,
                                      solid=solid)
    s = cfg.solver
    raise ValueError(
        f"MG {s.mg_scheme} / {s.mg_smoother} in {s.dtype}: the JAX package "
        "names the schemes galerkin and rediscretize, the smoothers cheby "
        "and rbgs")


def clamp_pressure(p, fluid):
    """p >= 0 on fluid cells, 0 elsewhere (main.c:773-779)."""
    return torch.where(fluid, torch.clamp_min(p, 0.0), 0.0)


def face_update(cfg: SimConfig, p, u, v, fluid, solid, dt, clamp_ny=None,
                row_offset: int = 0, clamp_nx=None, col_offset: int = 0):
    """The 3-way solid/fluid/air face velocity update (main.c:782-806)
    with the clamped pressure: the pressure difference is taken in p's
    dtype (the solver's) and narrowed to the grid's.  `clamp_ny`,
    `row_offset`, `clamp_nx`, `col_offset`: a block's place in the grid
    (`core/state.valid_region`)."""
    f = u.dtype
    rows = (clamp_ny, row_offset, clamp_nx, col_offset)
    c = torch.full((), -1.0 / (cfg.density * cfg.side_length), dtype=f,
                   device=u.device)
    dtf = torch.as_tensor(dt, device=u.device).to(f)
    u_keep = (valid_region(cfg, "u", u.device, *rows) & ~u_property(solid)
              & u_property(fluid))
    dp_x = (shift_right(p) - p).to(f)
    u2 = torch.where(u_keep, u + (c * dp_x) * dtf, 0.0)
    v_keep = (valid_region(cfg, "v", v.device, *rows) & ~v_property(solid)
              & v_property(fluid))
    dp_y = (shift_up(p) - p).to(f)
    v2 = torch.where(v_keep, v + (c * dp_y) * dtf, 0.0)
    return u2, v2


def project(cfg: SimConfig, dt, u, v, fluid, solid, p0=None):
    """Full projection (main.c:709-806): returns (u_out, v_out, info) with
    info's "pressure" the clamped pressure.  `p0` (with warm_start) is
    re-masked to the current fluid and seeds the solve."""
    b = divergence_rhs(cfg, u, v, fluid, dt)
    a_diag = pressure_matrix_diag(cfg, solid, fluid)
    x0 = None
    if p0 is not None and cfg.solver.warm_start:
        x0 = torch.where(fluid, p0, 0.0).to(b.dtype)
    p, iters, resid = solve_pressure(cfg, b, a_diag, fluid, solid, x0=x0)
    p = clamp_pressure(p, fluid)
    u_out, v_out = face_update(cfg, p, u, v, fluid, solid, dt)
    return u_out, v_out, {"pressure": p, "iterations": iters,
                          "residual": resid}
