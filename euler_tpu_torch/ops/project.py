"""Pressure projection (`euler_tpu/ops/project.py`, main.c:554-575,
679-806): the divergence right-hand side, the matrix diagonal, the
5-point operator, the PCG loop, the solver dispatch and the projection.

The dispatch is that of the JAX package with `use_pallas=True`
(`solver_route`): the JAX size gates pick K8 (`ops/cuda/pcg_kernel.py`),
K3 (`ops/cuda/mg_kernel.py`), K11 (`ops/cuda/mg_stream_kernel.py`) or K12
(`ops/cuda/pcg_stream_kernel.py`), in that order; where none fits, the
JAX package runs its jnp `pcg_loop`, which the port runs only on CPU
tensors.  Every iterate stays exactly zero outside the fluid, so dense
reductions equal the reference's fluid-masked ones.
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
    """b = -div(u) * density * h^2 / dt on fluid cells (main.c:713-724);
    h^2 rho / dt is computed in float, as C does."""
    f = u.dtype
    inv_h = torch.as_tensor(1.0 / cfg.side_length, dtype=f, device=u.device)
    div = (u - shift_left(u) + v - shift_down(v)) * inv_h
    scale = torch.as_tensor(cfg.side_length * cfg.side_length * cfg.density,
                            dtype=f, device=u.device)
    k_inv_scale = scale / torch.as_tensor(dt, dtype=f, device=u.device)
    return torch.where(fluid, -div * k_inv_scale, 0.0)


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
    kernels the port's Jacobi routes replace (pcg_kernel.py:72-75): a
    fluid cell with a = 0 keeps r."""
    fl = fluid.to(torch.float32)
    invd = fl / torch.clamp_min(a_diag.to(torch.float32), 1.0)
    return lambda r: invd * r


def _make_preconditioner(cfg: SimConfig, a_diag, fluid):
    """z = M^-1 r for `pcg_loop`.  "mg" is K3's own loop
    (`solve_pressure`); IC(0) is not ported."""
    kind = cfg.solver.preconditioner
    if kind == "jacobi":
        return jacobi_preconditioner(a_diag, fluid)
    if kind == "none":
        return lambda r: torch.where(fluid, r, 0.0)
    if kind == "ic0":
        raise NotImplementedError(
            "the IC(0) preconditioner is ROADMAP queue 1 item M9")
    raise NotImplementedError(f"preconditioner {kind!r} has no pcg_loop "
                              "form in the port")


def pcg_loop(cfg: SimConfig, b, apply_fn, precon, x0=None):
    """The PCG recurrence of main.c:738-767 (JAX `pcg_loop`): the
    all-zero early-out, the tolerance max(tol, tol_rel * ||b||_inf) with
    ||b|| taken before any warm-start subtraction, and the NaN-robust stop
    test not (max|r| > tol) after the p/r update.  `x0` (zero outside the
    fluid) warm-starts it.  Reads the stop flag on the host once per
    iteration.  Returns (p, iterations, residual)."""
    s = cfg.solver
    b_norm = b.abs().max()
    tol = torch.maximum(torch.tensor(s.tol, dtype=b.dtype, device=b.device),
                        s.tol_rel * b_norm)
    nonzero = b_norm != 0
    if x0 is None:
        p = torch.zeros_like(b)
        r = b
        done = ~nonzero
    else:
        p = torch.where(nonzero, x0, 0.0)
        r = b - apply_fn(p)
        done = ~nonzero | ~(r.abs().max() > tol)
    z = precon(r)
    d = z
    sigma = (z * r).sum()
    iters = 0
    while iters < s.max_iterations and not bool(done):
        Ad = apply_fn(d)
        zs = (Ad * d).sum()
        alpha = sigma / torch.where(zs != 0, zs, 1.0)
        p = p + alpha * d
        r = r - alpha * Ad
        done = ~(r.abs().max() > tol)
        z = precon(r)
        sigma_new = (z * r).sum()
        beta = sigma_new / torch.where(sigma != 0, sigma, 1.0)
        d = z + beta * d
        sigma = sigma_new
        iters += 1
    return (p, torch.tensor(iters, dtype=torch.int32, device=b.device),
            r.abs().max())


def solver_route(cfg: SimConfig, solid_given: bool = True):
    """The kernel `solve_pressure` runs, by the JAX package's chain
    (ops/project.py:191-223): "K8", "K3" (only with the solid mask),
    "K11", "K12", or None where it falls through to its jnp `pcg_loop`."""
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
    return None


def solve_pressure(cfg: SimConfig, b, a_diag, fluid, solid=None, x0=None):
    """PCG for A p = b (main.c:738-767).  Returns (p, iterations, resid).
    Runs the kernel `solver_route` names; only K3 reads `x0`, as in the
    JAX package.  Without a kernel, `pcg_loop` on CPU tensors and
    NotImplementedError on the card."""
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
    if b.device.type != "cpu":
        raise NotImplementedError(
            "no kernel fits this solve; the JAX package runs its jnp "
            "pcg_loop here (ROADMAP queue 1 item M11)")
    precon = _make_preconditioner(cfg, a_diag, fluid)
    return pcg_loop(cfg, b, lambda s: apply_a(a_diag, fluid, s), precon,
                    x0=x0)


def clamp_pressure(p, fluid):
    """p >= 0 on fluid cells, 0 elsewhere (main.c:773-779)."""
    return torch.where(fluid, torch.clamp_min(p, 0.0), 0.0)


def face_update(cfg: SimConfig, p, u, v, fluid, solid, dt):
    """The 3-way solid/fluid/air face velocity update (main.c:782-806)
    with the clamped pressure."""
    c = torch.tensor(-1.0 / (cfg.density * cfg.side_length), dtype=u.dtype,
                     device=u.device)
    u_keep = (valid_region(cfg, "u", u.device) & ~u_property(solid)
              & u_property(fluid))
    u2 = torch.where(u_keep, u + (c * (shift_right(p) - p)) * dt, 0.0)
    v_keep = (valid_region(cfg, "v", v.device) & ~v_property(solid)
              & v_property(fluid))
    v2 = torch.where(v_keep, v + (c * (shift_up(p) - p)) * dt, 0.0)
    return u2, v2


def project(cfg: SimConfig, dt, u, v, fluid, solid, p0=None):
    """Full projection (main.c:709-806): returns (u_out, v_out, info) with
    info's "pressure" the clamped pressure.  `p0` (with warm_start) is
    re-masked to the current fluid and seeds the solve."""
    b = divergence_rhs(cfg, u, v, fluid, dt)
    a_diag = pressure_matrix_diag(cfg, solid, fluid)
    x0 = None
    if p0 is not None and cfg.solver.warm_start:
        x0 = torch.where(fluid, p0, 0.0)
    p, iters, resid = solve_pressure(cfg, b, a_diag, fluid, solid, x0=x0)
    p = clamp_pressure(p, fluid)
    u_out, v_out = face_update(cfg, p, u, v, fluid, solid, dt)
    return u_out, v_out, {"pressure": p, "iterations": iters,
                          "residual": resid}
