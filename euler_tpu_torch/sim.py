"""Step orchestration (`euler_tpu/sim.py`): one frame = `max_substeps`
CFL substeps, on the ported slice's configurations.

The reference's data-dependent substep loop (main.c:851) stays a fixed
trip of masked substeps, as in the JAX package:
  * dt comes from the maxsq the previous projection emitted (computed
    once on the incoming state);
  * an inactive substep runs with dt = 0 for the marker pass (a bitwise
    identity on the store) and dt_proj = +inf for the RHS (exactly zero,
    so the solve exits with 0 iterations); its grid fields, colours, the
    previous counts and the pressure are then selected away, so the warm
    start survives a frame's trailing inactive substeps.  The unfused
    projections also take dt_proj as their face-update dt, as the JAX
    package's do, which gives NaN on inactive substeps that the same
    select discards;
  * the alive plane is re-derived once per frame.

A substep is the marker pass (K1), then the route `route` names, chosen
as the JAX package with `use_pallas=True` chooses it, by the same size
gates (written for the TPU's VMEM; see `ops/cuda/pcg_kernel.py`):
  * fused (`fuse_projection`, mono, no sources, and the fused kernel's
    gate): grid stage + projection in one wrapper call, K2 (MG-PCG, K3
    inside) or K10 (Jacobi);
  * otherwise the grid stage, K7 with `use_pallas_grid` in mono, else
    plain ops (with the colours' advection in rainbow mode), then K9
    (Jacobi with `fuse_projection`, under its gate) or `project()`, whose
    solve is K8, K3, K11 or K12 by the gates of `solve_pressure`.
Nothing here reads a device value on the host; the solvers' stop flags
are the only syncs.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.advect import advect_p
from euler_tpu_torch.ops.cuda import pcg_kernel, substep_kernel
from euler_tpu_torch.ops.cuda.grid_kernel import (
    advect_forces,
    extrapolate_zero,
    grid_stage,
)
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.markers_slots import live_slots, marker_pass_slots
from euler_tpu_torch.ops.project import project, solver_route


def check_slice(cfg: SimConfig, scn: Scenario) -> None:
    """Raise NotImplementedError for configurations the port does not run
    yet, naming the ROADMAP item that will port them."""
    s = cfg.solver
    if cfg.marker_layout != "slots":
        raise NotImplementedError(
            "marker_layout='global' is ROADMAP queue 1 item M9")
    if scn.num_sources > 0:
        raise NotImplementedError(
            "source emission is ROADMAP queue 1 item M8")
    if s.preconditioner == "ic0":
        raise NotImplementedError(
            "the IC(0) preconditioner is ROADMAP queue 1 item M9")
    if s.preconditioner == "none":
        raise NotImplementedError(
            "the unpreconditioned solve is ROADMAP queue 1 item M14")
    if s.preconditioner == "mg" and not (s.mg_scheme == "galerkin"
                                         and s.mg_smoother == "cheby"):
        raise NotImplementedError(
            f"MG {s.mg_scheme} / {s.mg_smoother}: only galerkin MG with "
            "Chebyshev smoothing is ported; the rest is ROADMAP queue 1 "
            "item M14")
    if s.dtype != "float32" or cfg.dtype != "float32":
        raise NotImplementedError("f64 is ROADMAP queue 1 item M9")
    if s.mg_frame_hierarchy:
        raise NotImplementedError(
            "mg_frame_hierarchy is ROADMAP queue 1 item M14")
    if route(cfg, scn)[1] is None:
        raise NotImplementedError(
            f"{s.preconditioner} at {cfg.ny}x{cfg.nx}: no kernel fits, the "
            "JAX package runs its jnp pcg_loop here (level sizes that do "
            "not halve evenly to mg_min_size, or rows beyond 2125 that "
            "are not a multiple of 8; ROADMAP queue 1 item M11)")


def _use_fused_substep(cfg: SimConfig, scn: Scenario) -> bool:
    """The JAX `_use_fused_substep` (sim.py:43-67): mono, fuse_projection,
    no sources, and the fused kernel's size gate."""
    if cfg.rainbow or not cfg.solver.fuse_projection or scn.num_sources:
        return False
    kind = cfg.solver.preconditioner
    if kind == "mg":
        return substep_kernel.substep_fused_fits(cfg)
    if kind == "jacobi":
        return substep_kernel.substep_jacobi_fused_fits(cfg)
    return False


def _use_fused_projection(cfg: SimConfig) -> bool:
    """The JAX `_use_fused_projection` (sim.py:70-78)."""
    return (cfg.solver.fuse_projection
            and pcg_kernel.fused_projection_fits(cfg))


def route(cfg: SimConfig, scn: Scenario):
    """(grid stage, projection) of a substep: ("fused", "K2" or "K10"),
    or the grid stage "K7" or "plain" with the projection "K9" or the
    solve of `project()` ("K8", "K3", "K11", "K12", or None where the JAX
    package runs its jnp `pcg_loop`)."""
    if _use_fused_substep(cfg, scn):
        return "fused", "K2" if cfg.solver.preconditioner == "mg" else "K10"
    grid = "K7" if cfg.use_pallas_grid and not cfg.rainbow else "plain"
    if _use_fused_projection(cfg):
        return grid, "K9"
    return grid, solver_route(cfg)


def _colors(state: FluidState, fn):
    return state.replace(r=fn(state.r), g=fn(state.g), b=fn(state.b))


def substep(cfg: SimConfig, scn: Scenario, state: FluidState, dt, dt_proj,
            defer_alive: bool = False):
    """One CFL substep with dt chosen.  Returns (state, msq,
    pcg_iterations)."""
    state = marker_pass_slots(cfg, scn, state, dt, defer_alive=defer_alive)
    fluid, prev, solid = state.fluid, state.prev_fluid, scn.solid
    if cfg.rainbow:
        # colours extrapolate before sources run (main.c:859-863)
        state = _colors(state, lambda q: extrapolate(cfg, q, fluid, prev,
                                                     "p"))

    grid, proj = route(cfg, scn)
    if proj == "K10":
        u2, v2, iters, _resid, msq = substep_kernel.project_substep_jacobi(
            cfg, dt, dt_proj, state.u, state.v, fluid, prev, solid)
        p2 = state.p  # the Jacobi speed mode never warm-starts
        return state.replace(u=u2, v=v2, p=p2), msq, iters
    if proj == "K2":
        u2, v2, iters, _resid, msq, p2 = substep_kernel.project_substep_mg(
            cfg, dt, dt_proj, state.u, state.v, fluid, prev, solid, state.p)
        return state.replace(u=u2, v=v2, p=p2), msq, iters

    if grid == "K7":
        ut, vt = grid_stage(cfg, state.u, state.v, fluid, prev, solid, dt)
    else:
        uu, vv = extrapolate_zero(cfg, state.u, state.v, fluid, prev, solid)
        if cfg.rainbow:
            state = _colors(state,
                            lambda q: advect_p(cfg, q, uu, vv, fluid, dt))
        ut, vt = advect_forces(cfg, uu, vv, fluid, solid, dt)
    if proj == "K9":
        u2, v2, iters, _resid, msq = pcg_kernel.project_jacobi(
            cfg, dt_proj, ut, vt, fluid, solid)
        # K9 does not give its pressure: a later warm start starts cold
        p2 = torch.zeros_like(state.p)
    else:
        u2, v2, info = project(cfg, dt_proj, ut, vt, fluid, solid,
                               p0=state.p)
        msq = max_speed_sq(cfg, u2, v2)
        iters, p2 = info["iterations"], info["pressure"]
    return state.replace(u=u2, v=v2, p=p2), msq, iters


def _dt_from_msq(cfg: SimConfig, msq, frame_time):
    """calculate_timestep (main.c:834-841) from a precomputed maxsq."""
    max_velocity = torch.sqrt(msq.to(frame_time.dtype))
    pos = max_velocity > 0.0
    dt = torch.where(pos, cfg.cfl * cfg.side_length
                     / torch.where(pos, max_velocity, 1.0), torch.inf)
    return torch.minimum(dt, frame_time)


def _step_frame_impl(cfg: SimConfig, scn: Scenario, state: FluidState):
    """One frame.  Returns (state, stats) with stats the device tensors
    `n_active` (active substeps) and `pcg_iters` (PCG iterations summed
    over the active substeps)."""
    check_slice(cfg, scn)
    f = state.u.dtype
    dev = state.u.device
    frame_time = torch.tensor(cfg.frame_time, dtype=f, device=dev)
    msq = max_speed_sq(cfg, state.u, state.v)
    n_active = torch.zeros((), dtype=torch.int32, device=dev)
    pcg_iters = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.max_substeps):
        active = frame_time > 0.0
        dt = torch.where(active, _dt_from_msq(cfg, msq, frame_time), 0.0)
        dt_proj = torch.where(active, dt, torch.inf)
        new, new_msq, iters = substep(cfg, scn, state, dt, dt_proj,
                                      defer_alive=True)

        def sel(name):
            return torch.where(active, getattr(new, name),
                               getattr(state, name))

        keep = ["u", "v", "prev_marker_count", "p"]
        if cfg.rainbow:
            keep += ["r", "g", "b"]
        state = new.replace(**{name: sel(name) for name in keep})
        msq = torch.where(active, new_msq, msq)
        frame_time = torch.where(active, frame_time - dt, frame_time)
        n_active = n_active + active.to(torch.int32)
        pcg_iters = pcg_iters + torch.where(active, iters, 0)
    state = state.replace(
        alive=live_slots(state.marker_count, cfg.slots_per_cell),
        frame_count=state.frame_count + 1,
    )
    return state, {"n_active": n_active, "pcg_iters": pcg_iters}


def step_frame(cfg: SimConfig, scn: Scenario, state: FluidState) -> FluidState:
    return _step_frame_impl(cfg, scn, state)[0]


def step_frame_stats(cfg: SimConfig, scn: Scenario, state: FluidState):
    """(state', stats): like step_frame, plus the active-substep and PCG
    iteration counts of the frame (device tensors)."""
    return _step_frame_impl(cfg, scn, state)


def run_frames(cfg: SimConfig, scn: Scenario, state: FluidState, n: int):
    """Step `n` frames (benchmark / headless path)."""
    for _ in range(n):
        state = step_frame(cfg, scn, state)
    return state
