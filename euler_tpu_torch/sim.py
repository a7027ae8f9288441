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

A substep is the marker pass (K1), then one of four routes, chosen as the
JAX package with `use_pallas=True` chooses them:
  * fused (`fuse_projection`, mono, no sources): grid stage + projection
    in one wrapper call, K2 (MG-PCG, K3 inside) or K10 (Jacobi);
  * otherwise the grid stage as plain ops (with the colours' advection in
    rainbow mode), then K9 (Jacobi with `fuse_projection`) or `project()`
    (K8 for Jacobi, K3 for MG).
Nothing here reads a device value on the host; the solvers' stop flags
are the only syncs.
"""

from __future__ import annotations

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.advect import advect_p
from euler_tpu_torch.ops.cuda.mg_kernel import mg_fits
from euler_tpu_torch.ops.cuda.pcg_kernel import project_jacobi
from euler_tpu_torch.ops.cuda.substep_kernel import (
    advect_forces,
    extrapolate_zero,
    project_substep_jacobi,
    project_substep_mg,
)
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.markers_slots import live_slots, marker_pass_slots
from euler_tpu_torch.ops.project import project


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
    if s.preconditioner == "mg" and not mg_fits(cfg):
        raise NotImplementedError(
            "level sizes must halve evenly to mg_min_size "
            "(ROADMAP queue 1 item M11)")


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

    jacobi = cfg.solver.preconditioner == "jacobi"
    if cfg.solver.fuse_projection and not cfg.rainbow:
        if jacobi:
            u2, v2, iters, _resid, msq = project_substep_jacobi(
                cfg, dt, dt_proj, state.u, state.v, fluid, prev, solid)
            p2 = state.p  # the Jacobi speed mode never warm-starts
        else:
            u2, v2, iters, _resid, msq, p2 = project_substep_mg(
                cfg, dt, dt_proj, state.u, state.v, fluid, prev, solid,
                state.p)
        return state.replace(u=u2, v=v2, p=p2), msq, iters

    uu, vv = extrapolate_zero(cfg, state.u, state.v, fluid, prev, solid)
    if cfg.rainbow:
        state = _colors(state, lambda q: advect_p(cfg, q, uu, vv, fluid, dt))
    ut, vt = advect_forces(cfg, uu, vv, fluid, solid, dt)
    if cfg.solver.fuse_projection and jacobi:
        u2, v2, iters, _resid, msq = project_jacobi(cfg, dt_proj, ut, vt,
                                                    fluid, solid)
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
