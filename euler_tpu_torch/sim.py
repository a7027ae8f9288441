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
  * on the fused marker passes the alive plane is re-derived once per
    frame; the unfused pass writes it every substep (JAX sim.py:266-269).
The global marker layout (the reference's own, the JAX package's default)
takes the JAX package's other frame loop (sim.py:216-236, 255-330): an
inactive substep runs with dt = 1.0 (a real march whose result is
discarded) and the WHOLE state is selected away, field by field, since
the swap-remove compaction depends on marker order.

A substep is the marker pass `marker_route` names: in the global layout
"G1+G2", the march G1 with the dt-carry fixpoint and the refresh G2
(`ops/markers.py`); in the slot layout the one the JAX package with
`use_pallas_markers=True` chooses (markers_slots.py:354-386, sim.py:
320-334):
  * "K1", the fused march + re-bin (`fuse_marker_pass`, the default);
  * "K4", the same on the persistent padded store
    (`marker_padded_store`, mono, no sources): the store is padded once
    before the substeps and unpadded once after them;
  * "K5+K6", the march and the re-bin as two kernels
    (`fuse_marker_pass=False`).
`step_frame(..., marker_pass=)` replaces that pass by a function of
`marker_pass_slots`'s contract (slot layout only), as the JAX package's
does (sim.py:82-112, 234-236): `parallel/cuda_shard.py`'s K1 per block is
one.  It takes the fused passes' deferred alive plane and never the
padded store.  `step_frame(..., blocks=)` runs each substep as
`blocks.substep` and takes the frame's speeds from
`blocks.max_speed_sq`: `parallel/spatial.Blocks`, the frame on a
rank's block of rows and columns, whose every grid operation runs on its
cells and whose frame-level values are all-reduced over the blocks.
With sources, S1 then emits (in place on tensors the frame owns: on the
slot routes `step_frame` copies the fields it carries from its input
once; in the global layout, where an inactive substep's marker pass is
real and the whole state is selected, the substep copies the colour
planes, RNG and exhausted flag S1 writes, and the marker pass gives
fresh tensors for the rest), after the rainbow colours' extrapolation
and before the grid stage, which sees the fluid mask after emission (JAX
sim.py:115-127).  Then comes the route `route` names, chosen as the JAX package with
`use_pallas=True` chooses it, by the same size gates (written for the
TPU's VMEM; see `ops/cuda/pcg_kernel.py`):
  * fused (`fuse_projection`, mono, no sources, and the fused kernel's
    gate): grid stage + projection in one wrapper call, K2 (MG-PCG, K3
    inside) or K10 (Jacobi);
  * otherwise the grid stage, then K9 (Jacobi with `fuse_projection`,
    under its gate) or `project()`, whose solve is K8, K3, K11 or K12 by
    the gates of `solve_pressure`, or P1 where the JAX package falls
    through to its jnp `pcg_loop` (f64, no preconditioner, IC(0), Jacobi
    beyond K8's and K12's gates), P3 for its Galerkin MG there (level
    sizes that do not halve evenly: 1080 x 1920, 1200², 1448²; f64 and
    RB-GS smoothing at every size), P7 for its rediscretized MG (every
    size).  The JAX package
    runs that grid stage as its K7 with `use_pallas_grid` in mono, else
    as XLA ops; the port
    takes the `use_pallas=True` routes, so on the card it is K7 on every
    such route ("plain" in `route` included), in rainbow mode K7's form
    that also returns the extrapolated velocities, with which the
    colours are advected by plain ops.
Nothing here reads a device value on the host; the solvers' stop flags
are the only syncs, and with `utils.diagnostics.enable_fpmath_asserts`
(the CLI's --sherlock) the NaN check of a frame's output state.
"""

from __future__ import annotations

import dataclasses

import torch

from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.state import FluidState, Scenario
from euler_tpu_torch.ops.advect import advect_p
from euler_tpu_torch.ops.cuda import (
    grid_kernel,
    mg_kernel,
    pcg_kernel,
    substep_kernel,
)
from euler_tpu_torch.ops.extrapolate import extrapolate
from euler_tpu_torch.ops.cuda.marker_fused_kernel import (
    pad_slot_store,
    unpad_slot_store,
)
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.markers import get_marker_pass, update_fluid_sources
from euler_tpu_torch.ops.markers_slots import (
    live_slots,
    marker_pass_slots,
    update_fluid_sources_slots,
)
from euler_tpu_torch.ops.project import project, solver_route
from euler_tpu_torch.utils import diagnostics


def check_slice(cfg: SimConfig, scn: Scenario) -> None:
    """Raise NotImplementedError for configurations the port does not run
    yet, naming the ROADMAP item that will port them."""
    s = cfg.solver
    if cfg.marker_layout not in ("slots", "global"):
        raise ValueError(f"marker_layout {cfg.marker_layout!r}")
    if cfg.cfl > 1.0:
        raise NotImplementedError(
            f"cfl {cfg.cfl} > 1: a marker can move more than one cell a "
            "substep, where the JAX package's re-bins disagree with each "
            "other (its jnp re-bin clamps the move to one cell, its Pallas "
            "K6 takes the exact cell, which no cell gathers from, its "
            "Pallas K1 codes the move as one of 9 and aliases it); the "
            "port, which clamps, refuses it on every slot marker route "
            "(ROADMAP queue 3, closed item 1)")
    if s.dtype not in ("float32", "float64"):
        raise ValueError(f"solver dtype {s.dtype!r}")
    if s.preconditioner == "mg" and not (mg_kernel.galerkin_cheby(cfg)
                                         or mg_kernel.galerkin_rbgs(cfg)
                                         or mg_kernel.rediscretized(cfg)):
        raise ValueError(
            f"MG {s.mg_scheme} / {s.mg_smoother}: the JAX package names the "
            "schemes galerkin and rediscretize, the smoothers cheby and "
            "rbgs")
    if cfg.dtype != "float32":
        raise NotImplementedError(
            "f64 grid fields: the grid-stage and marker kernels are f32 "
            "(the f64 solve, solver.dtype, is ported); ROADMAP queue 1 "
            "item M16")
    if s.mg_frame_hierarchy:
        raise NotImplementedError(
            "mg_frame_hierarchy is ROADMAP queue 1 item M14 part c")


def _use_fused_substep(cfg: SimConfig, scn: Scenario) -> bool:
    """The JAX `_use_fused_substep` (sim.py:43-67): mono, fuse_projection,
    no sources, the slot layout, and the fused kernel's size gate."""
    if (cfg.rainbow or cfg.marker_layout != "slots"
            or not cfg.solver.fuse_projection or scn.num_sources):
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
    """(grid stage, projection) of a substep, as the JAX package names
    them: ("fused", "K2" or "K10"), or the grid stage "K7" or "plain"
    with the projection "K9" or the solve of `project()` ("K8", "K3",
    "K11", "K12", or where the JAX package runs its jnp `pcg_loop`, "P1",
    "P3" for Galerkin MG, "P7" for rediscretized MG, or None for the MG
    `check_slice` refuses).
    On the card "plain" runs K7 too: `substep` takes K7 for every grid
    stage that is not fused, so `use_pallas_grid` changes nothing
    there."""
    if _use_fused_substep(cfg, scn):
        return "fused", "K2" if cfg.solver.preconditioner == "mg" else "K10"
    grid = "K7" if cfg.use_pallas_grid and not cfg.rainbow else "plain"
    if _use_fused_projection(cfg):
        return grid, "K9"
    return grid, solver_route(cfg)


def marker_route(cfg: SimConfig, scn: Scenario) -> str:
    """The marker pass of every substep: "G1+G2" in the global layout;
    in the slot layout "K5+K6" (unfused), "K4" (fused, on the persistent
    padded store) or "K1" (fused), as the JAX package picks them with
    `use_pallas_markers=True`: the padded store needs the fused pass's
    deferred alive plane, mono colour and no sources (JAX sim.py:
    327-334)."""
    if cfg.marker_layout != "slots":
        return "G1+G2"
    if not cfg.fuse_marker_pass:
        return "K5+K6"
    if cfg.marker_padded_store and not cfg.rainbow and scn.num_sources == 0:
        return "K4"
    return "K1"


def _colors(state: FluidState, fn):
    return state.replace(r=fn(state.r), g=fn(state.g), b=fn(state.b))


def substep(cfg: SimConfig, scn: Scenario, state: FluidState, dt, dt_proj,
            defer_alive: bool = False, active=None, marker_pass=None):
    """One CFL substep with dt chosen.  Returns (state, msq,
    pcg_iterations).  On the "K4" marker route `state.markers` is the
    padded store that `step_frame` keeps through the frame.  `active`
    False suppresses source emission (S1 updates the state's tensors in
    place; on the slot routes `step_frame` hands it tensors the frame
    owns).  `marker_pass`, when given, runs in place of the route's."""
    mroute = marker_route(cfg, scn)
    if marker_pass is not None:
        state = marker_pass(cfg, scn, state, dt, defer_alive=defer_alive)
    elif mroute == "G1+G2":
        state = get_marker_pass(cfg)(cfg, scn, state, dt)
    else:
        state = marker_pass_slots(cfg, scn, state, dt,
                                  defer_alive=defer_alive, route=mroute)
    if cfg.rainbow:
        # colours extrapolate before sources run (main.c:859-863)
        fluid, prev = state.fluid, state.prev_fluid
        state = _colors(state, lambda q: extrapolate(cfg, q, fluid, prev,
                                                     "p"))
    if scn.num_sources and mroute == "G1+G2":
        # the whole state is selected after this substep, the input's
        # tensors included: S1 gets its own copies of the ones the marker
        # pass did not make anew
        state = state.replace(**{
            name: getattr(state, name).clone()
            for name in ("r", "g", "b", "rng", "source_exhausted")})
        state = update_fluid_sources(cfg, scn, state, active)
    elif scn.num_sources:
        state = update_fluid_sources_slots(cfg, scn, state, active)
    # the grid stage sees the fluid mask after emission (main.c:289)
    fluid, prev, solid = state.fluid, state.prev_fluid, scn.solid

    proj = route(cfg, scn)[1]
    if proj == "K10":
        u2, v2, iters, _resid, msq = substep_kernel.project_substep_jacobi(
            cfg, dt, dt_proj, state.u, state.v, fluid, prev, solid)
        p2 = state.p  # the Jacobi speed mode never warm-starts
        return state.replace(u=u2, v=v2, p=p2), msq, iters
    if proj == "K2":
        u2, v2, iters, _resid, msq, p2 = substep_kernel.project_substep_mg(
            cfg, dt, dt_proj, state.u, state.v, fluid, prev, solid, state.p)
        return state.replace(u=u2, v=v2, p=p2), msq, iters

    ut, vt, *extrapolated = grid_kernel.grid_stage(
        cfg, state.u, state.v, fluid, prev, solid, dt,
        extrapolated=cfg.rainbow)
    if cfg.rainbow:
        uu, vv = extrapolated
        state = _colors(state, lambda q: advect_p(cfg, q, uu, vv, fluid, dt))
    if proj == "K9":
        u2, v2, iters, _resid, msq = pcg_kernel.project_jacobi(
            cfg, dt_proj, ut, vt, fluid, solid)
        # K9 does not give its pressure: a later warm start starts cold
        p2 = torch.zeros_like(state.p)
    else:
        u2, v2, info = project(cfg, dt_proj, ut, vt, fluid, solid,
                               p0=state.p)
        msq = max_speed_sq(cfg, u2, v2)
        # an f64 solve's pressure is carried in the state's dtype
        iters, p2 = info["iterations"], info["pressure"].to(state.p.dtype)
    return state.replace(u=u2, v=v2, p=p2), msq, iters


def _dt_from_msq(cfg: SimConfig, msq, frame_time):
    """calculate_timestep (main.c:834-841) from a precomputed maxsq."""
    # the f32 sqrt correctly rounded on either device (torch's vectorised
    # CPU sqrt is not): the f64 root rounded to f32 is
    max_velocity = torch.sqrt(msq.to(torch.float64)).to(frame_time.dtype)
    pos = max_velocity > 0.0
    # a tensor numerator: `float / tensor` is the tensor's reciprocal
    # times the float in torch, which rounds apart from the quotient (a
    # fill, not a copy from the host: no stream sync)
    max_distance = torch.full_like(max_velocity, cfg.cfl * cfg.side_length)
    dt = torch.where(pos, max_distance
                     / torch.where(pos, max_velocity, 1.0), torch.inf)
    return torch.minimum(dt, frame_time)


def _step_frame_impl(cfg: SimConfig, scn: Scenario, state: FluidState,
                     marker_pass=None, blocks=None):
    """One frame.  Returns (state, stats) with stats the device tensors
    `n_active` (active substeps), `pcg_iters` (PCG iterations summed
    over the active substeps) and `pcg_iters_max` (the most one active
    substep's solve took)."""
    check_slice(cfg, scn)
    f = state.u.dtype
    dev = state.u.device
    fast = cfg.marker_layout == "slots"
    if marker_pass is not None and not fast:
        raise ValueError("marker_pass replaces the slot layout's marker "
                         "pass; the global layout has none to replace")
    # only the fused slot passes (and a given one, JAX sim.py:266-269)
    # leave the alive plane to the frame's end
    defer_alive = fast and (cfg.fuse_marker_pass or marker_pass is not None
                            or blocks is not None)
    padded_store = (marker_route(cfg, scn) == "K4" and marker_pass is None
                    and blocks is None)
    speeds = max_speed_sq if blocks is None else blocks.max_speed_sq
    if padded_store:
        state = state.replace(markers=pad_slot_store(cfg, state.markers))
    if scn.num_sources and fast:
        # S1 writes in place: the frame takes its own copies of the fields
        # it would otherwise share with the caller's state (the marker
        # pass and the selects give fresh tensors for the rest)
        state = state.replace(**{
            name: getattr(state, name).clone()
            for name in ("r", "g", "b", "alive", "rng", "source_exhausted")})
    frame_time = torch.full((), cfg.frame_time, dtype=f, device=dev)
    msq = speeds(cfg, state.u, state.v)
    n_active = torch.zeros((), dtype=torch.int32, device=dev)
    pcg_iters = torch.zeros((), dtype=torch.int32, device=dev)
    pcg_iters_max = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(cfg.max_substeps):
        active = frame_time > 0.0
        # an inactive slot substep's dt = 0 makes the marker pass an
        # identity; the global layout marches with dt = 1 and selects the
        # whole state away (JAX sim.py:290-294)
        dt = torch.where(active, _dt_from_msq(cfg, msq, frame_time),
                         0.0 if fast else 1.0)
        dt_proj = torch.where(active, dt, torch.inf)
        if blocks is None:
            new, new_msq, iters = substep(
                cfg, scn, state, dt, dt_proj, defer_alive=defer_alive,
                active=active, marker_pass=marker_pass)
        else:
            new, new_msq, iters = blocks.substep(
                cfg, scn, state, dt, dt_proj, defer_alive=defer_alive,
                active=active)

        def sel(name):
            a, b = getattr(new, name), getattr(state, name)
            if a.dtype == torch.uint32:  # torch.where has no uint32 kernel
                return torch.where(active, a.to(torch.int64),
                                   b.to(torch.int64)).to(torch.uint32)
            return torch.where(active, a, b)

        if fast:
            keep = ["u", "v", "prev_marker_count", "p"]
            if cfg.rainbow or scn.num_sources:
                # the JAX package keeps them always; in mono without
                # sources they never change
                keep += ["r", "g", "b"]
        else:
            keep = [f.name for f in dataclasses.fields(FluidState)]
        state = new.replace(**{name: sel(name) for name in keep})
        msq = torch.where(active, new_msq, msq)
        frame_time = torch.where(active, frame_time - dt, frame_time)
        n_active = n_active + active.to(torch.int32)
        iters = torch.where(active, iters, 0)
        pcg_iters = pcg_iters + iters
        pcg_iters_max = torch.maximum(pcg_iters_max, iters)
    if padded_store:
        state = state.replace(markers=unpad_slot_store(cfg, state.markers))
    if defer_alive:
        state = state.replace(
            alive=live_slots(state.marker_count, cfg.slots_per_cell))
    state = state.replace(frame_count=state.frame_count + 1)
    diagnostics.check_frame(state)
    return state, {"n_active": n_active, "pcg_iters": pcg_iters,
                   "pcg_iters_max": pcg_iters_max}


def step_frame(cfg: SimConfig, scn: Scenario, state: FluidState,
               marker_pass=None, blocks=None) -> FluidState:
    """One frame; `marker_pass` replaces the slot layout's marker pass,
    `blocks` steps a block of the grid (see the top of this module)."""
    return _step_frame_impl(cfg, scn, state, marker_pass, blocks)[0]


def step_frame_stats(cfg: SimConfig, scn: Scenario, state: FluidState):
    """(state', stats): like step_frame, plus the active-substep and PCG
    iteration counts of the frame, and the most iterations one solve
    took (device tensors)."""
    return _step_frame_impl(cfg, scn, state)


def run_frames(cfg: SimConfig, scn: Scenario, state: FluidState, n: int):
    """Step `n` frames (benchmark / headless path)."""
    for _ in range(n):
        state = step_frame(cfg, scn, state)
    return state
