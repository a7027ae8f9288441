"""Shared pieces of the port's parity tests (tests/test_torch_*.py): the
main-path configuration on both sides, a developed dam-break state made
by the port from a seed, and numpy handover between the two packages.

JAX runs on the CPU here (tests/conftest.py); Pallas kernels run in
interpret mode, as the JAX package's own tests run them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu import config as jconfig
from euler_tpu.core import state as jstate
from euler_tpu_torch import convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import block_obstacles, dam_break
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.markers_slots import live_slots

# 64²-sized tensors gain nothing from intra-op threads, and the test run
# shares the host's cores between several worker processes
torch.set_num_threads(1)


def port_config(size: int = 64, warm: bool = True, **over) -> SimConfig:
    """bench.py's main path at `size`: slots K=8, Galerkin MG-PCG to
    tol_rel 1e-4, warm start, fused projection."""
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, dtype="float32",
                            tol_rel=1e-4, preconditioner="mg",
                            warm_start=warm, fuse_projection=True),
        **over)


def speed_config(size: int = 64, **over) -> SimConfig:
    """`bench.py --precon jacobi` at `size`: the Jacobi speed mode, 100
    iterations, tol 1e-6, tol_rel 1e-6, no warm start."""
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, tol=1e-6, tol_rel=1e-6,
                            dtype="float32", preconditioner="jacobi",
                            warm_start=False, fuse_projection=True),
        **over)


def jax_config(cfg: SimConfig, interpret: bool = True):
    """The JAX config with the same field values; `interpret` also turns
    on the Pallas routes (fused marker pass, Pallas solvers) in interpret
    mode, keeping the port's `fuse_projection`."""
    solver = jconfig.SolverConfig(**dataclasses.asdict(cfg.solver))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "solver"}
    jcfg = jconfig.SimConfig(**fields, solver=solver)
    if interpret:
        jcfg = dataclasses.replace(
            jcfg, use_pallas_markers=True, pallas_interpret=True,
            solver=dataclasses.replace(jcfg.solver, use_pallas=True,
                                       pallas_interpret=True))
    return jcfg


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas kernels that its projection and
    substep call without an `interpret` argument (`solve_pressure_pallas`,
    `project_pallas`, `solve_pressure_mg_pallas`,
    `solve_pressure_mg_stream`, `solve_pressure_stream`,
    `grid_stage_pallas`) in interpret mode, the only mode Pallas has on
    the CPU, as the JAX tests run them."""
    from euler_tpu.ops.pallas import (
        grid_kernel,
        mg_kernel,
        mg_stream_kernel,
        pcg_kernel,
        pcg_stream_kernel,
    )

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((pcg_kernel, "solve_pressure_pallas"),
                          (pcg_kernel, "project_pallas"),
                          (mg_kernel, "solve_pressure_mg_pallas"),
                          (mg_stream_kernel, "solve_pressure_mg_stream"),
                          (pcg_stream_kernel, "solve_pressure_stream"),
                          (grid_kernel, "grid_stage_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    interpret=True))
        yield


@functools.lru_cache(maxsize=None)
def developed_numpy(size: int = 64, frames: int = 4, seed: int = 0):
    """(scenario, state) numpy dicts of the dam break advanced `frames`
    frames by the port on the CPU (deterministic from the seed)."""
    cfg = port_config(size)
    scn, st = dam_break(cfg, seed=seed, device="cpu")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    return convert.scenario_to_numpy(scn), convert.state_to_numpy(st)


@functools.lru_cache(maxsize=None)
def obstacles_numpy(size: int = 64, frames: int = 3, seed: int = 1):
    """(scenario, state) numpy dicts of the block-obstacles preset
    advanced `frames` frames by the port on the CPU."""
    cfg = port_config(size)
    scn, st = block_obstacles(cfg, seed=seed, device="cpu")
    for _ in range(frames):
        st = sim.step_frame(cfg, scn, st)
    return convert.scenario_to_numpy(scn), convert.state_to_numpy(st)


def scenario_numpy(scenario: str):
    """The developed 64² "dam_break" or "block_obstacles" numpy dicts."""
    return developed_numpy(64) if scenario == "dam_break" else \
        obstacles_numpy(64)


def cfl_dt(cfg, st):
    """The CFL dt of a substep on `st` (the frame loop's first)."""
    frame_time = torch.tensor(cfg.frame_time)
    return sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v), frame_time)


def assert_live_close(cfg, got, want, count, atol=1e-4):
    """[2K, Y, X] stores agree within atol on the live slots of `count`,
    and `got` is zero on the others."""
    K = cfg.slots_per_cell
    live = np.concatenate([n(live_slots(torch.as_tensor(count), K))] * 2)
    np.testing.assert_allclose(got[live], want[live], atol=atol, rtol=0)
    assert not got[~live].any()


def port_state(arrays):
    """(scenario, state) of the port from numpy dicts."""
    scn_np, st_np = arrays
    return (convert.scenario_from_numpy(scn_np, device="cpu"),
            convert.state_from_numpy(st_np, device="cpu"))


def jax_state(arrays):
    """(scenario, state) of the JAX package from numpy dicts."""
    scn_np, st_np = arrays
    scn = jstate.Scenario(**{k: jnp.asarray(v) for k, v in scn_np.items()})
    st = jstate.FluidState(**{k: jnp.asarray(v) for k, v in st_np.items()})
    return scn, st


def t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor."""
    return torch.as_tensor(np.array(a))


def n(a) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def jax_frames(cfg: SimConfig, scn, st, frames: int) -> dict:
    """JAX `step_frame_jit` `frames` times from the port's (scn, st), its
    marker pass on the jnp path (bitwise its Pallas pass) and its solve
    on the jnp `pcg_loop` (as the JAX package's sharded frames solve);
    the state as numpy (flat layout)."""
    from euler_tpu.sim import step_frame_jit

    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)
    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    for _ in range(frames):
        jst = step_frame_jit(jcfg, jscn, jst)
    return {f.name: np.asarray(getattr(jst, f.name))
            for f in dataclasses.fields(jst)}


# how far rainbow colours may stray from the JAX package's
# (tests/test_torch_sim_routes.py's rainbow tolerance)
COLOR_ATOL = 5e-3


def assert_frame(cfg: SimConfig, got: dict, want: dict,
                 atol: float = 1e-5) -> None:
    """A frame on blocks against JAX's (numpy dicts of the flat layout,
    one instance): marker counts, the alive plane (the global layout's
    alive mask, in marker order), alive_count, the drops and the RNG
    equal; u and v within `atol` (1e-5; the converged MG frames 2e-3);
    live marker positions within 1e-4 (XLA contracts the JAX march's
    products into FMAs on the CPU); with `cfg.rainbow` r, g and b within
    COLOR_ATOL."""
    for name in ("marker_count", "alive", "alive_count", "dropped_markers",
                 "frame_count"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_array_equal(got["rng"].astype(np.int64),
                                  want["rng"].astype(np.int64))
    for name in ("u", "v"):
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=0,
                                   err_msg=name)
    if cfg.rainbow:
        for name in ("r", "g", "b"):
            np.testing.assert_allclose(got[name], want[name],
                                       atol=COLOR_ATOL, rtol=0, err_msg=name)
    if cfg.marker_layout != "slots":
        live = want["alive"]
        np.testing.assert_allclose(got["markers"][:, live],
                                   want["markers"][:, live], atol=1e-4,
                                   rtol=0, err_msg="markers")
        return
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    assert_live_close(cfg, got["markers"].reshape(2 * K, Y, X),
                      want["markers"].reshape(2 * K, Y, X),
                      got["marker_count"])


def block_frames(cfg: SimConfig, scn, st, y: int, x: int,
                 frames: int) -> dict:
    """`spatial.make_block_step` on y x x in-process blocks
    (`comm.LocalGroup`) of (scn, st), `frames` frames; the whole state
    as numpy (flat layout)."""
    from euler_tpu_torch.parallel import spatial
    from euler_tpu_torch.parallel.comm import LocalGroup

    def rank(comm):
        step = spatial.make_block_step(cfg, comm)
        bscn, b = spatial.shard_blocks(cfg, comm, scn, st)
        for _ in range(frames):
            b = step(bscn, b)
        return spatial.gather_blocks(cfg, comm, b)

    with LocalGroup(y, x, device="cpu") as g:
        return convert.state_to_numpy(g.run(rank)[0])
