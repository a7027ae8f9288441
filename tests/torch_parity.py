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
from euler_tpu_torch.core.presets import dam_break

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
