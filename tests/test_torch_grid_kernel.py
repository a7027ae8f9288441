"""K7's plain version against the JAX package's `grid_stage_pallas`
(Pallas in interpret mode), and two frames of the K7 route.

  * the 64² system of tests/test_pallas_grid.py:15-42 (a dam break 4
    frames in): ut/vt atol 2e-4;
  * 2 frames from the developed 64² dam break in the unfused Jacobi mode
    with `use_pallas_grid=True` (K7, then K8 through `project()`): marker
    counts bitwise, drops equal, u/v atol 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.core.presets import dam_break as jdam_break
from euler_tpu.ops.pallas.grid_kernel import grid_stage_pallas
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu.sim import step_frame_jit
from euler_tpu_torch import convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import grid_kernel as k7

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    pallas_interpret,
    port_state,
    speed_config,
    t,
)

CFG = SimConfig(nx=64, ny=64, marker_layout="slots",
                solver=SolverConfig(max_iterations=60, dtype="float32"))


@pytest.fixture(scope="module")
def system():
    """u, v, fluid, prev_fluid, solid of tests/test_pallas_grid.py's
    state."""
    jcfg = jax_config(CFG, interpret=False)
    scn, st = jdam_break(jcfg)
    for _ in range(4):
        st = step_frame_jit(jcfg, scn, st)
    return tuple(np.asarray(x) for x in (st.u, st.v, st.fluid,
                                         st.prev_fluid, scn.solid))


def test_plain_matches_pallas(system):
    dt = np.float32(0.03)
    ut, vt = k7.grid_stage(CFG, *(t(x) for x in system), torch.tensor(dt))
    jut, jvt = grid_stage_pallas(jax_config(CFG, interpret=False),
                                 *(jnp.asarray(x) for x in system),
                                 jnp.float32(dt), True)
    np.testing.assert_allclose(n(ut), np.asarray(jut), atol=2e-4, rtol=0)
    np.testing.assert_allclose(n(vt), np.asarray(jvt), atol=2e-4, rtol=0)


def test_wrapper_takes_plain_version_on_cpu(system):
    args = tuple(t(x) for x in system)
    dt = torch.tensor(0.03)
    before = _build.PLAIN_CALLS["K7"]
    got = k7.grid_stage(CFG, *args, dt)
    u, v, fluid, prev, solid = args
    want = k7.grid_stage_plain(CFG, dt, u, v, fluid, prev, solid)
    assert _build.PLAIN_CALLS["K7"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


FRAMES = 2


@pytest.fixture(scope="module")
def k7_frames():
    cfg = speed_config(64, use_pallas_grid=True)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, fuse_projection=False))
    jcfg = dataclasses.replace(jax_config(cfg), use_pallas_markers=False)
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    assert sim.route(cfg, scn) == ("K7", "K8")
    out = []
    with pallas_interpret():
        step = jax.jit(jstep_frame, static_argnums=0)
        plain0 = _build.PLAIN_CALLS["K7"]
        for _ in range(FRAMES):
            st, stats = sim.step_frame_stats(cfg, scn, st)
            jst = step(jcfg, jscn, jst)
            out.append((convert.state_to_numpy(st), jst, stats))
        calls = _build.PLAIN_CALLS["K7"] - plain0
    return cfg, out, calls


def test_route_ran_k7(k7_frames):
    cfg, _, calls = k7_frames
    assert calls == FRAMES * cfg.max_substeps


@pytest.mark.parametrize("frame", range(FRAMES))
def test_k7_frames_match_jax(k7_frames, frame):
    cfg, out, _ = k7_frames
    got, jst, stats = out[frame]
    np.testing.assert_array_equal(got["marker_count"],
                                  np.asarray(jst.marker_count))
    assert int(got["dropped_markers"]) == int(jst.dropped_markers)
    for name in ("u", "v"):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], np.asarray(getattr(jst, name)),
                                   atol=5e-3, rtol=0, err_msg=name)
    assert 1 <= int(stats["n_active"]) <= cfg.max_substeps
    assert int(stats["pcg_iters"]) > 0
