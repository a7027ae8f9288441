"""K12's plain version against the JAX package's `solve_pressure_stream`
(Pallas in interpret mode), and two frames of the K12 route.

  * the 128² dam-break system of tests/test_stream_pcg.py:14-21,
    converged (tol 1e-5, tol_rel 1e-5, 200 iterations): iterations within
    1, p within 5e-4 of its scale; at the speed-mode budget (100
    iterations, tol 1e-6, tol_rel 1e-6): the same iteration count and p
    within 2e-5 of its scale; the zero RHS: 0 iterations, resid 0;
  * 2 frames from the developed 64² dam break in the Jacobi speed mode
    with the K8, K9 and K10 gates off on both sides, so that the solve is
    K12: marker counts bitwise, drops equal, u/v atol 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.core.presets import dam_break as jdam_break
from euler_tpu.ops import project as jproject
from euler_tpu.ops.pallas import pcg_kernel as jpcg
from euler_tpu.ops.pallas import pcg_stream_kernel as jps
from euler_tpu.ops.pallas import substep_kernel as jsk
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu.sim import step_frame_jit
from euler_tpu_torch import convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import pcg_kernel as tpcg
from euler_tpu_torch.ops.cuda import pcg_stream_kernel as tps
from euler_tpu_torch.ops.cuda import substep_kernel as tsk

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


def _cfg(max_iterations, tol, tol_rel):
    return SimConfig(nx=128, ny=128, marker_layout="slots",
                     solver=SolverConfig(max_iterations=max_iterations,
                                         tol=tol, tol_rel=tol_rel,
                                         dtype="float32"))


CONVERGED = _cfg(200, 1e-5, 1e-5)
SPEED = _cfg(100, 1e-6, 1e-6)


@pytest.fixture(scope="module")
def system():
    """b, a_diag, fluid of the JAX dam break after 3 frames at 128², with
    dt 0.03 (tests/test_stream_pcg.py:14-21)."""
    jcfg = jax_config(CONVERGED, interpret=False)
    scn, st = jdam_break(jcfg)
    for _ in range(3):
        st = step_frame_jit(jcfg, scn, st)
    b = jproject.divergence_rhs(jcfg, st.u, st.v, st.fluid, jnp.float32(0.03))
    a = jproject.pressure_matrix_diag(jcfg, scn.solid, st.fluid)
    return tuple(np.asarray(x) for x in (b, a, st.fluid))


def _solve_both(cfg, b, a, fluid):
    got = tps.solve_pressure_stream(cfg, t(b), t(a), t(fluid))
    want = jps.solve_pressure_stream(
        jax_config(cfg, interpret=False), jnp.asarray(b), jnp.asarray(a),
        jnp.asarray(fluid), True)
    return got, want


def test_converged_matches_pallas(system):
    (p, it, res), (jp, jit_, jres) = _solve_both(CONVERGED, *system)
    tol = max(1e-5, 1e-5 * float(np.abs(system[0]).max()))
    assert float(res) <= tol and float(jres) <= tol
    assert abs(int(it) - int(jit_)) <= 1
    scale = float(np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=5e-4 * scale,
                               rtol=0)


def test_speed_budget_matches_pallas(system):
    (p, it, res), (jp, jit_, jres) = _solve_both(SPEED, *system)
    assert int(it) == int(jit_)
    scale = float(np.abs(np.asarray(jp)).max())
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=2e-5 * scale,
                               rtol=0)


def test_zero_rhs_exits_at_once(system):
    _, a, fluid = system
    (p, it, res), (jp, jit_, jres) = _solve_both(
        SPEED, np.zeros_like(system[0]), a, fluid)
    assert int(it) == int(jit_) == 0
    assert float(res) == float(jres) == 0.0
    assert not p.any() and not np.asarray(jp).any()


def test_wrapper_takes_plain_version_on_cpu(system):
    b, a, fluid = (t(x) for x in system)
    before = _build.PLAIN_CALLS["K12"]
    got = tps.solve_pressure_stream(SPEED, b, a, fluid)
    want = tps.solve_pressure_stream_plain(SPEED, b, a, fluid)
    assert _build.PLAIN_CALLS["K12"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


FRAMES = 2


@pytest.fixture(scope="module")
def k12_frames():
    """2 frames of the 64² speed mode with K8, K9 and K10 gated off on
    both sides (traced afresh: the gates are read while tracing)."""
    cfg = speed_config(64)
    jcfg = dataclasses.replace(jax_config(cfg), use_pallas_markers=False)
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    out = []
    with pytest.MonkeyPatch.context() as mp, pallas_interpret():
        for mod in (tpcg, jpcg):
            mp.setattr(mod, "pallas_solver_fits", lambda c: False)
            mp.setattr(mod, "fused_projection_fits", lambda c: False)
        for mod in (tsk, jsk):
            mp.setattr(mod, "substep_jacobi_fused_fits", lambda c: False)
        assert sim.route(cfg, scn) == ("plain", "K12")
        jax.clear_caches()
        step = jax.jit(jstep_frame, static_argnums=0)
        plain0 = dict(_build.PLAIN_CALLS)
        for _ in range(FRAMES):
            st, stats = sim.step_frame_stats(cfg, scn, st)
            jst = step(jcfg, jscn, jst)
            out.append((convert.state_to_numpy(st), jst, stats))
        calls = {k: _build.PLAIN_CALLS[k] - plain0.get(k, 0)
                 for k in ("K8", "K9", "K10", "K12")}
    jax.clear_caches()
    return cfg, out, calls


def test_route_ran_k12(k12_frames):
    _, _, calls = k12_frames
    assert calls["K12"] > 0
    assert calls["K8"] == calls["K9"] == calls["K10"] == 0


@pytest.mark.parametrize("frame", range(FRAMES))
def test_k12_frames_match_jax(k12_frames, frame):
    cfg, out, _ = k12_frames
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
