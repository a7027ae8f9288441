"""K11's plain version against the JAX package's `solve_pressure_mg_stream`
(Pallas in interpret mode), and two frames of the K11 route.

  * the 128² dam-break system of tests/test_stream_mg.py:18-31 (F = 2),
    the same with the root forced two levels down (F = 4, :75-97), the
    zero RHS and the 128x256 speckled mask (:100-135): iterations within
    1, p within 5e-4 of its scale;
  * the CUDA solve's operands (`stream_host_operands`) against the JAX
    hierarchy and Chebyshev rows;
  * 2 frames from the developed 128² dam break with the fused-substep
    and resident-MG gates off on both sides, so that the solve is K11:
    marker counts bitwise, drops equal, u/v atol 5e-3, p 5e-4 of scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.core.presets import dam_break as jdam_break
from euler_tpu.ops import multigrid as jmultigrid
from euler_tpu.ops import project as jproject
from euler_tpu.ops.forces import calculate_timestep
from euler_tpu.ops.pallas import mg_kernel as jmgk
from euler_tpu.ops.pallas import mg_stream_kernel as jms
from euler_tpu.ops.pallas import substep_kernel as jsk
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu.sim import step_frame_jit
from euler_tpu_torch import convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.cuda import mg_stream_kernel as tms
from euler_tpu_torch.ops.cuda import substep_kernel as tsk
from euler_tpu_torch.ops.project import pressure_matrix_diag

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    pallas_interpret,
    port_config,
    port_state,
    t,
)


def _cfg(Y=128, X=128, **over):
    """tests/test_stream_mg.py's solver: MG, tol 1e-6, tol_rel 1e-4."""
    solver = dict(max_iterations=100, tol=1e-6, tol_rel=1e-4,
                  dtype="float32", preconditioner="mg")
    return SimConfig(nx=X, ny=Y, marker_layout="slots",
                     solver=SolverConfig(**{**solver, **over}))


@pytest.fixture(scope="module")
def dam_system():
    """b, a_diag, fluid, solid of the JAX dam break after 3 frames at
    128² (tests/test_stream_mg.py:18-31)."""
    jcfg = jax_config(_cfg(), interpret=False)
    scn, st = jdam_break(jcfg)
    for _ in range(3):
        st = step_frame_jit(jcfg, scn, st)
    dt = calculate_timestep(jcfg, st.u, st.v, jnp.float32(jcfg.frame_time))
    b = jproject.divergence_rhs(jcfg, st.u, st.v, st.fluid, dt)
    a = jproject.pressure_matrix_diag(jcfg, scn.solid, st.fluid)
    return tuple(np.asarray(x) for x in (b, a, st.fluid, scn.solid))


@pytest.fixture(scope="module")
def speckled_system():
    """The 128x256 speckled mask of tests/test_stream_mg.py:100-135."""
    rng = np.random.default_rng(7)
    Y, X = 128, 256
    fluid = np.zeros((Y, X), bool)
    fluid[1:-1, 1:-1] = True
    fluid &= rng.random((Y, X)) > 0.2
    fluid[Y // 2:, :] = False
    solid = np.zeros((Y, X), bool)
    solid[10:12, 5:-5] = True
    fluid &= ~solid
    b = rng.standard_normal((Y, X)).astype(np.float32) * fluid
    a = n(pressure_matrix_diag(_cfg(Y, X), t(solid), t(fluid)))
    return b, a, fluid, solid


def _solve_both(cfg, b, a, fluid, solid):
    got = tms.solve_pressure_mg_stream(cfg, t(b), t(a), t(fluid))
    want = jms.solve_pressure_mg_stream(
        jax_config(cfg, interpret=False), jnp.asarray(b), jnp.asarray(a),
        jnp.asarray(fluid), jnp.asarray(solid), True)
    return got, want


def _check(cfg, b, got, want):
    (p, it, res), (jp, jit_, jres) = got, want
    scale = float(np.abs(np.asarray(jp)).max())
    assert scale > 0
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=5e-4 * scale,
                               rtol=0)
    assert abs(int(it) - int(jit_)) <= 1
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * float(np.abs(b).max()))
    assert float(res) <= tol and float(jres) <= tol


def test_f2_matches_pallas(dam_system):
    cfg = _cfg()
    assert tms._root(cfg)[2] == 2
    _check(cfg, dam_system[0], *_solve_both(cfg, *dam_system))


def test_f4_matches_pallas(dam_system, monkeypatch):
    """The root two levels down on both sides (the 4096² transfer); a
    distinct static config keeps the JAX jit cache from reusing F = 2."""
    cfg = _cfg(max_iterations=99)
    monkeypatch.setattr(tms, "_resident_start", lambda shapes: 2)
    monkeypatch.setattr(jms, "_resident_start", lambda shapes: 2)
    assert tms._root(cfg)[2] == 4
    _check(cfg, dam_system[0], *_solve_both(cfg, *dam_system))


def test_speckled_rectangle_matches_pallas(speckled_system):
    cfg = _cfg(128, 256)
    assert tms.stream_mg_fits(cfg)
    _check(cfg, speckled_system[0], *_solve_both(cfg, *speckled_system))


def test_zero_rhs_exits_at_once(dam_system):
    b, a, fluid, solid = dam_system
    (p, it, res), (jp, jit_, jres) = _solve_both(_cfg(), np.zeros_like(b),
                                                 a, fluid, solid)
    assert int(it) == int(jit_) == 0
    assert float(res) == float(jres) == 0.0
    assert not p.any() and not np.asarray(jp).any()


def test_host_operands_match_jax(dam_system):
    """The resident levels' shapes and planes, their Chebyshev rows (K3's
    rows from the root down) and the fine level's 1/theta."""
    b, a, fluid, _ = dam_system
    cfg = _cfg()
    F, shapes, packed0, planes, rows = tms.stream_host_operands(
        cfg, t(a), t(fluid))
    jcfg = jax_config(cfg, interpret=False)
    jshapes, _, jpacked0, _, jrows, _, _ = jmgk.mg_host_operands(
        jcfg, jnp.asarray(a), jnp.asarray(fluid))
    ls = jms._resident_start(jshapes)
    assert F == 2 and shapes == [tuple(s) for s in jshapes[ls:]]
    np.testing.assert_array_equal(n(packed0), np.asarray(jpacked0))
    jlevels = jmultigrid.build_galerkin_hierarchy(
        jnp.asarray(a), jnp.asarray(fluid), jnp.float32)
    for cen, lv in zip(planes, jlevels[ls:]):
        for got, name in zip(cen, "cen"):
            np.testing.assert_array_equal(n(got), np.asarray(getattr(lv,
                                                                     name)))
    np.testing.assert_allclose(n(rows[:-1]), np.asarray(jrows)[ls:],
                               rtol=1e-6)
    it0, _ = jmultigrid.cheby_coefficients(
        jlevels[0].lmax.astype(jnp.float32), 1, cfg.solver.mg_cheby_ratio)
    np.testing.assert_allclose(float(rows[-1, 0]), float(it0), rtol=1e-6)
    assert not n(rows[-1, 1:]).any()


def test_wrapper_takes_plain_version_on_cpu(dam_system):
    b, a, fluid, _ = dam_system
    cfg = _cfg()
    before = _build.PLAIN_CALLS["K11"]
    got = tms.solve_pressure_mg_stream(cfg, t(b), t(a), t(fluid))
    want = tms.solve_pressure_mg_stream_plain(cfg, t(b), t(a), t(fluid))
    assert _build.PLAIN_CALLS["K11"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


FRAMES = 2


@pytest.fixture(scope="module")
def k11_frames():
    """2 frames of the 128² main-path config with K2 and K3 gated off on
    both sides (traced afresh: the gates are read while tracing)."""
    cfg = port_config(128)
    jcfg = dataclasses.replace(jax_config(cfg), use_pallas_markers=False)
    scn, st = port_state(developed_numpy(128))
    jscn, jst = jax_state(developed_numpy(128))
    out = []
    with pytest.MonkeyPatch.context() as mp, pallas_interpret():
        for mod in (tsk, jsk):
            mp.setattr(mod, "substep_fused_fits", lambda c: False)
        for mod in (tmgk, jmgk):
            mp.setattr(mod, "mg_pallas_fits", lambda c: False)
        assert sim.route(cfg, scn) == ("plain", "K11")
        jax.clear_caches()
        step = jax.jit(jstep_frame, static_argnums=0)
        plain0 = dict(_build.PLAIN_CALLS)
        for _ in range(FRAMES):
            st, stats = sim.step_frame_stats(cfg, scn, st)
            jst = step(jcfg, jscn, jst)
            out.append((convert.state_to_numpy(st), jst, stats))
        calls = {k: _build.PLAIN_CALLS[k] - plain0.get(k, 0)
                 for k in ("K2", "K3", "K11")}
    jax.clear_caches()
    return cfg, out, calls


def test_route_ran_k11(k11_frames):
    _, _, calls = k11_frames
    assert calls["K11"] > 0 and calls["K2"] == calls["K3"] == 0


@pytest.mark.parametrize("frame", range(FRAMES))
def test_k11_frames_match_jax(k11_frames, frame):
    cfg, out, _ = k11_frames
    got, jst, stats = out[frame]
    np.testing.assert_array_equal(got["marker_count"],
                                  np.asarray(jst.marker_count))
    assert int(got["dropped_markers"]) == int(jst.dropped_markers)
    for name in ("u", "v"):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], np.asarray(getattr(jst, name)),
                                   atol=5e-3, rtol=0, err_msg=name)
    jp = np.asarray(jst.p)
    scale = max(1.0, float(np.abs(jp).max()))
    np.testing.assert_allclose(got["p"], jp, atol=5e-4 * scale, rtol=0)
    assert 1 <= int(stats["n_active"]) <= cfg.max_substeps
    assert int(stats["pcg_iters"]) > 0
