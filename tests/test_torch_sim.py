"""The port's frame loop against the JAX package's main path (fused
marker pass + fused substep, Pallas in interpret mode), 2 frames of the
64² dam break: marker counts bitwise, velocities atol 5e-3, dropped
markers equal (tests/test_substep_fused.py:118-146).  And the slice
guard: configurations the port does not run raise.  The other routes
(Jacobi, rainbow, unfused) are in test_torch_sim_routes.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from euler_tpu.core.presets import dam_break as jdam_break
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import convert, sim
from euler_tpu_torch.core.presets import dam_break

from torch_parity import jax_config, n, port_config

FRAMES = 2


@pytest.fixture(scope="module")
def frames():
    cfg = port_config(64)
    jcfg = jax_config(cfg)
    scn, st = dam_break(cfg, device="cpu")
    jscn, jst = jdam_break(jcfg)
    step = jax.jit(jstep_frame, static_argnums=0)
    out = []
    for _ in range(FRAMES):
        st, stats = sim.step_frame_stats(cfg, scn, st)
        jst = step(jcfg, jscn, jst)
        out.append((convert.state_to_numpy(st), jst, stats))
    return out


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frames_match_jax_main_path(frames, frame):
    got, jst, stats = frames[frame]
    np.testing.assert_array_equal(got["marker_count"],
                                  np.asarray(jst.marker_count))
    np.testing.assert_array_equal(got["alive"], np.asarray(jst.alive))
    np.testing.assert_allclose(got["u"], np.asarray(jst.u), atol=5e-3,
                               rtol=0)
    np.testing.assert_allclose(got["v"], np.asarray(jst.v), atol=5e-3,
                               rtol=0)
    assert int(got["dropped_markers"]) == int(jst.dropped_markers)
    assert int(got["frame_count"]) == int(jst.frame_count) == frame + 1
    scale = max(1.0, float(np.abs(np.asarray(jst.p)).max()))
    np.testing.assert_allclose(got["p"], np.asarray(jst.p),
                               atol=5e-4 * scale, rtol=0)
    assert 1 <= int(stats["n_active"]) <= 8
    assert int(stats["pcg_iters"]) > 0


def test_run_frames_is_step_frame_repeated():
    cfg = port_config(32)
    scn, st = dam_break(cfg, device="cpu")
    a = sim.run_frames(cfg, scn, st, 2)
    b = sim.step_frame(cfg, scn, sim.step_frame(cfg, scn, st))
    for k, v in convert.state_to_numpy(a).items():
        np.testing.assert_array_equal(v, convert.state_to_numpy(b)[k])


def _outside(kind):
    cfg = port_config(64)
    s = cfg.solver
    if kind == "global":
        return dataclasses.replace(cfg, marker_layout="global")
    if kind == "rediscretize":
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            s, mg_scheme="rediscretize"))
    if kind == "rbgs":
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            s, mg_smoother="rbgs"))
    if kind == "f64":
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            s, dtype="float64"))
    if kind == "frame_hierarchy":
        return dataclasses.replace(cfg, solver=dataclasses.replace(
            s, mg_frame_hierarchy=True))
    if kind == "odd_levels":
        return dataclasses.replace(cfg, nx=90, ny=90)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        s, preconditioner=kind))


@pytest.mark.parametrize("kind", ["global", "rediscretize", "rbgs", "ic0",
                                  "none", "f64", "frame_hierarchy",
                                  "odd_levels"])
def test_outside_the_slice_raises(kind):
    """What the port does not run raises, naming its ROADMAP item; the
    global layout, IC(0), the unpreconditioned solve, MG whose levels do
    not halve evenly (90², P3), f64 MG (P3, M15 part a), RB-GS MG (P3) and
    rediscretized MG (P7, M14 part a) run now (they raised until the port
    had them): a frame each, finite, the solve on P1, P3 or P7 (their
    plain versions here)."""
    cfg = _outside(kind)
    if kind in ("global", "odd_levels"):
        scn, st = dam_break(cfg, device="cpu")
    else:
        scn, st = dam_break(port_config(64), device="cpu")
    solves = {"ic0": "P1", "none": "P1", "odd_levels": "P3", "f64": "P3",
              "rbgs": "P3", "rediscretize": "P7"}
    if kind == "global" or kind in solves:
        if kind != "global":
            assert sim.route(cfg, scn) == ("plain", solves[kind])
        new, stats = sim.step_frame_stats(cfg, scn, st)
        assert int(new.frame_count) == 1
        assert bool(torch.isfinite(new.u).all())
        assert new.markers.shape == st.markers.shape
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.step_frame(cfg, scn, st)


def test_sources_raise():
    """Sources no longer raise (they did until the port had source
    emission): a dam break with one source cell runs and emits there,
    the unfused route taking it, while cfl > 1 still raises."""
    cfg = port_config(64)
    scn, st = dam_break(cfg, device="cpu")
    source = torch.zeros_like(scn.source)
    source[40, 20] = True
    scn = dataclasses.replace(
        scn, source=source,
        source_yx=torch.tensor([[40, 20]], dtype=torch.int32),
        source_valid=torch.tensor([True]))
    assert sim.route(cfg, scn) == ("plain", "K3")
    st1 = sim.step_frame(cfg, scn, st)
    assert int(st.marker_count[40, 20]) == 0
    assert int(st1.marker_count[40, 20]) > 0 or int(st1.marker_count[
        39:42, 19:22].sum()) > 0
    assert not torch.equal(st1.rng, st.rng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.step_frame(dataclasses.replace(cfg, cfl=2.0), scn, st)


def test_inactive_substeps_keep_state():
    """A frame whose CFL dt covers the frame in one substep runs 7
    inactive substeps; the pressure carry and counts survive them."""
    cfg = port_config(32)
    scn, st = dam_break(cfg, device="cpu")
    st1, stats = sim.step_frame_stats(cfg, scn, st)
    assert int(stats["n_active"]) == 1  # still fluid: dt = frame_time
    assert n(st1.p).any()
    assert torch.equal(st1.alive, torch.arange(cfg.slots_per_cell)[
        :, None, None] < st1.marker_count[None])
