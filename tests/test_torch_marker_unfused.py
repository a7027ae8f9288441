"""The unfused marker pass (`fuse_marker_pass=False`: K5, then K6)
against the JAX package, on the developed 64² dam break and block
obstacles, with dt x 1.5 so that markers collide and cross cells:

  * K5's plain version against the Pallas march `advect_markers_pallas`
    in interpret mode (live slots atol 1e-4, tests/test_pallas_markers.py:
    22-47) and against the jnp `advect_markers_slots` on every slot;
  * K6's plain version against the Pallas re-bin `rebin_markers_pallas`
    in interpret mode, fed the same numpy inputs: positions, alive plane,
    counts and drops bitwise;
  * the route: 2 frames through `sim.step_frame` equal to the port's own
    K1 route in every field, and against the JAX `step_frame` with the
    same switches (its marker pass as jnp ops, its solvers' Pallas
    kernels in interpret mode): counts and alive bitwise, drops equal,
    u/v atol 5e-3, p atol 5e-4 of scale (tests/test_substep_fused.py:
    118-146).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import markers_slots as jms
from euler_tpu.ops.pallas.marker_kernel import advect_markers_pallas
from euler_tpu.ops.pallas.rebin_kernel import rebin_markers_pallas
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import convert, sim
from euler_tpu_torch.ops import markers_slots as tms
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import marker_kernel as k5
from euler_tpu_torch.ops.cuda import rebin_kernel as k6

from torch_parity import (
    cfl_dt,
    developed_numpy,
    jax_config,
    jax_state,
    n,
    pallas_interpret,
    port_config,
    port_state,
    scenario_numpy,
)

SCENARIOS = ["dam_break", "block_obstacles"]
FRAMES = 2


def _config():
    return port_config(64, fuse_marker_pass=False)


def _inputs(scenario):
    """(cfg, port scenario and state, JAX scenario and state, dt x 1.5)."""
    cfg = _config()
    scn, st = port_state(scenario_numpy(scenario))
    jscn, jst = jax_state(scenario_numpy(scenario))
    return cfg, scn, st, jscn, jst, cfl_dt(cfg, st) * 1.5


def _march(cfg, scn, st, dt):
    return k5.advect_markers(cfg, st.u, st.v, st.fluid, scn.solid,
                             st.markers[0], st.markers[1], dt,
                             st.marker_count)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_march_matches_pallas_kernel(scenario):
    cfg, scn, st, jscn, jst, dt = _inputs(scenario)
    jcfg = jax_config(cfg)
    before = _build.PLAIN_CALLS["K5"]
    opx, opy = _march(cfg, scn, st, dt)
    assert _build.PLAIN_CALLS["K5"] == before + 1
    jpx, jpy, _ = jms.slot_views(jcfg, jst)
    want = advect_markers_pallas(
        jcfg, jst.u, jst.v, jst.fluid, jscn.solid, jpx, jpy,
        jnp.float32(float(dt)), jst.marker_count, True)
    live = n(st.alive)
    assert np.array_equal(live, n(tms.live_slots(st.marker_count, 8)))
    for got, w in zip((opx, opy), want):
        np.testing.assert_allclose(n(got)[live], np.asarray(w)[live],
                                   atol=1e-4, rtol=0)
    # dead slots keep their position; live ones moved
    for got, was in ((opx, st.markers[0]), (opy, st.markers[1])):
        assert torch.equal(got[~st.alive], was[~st.alive])
    moved = (opx != st.markers[0]) | (opy != st.markers[1])
    assert n(moved)[live].any()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_state_march_matches_jnp_on_every_slot(scenario):
    cfg, scn, st, jscn, jst, dt = _inputs(scenario)
    got = tms.advect_markers_slots(cfg, scn, st, dt)
    want = jms.advect_markers_slots(jax_config(cfg, interpret=False), jscn,
                                    jst, jnp.float32(float(dt)))
    np.testing.assert_allclose(
        convert.state_to_numpy(got)["markers"], np.asarray(want.markers),
        atol=1e-4, rtol=0)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_rebin_matches_pallas_kernel(scenario):
    """Fed the same numpy inputs: the marched store, the alive plane and
    the dead plane, all bitwise."""
    cfg, scn, st, jscn, jst, dt = _inputs(scenario)
    px, py = (n(a) for a in _march(cfg, scn, st, dt))
    alive, dead = n(st.alive), n(scn.sink | scn.solid)
    before = _build.PLAIN_CALLS["K6"]
    got = k6.rebin_markers(cfg, torch.as_tensor(px), torch.as_tensor(py),
                           torch.as_tensor(alive), torch.as_tensor(dead))
    assert _build.PLAIN_CALLS["K6"] == before + 1
    opx, opy, ova, count, drop = rebin_markers_pallas(
        jax_config(cfg), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(alive.astype(np.float32)),
        jnp.asarray(dead.astype(np.float32)), True)
    want = (opx, opy, np.asarray(ova) != 0, count, drop)
    for name, a, b in zip(("px", "py", "alive", "count", "drop"), got,
                          want):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    assert (n(got[3]) != n(st.marker_count)).any()  # markers crossed cells


def test_zero_dt_is_identity():
    cfg = _config()
    scn, st = port_state(developed_numpy(64))
    opx, opy = _march(cfg, scn, st, torch.tensor(0.0))
    assert torch.equal(opx, st.markers[0]) and torch.equal(opy, st.markers[1])
    px, py, alive, count, drop = k6.rebin_markers(
        cfg, opx, opy, st.alive, scn.sink | scn.solid)
    assert torch.equal(torch.stack([px, py]), st.markers)
    assert torch.equal(alive, st.alive)
    assert torch.equal(count, st.marker_count)
    assert not drop.any()


def _frames(cfg, scn, st):
    out = []
    for _ in range(FRAMES):
        st = sim.step_frame(cfg, scn, st)
        out.append(convert.state_to_numpy(st))
    return out


def test_route_matches_k1_route(monkeypatch):
    """Equal to the fused route in every field; 8 K5 and 8 K6 calls a
    frame, no K1, and the alive plane comes from K6 on every substep (the
    frame's end does not re-derive it)."""
    cfg = _config()
    assert sim.marker_route(cfg, port_state(developed_numpy(64))[0]) == \
        "K5+K6"
    want = _frames(port_config(64), *port_state(developed_numpy(64)))
    derived = []
    monkeypatch.setattr(sim, "live_slots",
                        lambda *a: derived.append(a) or tms.live_slots(*a))
    _build.PLAIN_CALLS.clear()
    got = _frames(cfg, *port_state(developed_numpy(64)))
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "K4", "K5", "K6")] == \
        [0, 0, 8 * FRAMES, 8 * FRAMES]
    assert not derived
    for g, w in zip(got, want):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_route_matches_jax_step_frame():
    cfg = _config()
    jcfg = dataclasses.replace(jax_config(cfg), use_pallas_markers=False)
    assert not jcfg.fuse_marker_pass
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    with pallas_interpret():
        step = jax.jit(jstep_frame, static_argnums=0)
        for _ in range(FRAMES):
            st = sim.step_frame(cfg, scn, st)
            jst = step(jcfg, jscn, jst)
            got = convert.state_to_numpy(st)
            for name in ("marker_count", "alive", "dropped_markers",
                         "frame_count"):
                np.testing.assert_array_equal(
                    got[name], np.asarray(getattr(jst, name)), err_msg=name)
            for name in ("u", "v"):
                np.testing.assert_allclose(
                    got[name], np.asarray(getattr(jst, name)), atol=5e-3,
                    rtol=0, err_msg=name)
            jp = np.asarray(jst.p)
            scale = max(1.0, float(np.abs(jp).max()))
            np.testing.assert_allclose(got["p"], jp, atol=5e-4 * scale,
                                       rtol=0)
