"""The unfused marker pass (`fuse_marker_pass=False`: K5, then K6)
against the JAX package, on the developed 64² dam break and block
obstacles, with dt x 1.5 so that markers collide and cross cells:

  * K5's plain version against the Pallas march `advect_markers_pallas`
    in interpret mode (live slots atol 1e-4, tests/test_pallas_markers.py:
    22-47) and against the jnp `advect_markers_slots` on every slot;
  * K6's plain version against the Pallas re-bin `rebin_markers_pallas`
    in interpret mode, fed the same numpy inputs (the state's alive
    plane, and one with holes: not front-compacted, slots beyond the
    count alive): positions, alive plane, counts and drops bitwise;
  * the state passes keep the wrappers' store as `state.markers`;
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
    """K5's new [2, K, Y, X] store."""
    return k5.advect_markers(cfg, st.u, st.v, st.fluid, scn.solid,
                             st.markers, dt, st.marker_count)


def _holed(cfg, px, py, alive, seed):
    """(px, py, alive) with a seeded 30% of the live slots cleared and 5%
    of the dead slots set alive at their cell's centre: holes, and live
    slots beyond a cell's count.  Every live marker stays within one cell
    of its home, as the CFL limit keeps it: beyond that the Pallas re-bin
    (exact destination cell) and the jnp one (offset clamped to [-1, 1],
    as the port's) part ways."""
    rng = np.random.default_rng(seed)
    extra = ~alive & (rng.random(alive.shape) < 0.05)
    h = np.float32(cfg.side_length)
    ys, xs = np.mgrid[0:cfg.ny, 0:cfg.nx].astype(np.float32)
    px = np.where(extra, (xs + np.float32(0.5)) * h, px).astype(np.float32)
    py = np.where(extra, (ys + np.float32(0.5)) * h, py).astype(np.float32)
    return px, py, (alive & (rng.random(alive.shape) >= 0.3)) | extra


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


@pytest.mark.parametrize("scenario,holes", [
    pytest.param(s, h, id=s + ("-holes" if h else ""))
    for s in SCENARIOS for h in (False, True)])
def test_rebin_matches_pallas_kernel(scenario, holes):
    """Fed the same numpy inputs: the marched store, the alive plane (the
    state's, or one with holes) and the dead plane, all bitwise."""
    cfg, scn, st, jscn, jst, dt = _inputs(scenario)
    px, py = (n(a) for a in _march(cfg, scn, st, dt))
    alive, dead = n(st.alive), n(scn.sink | scn.solid)
    if holes:
        px, py, alive = _holed(cfg, px, py, alive, seed=len(scenario))
        front = n(tms.live_slots(torch.as_tensor(alive.sum(0)), 8))
        assert not np.array_equal(alive, front)
    before = _build.PLAIN_CALLS["K6"]
    got = k6.rebin_markers(cfg, torch.as_tensor(np.stack([px, py])),
                           torch.as_tensor(alive), torch.as_tensor(dead))
    assert _build.PLAIN_CALLS["K6"] == before + 1
    opx, opy, ova, count, drop = rebin_markers_pallas(
        jax_config(cfg), jnp.asarray(px), jnp.asarray(py),
        jnp.asarray(alive.astype(np.float32)),
        jnp.asarray(dead.astype(np.float32)), True)
    want = (np.stack([opx, opy]), np.asarray(ova) != 0, count, drop)
    for name, a, b in zip(("store", "alive", "count", "drop"), got, want):
        np.testing.assert_array_equal(n(a), np.asarray(b), err_msg=name)
    assert (n(got[2]) != n(st.marker_count)).any()  # markers crossed cells


def test_zero_dt_is_identity():
    cfg = _config()
    scn, st = port_state(developed_numpy(64))
    marched = _march(cfg, scn, st, torch.tensor(0.0))
    assert torch.equal(marched, st.markers)
    markers, alive, count, drop = k6.rebin_markers(
        cfg, marched, st.alive, scn.sink | scn.solid)
    assert torch.equal(markers, st.markers)
    assert torch.equal(alive, st.alive)
    assert torch.equal(count, st.marker_count)
    assert not drop.any()


def test_state_passes_take_the_wrappers_store(monkeypatch):
    """`advect_markers_slots` and `refresh_marker_counts_slots` keep the
    K5 / K6 wrappers' [2, K, Y, X] store as `state.markers`, the very
    tensor (on the card: the kernel's output, no copy)."""
    cfg = _config()
    scn, st = port_state(developed_numpy(64))
    outs = {}

    def spy(name, fn):
        def call(*a, **kw):
            outs[name] = fn(*a, **kw)
            return outs[name]
        return call

    monkeypatch.setattr(k5, "advect_markers", spy("K5", k5.advect_markers))
    monkeypatch.setattr(k6, "rebin_markers", spy("K6", k6.rebin_markers))
    marched = tms.advect_markers_slots(cfg, scn, st, cfl_dt(cfg, st))
    rebinned = tms.refresh_marker_counts_slots(cfg, scn, marched)
    assert marched.markers is outs["K5"]
    assert marched.markers.shape == st.markers.shape
    assert rebinned.markers is outs["K6"][0]
    assert rebinned.alive is outs["K6"][1]
    assert torch.equal(rebinned.marker_count, outs["K6"][2])


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
