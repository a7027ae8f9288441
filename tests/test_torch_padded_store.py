"""The persistent padded slot store (`marker_padded_store=True`: K4)
against the JAX package, on the developed 64² dam break and block
obstacles, with dt x 1.5 so that markers collide and cross cells:

  * `pad_slot_store` / `unpad_slot_store`: the JAX package's layout
    [2K, Y+16, X+256] with the interior at (8, 128), and a round trip;
  * K4's plain version against the Pallas `march_rebin_padded` in
    interpret mode, with garbage in the pads (the contract says they may
    hold anything): counts and drops bitwise, live positions atol 1e-4
    (tests/test_pallas_markers.py), and its interior equal to K1's;
  * the route: 2 frames through `sim.step_frame` equal to the port's own
    K1 route in every field, with one pad and one unpad a frame, and
    against the JAX `step_frame` with the same switches (the padded
    Pallas pass and the solvers' Pallas kernels in interpret mode):
    counts and alive bitwise, drops equal, u/v atol 5e-3, p atol 5e-4
    of scale (tests/test_substep_fused.py:118-146).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops.pallas import marker_fused_kernel as jk
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import convert, sim
from euler_tpu_torch.ops import markers_slots as tms
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k4

from torch_parity import (
    assert_live_close,
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
K, Y, X = 8, 64, 64
INTERIOR = (slice(None), slice(8, 8 + Y), slice(128, 128 + X))


def _config():
    return port_config(64, marker_padded_store=True)


def _garbage_pads(padded, seed=0):
    """`padded` with its pads overwritten by seeded values, some inside
    the domain's coordinate range."""
    rng = np.random.default_rng(seed)
    out = rng.uniform(-8.0, 72.0, padded.shape).astype(np.float32)
    out[INTERIOR] = n(padded)[INTERIOR]
    return torch.as_tensor(out)


def test_pad_unpad_round_trip():
    cfg = _config()
    _, st = port_state(developed_numpy(64))
    _, jst = jax_state(developed_numpy(64))
    padded = k4.pad_slot_store(cfg, st.markers)
    assert padded.shape == (2 * K, Y + 16, X + 256)
    np.testing.assert_array_equal(
        n(padded), np.asarray(jk.pad_slot_store(jax_config(cfg),
                                                jst.markers)))
    assert torch.equal(padded[INTERIOR], st.markers.reshape(2 * K, Y, X))
    back = k4.unpad_slot_store(cfg, _garbage_pads(padded))
    assert back.is_contiguous() and torch.equal(back, st.markers)


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_march_rebin_padded_matches_pallas_kernel(scenario):
    cfg = _config()
    scn, st = port_state(scenario_numpy(scenario))
    jscn, jst = jax_state(scenario_numpy(scenario))
    dt = cfl_dt(cfg, st) * 1.5
    dead = scn.sink | scn.solid
    store = _garbage_pads(k4.pad_slot_store(cfg, st.markers))
    args = (cfg, st.u, st.v, st.fluid, scn.solid)
    before = _build.PLAIN_CALLS["K4"]
    slots, count, drop = k4.march_rebin_padded(*args, store, dt,
                                               st.marker_count, dead=dead)
    assert _build.PLAIN_CALLS["K4"] == before + 1
    assert slots.shape == store.shape
    jslots, jcount, jdrop = jk.march_rebin_padded(
        jax_config(cfg), jst.u, jst.v, jst.fluid, jscn.solid,
        jnp.asarray(n(store)), jnp.float32(float(dt)), jst.marker_count,
        dead=(jscn.sink | jscn.solid).astype(jnp.float32), interpret=True)
    np.testing.assert_array_equal(n(count), np.asarray(jcount))
    np.testing.assert_array_equal(n(drop), np.asarray(jdrop))
    assert_live_close(cfg, n(slots)[INTERIOR], np.asarray(jslots)[INTERIOR],
                      n(count))
    assert (n(count) != n(st.marker_count)).any()  # markers crossed cells
    # the interior is K1's output, bit for bit
    k1 = k4.march_rebin_plain(*args, st.markers.reshape(2 * K, Y, X), dt,
                              st.marker_count, dead=dead)
    for a, b in zip((slots[INTERIOR], count, drop), k1):
        assert torch.equal(a, b)


def test_zero_dt_is_identity():
    cfg = _config()
    scn, st = port_state(developed_numpy(64))
    store = _garbage_pads(k4.pad_slot_store(cfg, st.markers))
    slots, count, drop = k4.march_rebin_padded(
        cfg, st.u, st.v, st.fluid, scn.solid, store, torch.tensor(0.0),
        st.marker_count, dead=scn.sink | scn.solid)
    assert torch.equal(slots[INTERIOR], store[INTERIOR])
    assert torch.equal(count, st.marker_count)
    assert not drop.any()


def test_padded_route_needs_the_deferred_alive():
    cfg = _config()
    scn, st = port_state(developed_numpy(64))
    st = st.replace(markers=k4.pad_slot_store(cfg, st.markers))
    with pytest.raises(AssertionError, match="deferred alive"):
        tms.marker_pass_slots(cfg, scn, st, cfl_dt(cfg, st), route="K4")


def _frames(cfg, scn, st):
    out = []
    for _ in range(FRAMES):
        st = sim.step_frame(cfg, scn, st)
        out.append(convert.state_to_numpy(st))
    return out


def test_route_matches_k1_route(monkeypatch):
    """Equal to the K1 route in every field; 8 K4 calls a frame, no K1,
    and one pad and one unpad a frame."""
    cfg = _config()
    assert sim.marker_route(cfg, port_state(developed_numpy(64))[0]) == "K4"
    want = _frames(port_config(64), *port_state(developed_numpy(64)))
    calls = []
    for name in ("pad_slot_store", "unpad_slot_store"):
        fn = getattr(sim, name)
        monkeypatch.setattr(sim, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    _build.PLAIN_CALLS.clear()
    got = _frames(cfg, *port_state(developed_numpy(64)))
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "K4", "K5", "K6")] == \
        [0, 8 * FRAMES, 0, 0]
    assert calls == ["pad_slot_store", "unpad_slot_store"] * FRAMES
    for g, w in zip(got, want):
        for name in w:
            np.testing.assert_array_equal(g[name], w[name], err_msg=name)


def test_route_matches_jax_step_frame():
    cfg = _config()
    jcfg = jax_config(cfg)
    assert jcfg.marker_padded_store and jcfg.use_pallas_markers
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    with pallas_interpret():
        step = jax.jit(jstep_frame, static_argnums=0)
        for _ in range(FRAMES):
            st = sim.step_frame(cfg, scn, st)
            jst = step(jcfg, jscn, jst)
            got = convert.state_to_numpy(st)
            assert got["markers"].shape == np.asarray(jst.markers).shape
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
