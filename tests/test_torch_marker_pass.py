"""K1's plain version (march + re-bin) against the JAX package: the Pallas
fused marker kernel in interpret mode and the jnp slot pipeline.  Counts
and drops bitwise; live-slot positions atol 1e-4
(tests/test_pallas_markers.py: XLA contracts FMAs on the CPU)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import markers_slots as jms
from euler_tpu.ops.pallas.marker_fused_kernel import march_rebin_pallas
from euler_tpu_torch import convert, sim
from euler_tpu_torch.core import presets
from euler_tpu_torch.ops import markers_slots as tms
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.forces import max_speed_sq

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    port_config,
    port_state,
)


@functools.lru_cache(maxsize=None)
def _obstacle_numpy():
    cfg = port_config(64)
    scn, st = presets.block_obstacles(cfg, seed=1, device="cpu")
    for _ in range(3):
        st = sim.step_frame(cfg, scn, st)
    return convert.scenario_to_numpy(scn), convert.state_to_numpy(st)


def _arrays(scenario):
    return developed_numpy(64) if scenario == "dam_break" else \
        _obstacle_numpy()


def _cfl_dt(cfg, st):
    frame_time = torch.tensor(cfg.frame_time)
    return sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v), frame_time)


def _live_equal(cfg, got, want, count):
    K = cfg.slots_per_cell
    live = np.concatenate([n(tms.live_slots(torch.as_tensor(count), K))] * 2)
    np.testing.assert_allclose(got[live], want[live], atol=1e-4, rtol=0)
    assert not got[~live].any()


@pytest.mark.parametrize("scenario", ["dam_break", "block_obstacles"])
def test_march_rebin_matches_pallas_kernel(scenario):
    cfg = port_config(64)
    jcfg = jax_config(cfg)
    scn, st = port_state(_arrays(scenario))
    jscn, jst = jax_state(_arrays(scenario))
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    dt = _cfl_dt(cfg, st) * 1.5  # collisions and cell crossings
    dead = scn.sink | scn.solid

    slots, count, drop = k1.march_rebin(
        cfg, st.u, st.v, st.fluid, scn.solid,
        st.markers.reshape(2 * K, Y, X), dt, st.marker_count, dead=dead)
    jslots, jcount, jdrop = march_rebin_pallas(
        jcfg, jst.u, jst.v, jst.fluid, jscn.solid,
        jst.markers.reshape(2 * K, Y, X), jnp.float32(float(dt)),
        jst.marker_count, True,
        dead=(jscn.sink | jscn.solid).astype(jnp.float32))
    np.testing.assert_array_equal(n(count), np.asarray(jcount))
    np.testing.assert_array_equal(n(drop), np.asarray(jdrop))
    _live_equal(cfg, n(slots), np.asarray(jslots), n(count))
    moved = (n(count) != n(st.marker_count)).sum()
    assert moved > 0  # the pass re-binned markers across cells


def test_zero_dt_is_identity():
    cfg = port_config(64)
    scn, st = port_state(developed_numpy(64))
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    slots = st.markers.reshape(2 * K, Y, X)
    out, count, drop = k1.march_rebin(
        cfg, st.u, st.v, st.fluid, scn.solid, slots, torch.tensor(0.0),
        st.marker_count, dead=scn.sink | scn.solid)
    assert torch.equal(out, slots)
    assert torch.equal(count, st.marker_count)
    assert not drop.any()


@pytest.mark.parametrize("scenario", ["dam_break", "block_obstacles"])
def test_state_passes_match_jnp_pipeline(scenario):
    """advect_markers_slots then refresh_marker_counts_slots (state level,
    on the state's alive plane) against the JAX jnp pipeline."""
    cfg = port_config(64)
    jcfg = jax_config(cfg, interpret=False)
    scn, st = port_state(_arrays(scenario))
    jscn, jst = jax_state(_arrays(scenario))
    dt = _cfl_dt(cfg, st)

    st = tms.refresh_marker_counts_slots(
        cfg, scn, tms.advect_markers_slots(cfg, scn, st, dt))
    jst = jms.refresh_marker_counts_slots(
        jcfg, jscn, jms.advect_markers_slots(jcfg, jscn, jst,
                                             jnp.float32(float(dt))))
    got = convert.state_to_numpy(st)
    for name in ("marker_count", "prev_marker_count", "alive",
                 "alive_count", "dropped_markers"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(jst, name)),
                                      err_msg=name)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    _live_equal(cfg, got["markers"].reshape(2 * K, Y, X),
                np.asarray(jst.markers).reshape(2 * K, Y, X),
                got["marker_count"])


def test_marker_pass_slots_uses_the_wrapper():
    cfg = port_config(64)
    scn, st = port_state(developed_numpy(64))
    before = _build.PLAIN_CALLS["K1"]
    out = tms.marker_pass_slots(cfg, scn, st, _cfl_dt(cfg, st))
    assert _build.PLAIN_CALLS["K1"] == before + 1
    assert torch.equal(out.prev_marker_count, st.marker_count)
    assert torch.equal(out.alive, tms.live_slots(out.marker_count,
                                                  cfg.slots_per_cell))
