"""Source emission in the port: S1's plain version
(`ops/markers_slots.source_pass_slots`, through the S1 wrapper on CPU
tensors) against the JAX package's `update_fluid_sources_slots`, on
seeded states of the waterfall scenario's 60 sources: active and
inactive substeps, exhaustion part-way through the walk, cells at
markers_per_cell and at K, padded invalid sources, both JAX store
layouts.  Every field written (store, alive plane, counts, r, g, b, RNG,
alive_count, source_exhausted) bitwise.  And the frame loop, which lets
S1 write in place, leaves its caller's state untouched."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.config import SimConfig as JSimConfig
from euler_tpu.core.state import FluidState as JFluidState
from euler_tpu.core.state import Scenario as JScenario
from euler_tpu.ops.markers_slots import update_fluid_sources_slots as jemit
from euler_tpu_torch import convert, sim
from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core.scenario import load_scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda.source_kernel import emit_sources

from source_states import CASES, source_case
from source_states import source_scenario as _scenario
from source_states import source_state as _state

WRITTEN = ["markers", "alive", "marker_count", "r", "g", "b", "rng",
           "alive_count", "source_exhausted"]


def _cfg(**over):
    return SimConfig(marker_layout="slots", **over)


def _jcfg(cfg):
    return JSimConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)
                         if f.name != "solver"})


def _run(cfg, scn_np, st_np, active, spatial=False):
    """(port fields, JAX fields) after one emission from the same
    inputs."""
    scn = convert.scenario_from_numpy(scn_np, device="cpu")
    st = convert.state_from_numpy(st_np, device="cpu")
    act = None if active is None else torch.tensor(active)
    before = _build.PLAIN_CALLS["S1"]
    emit_sources(cfg, scn, st, act)
    assert _build.PLAIN_CALLS["S1"] == before + 1
    got = convert.state_to_numpy(st)

    jcfg = _jcfg(cfg)
    jscn = JScenario(**{k: jnp.asarray(v) for k, v in scn_np.items()})
    jst = JFluidState(**{k: jnp.asarray(v) for k, v in st_np.items()})
    if spatial:
        K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
        jst = jst.replace(markers=jst.markers.reshape(2, K, Y, X),
                          alive=jst.alive.reshape(K, Y, X))
    jact = None if active is None else jnp.asarray(active)
    jout = jemit(jcfg, jscn, jst, active=jact)
    want = {k: np.asarray(getattr(jout, k)).reshape(np.shape(got[k]))
            for k in WRITTEN}
    return got, want


def _assert_written(got, want):
    for k in WRITTEN:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("spatial", [False, True])
@pytest.mark.parametrize("active", [True, None])
def test_emission_matches_jax(active, spatial):
    cfg = _cfg()
    scn = _scenario(cfg)
    counts = np.random.default_rng(1).integers(0, 6, 60)
    st = _state(cfg, scn, 2, counts, alive_count=1000)
    got, want = _run(cfg, scn, st, active, spatial)
    _assert_written(got, want)
    emitted = int((counts < cfg.markers_per_cell).sum())
    assert int(got["alive_count"]) == 1000 + emitted
    assert emitted > 0 and not np.array_equal(got["rng"], st["rng"])


def test_inactive_substep_changes_nothing_but_colours():
    cfg = _cfg()
    scn = _scenario(cfg)
    st = _state(cfg, scn, 3, np.zeros(60, np.int32), alive_count=500)
    got, want = _run(cfg, scn, st, False)
    _assert_written(got, want)
    for k in ("markers", "alive", "marker_count", "rng", "alive_count"):
        np.testing.assert_array_equal(got[k], st[k], err_msg=k)
    src = scn["source"]
    assert not np.array_equal(got["r"][src], st["r"][src])
    np.testing.assert_array_equal(got["r"][~src], st["r"][~src])


@pytest.mark.parametrize("exhausted", [False, True])
def test_exhaustion_matches_jax(exhausted):
    """alive_count at max_markers - 3 with 5 sources: two emit, then the
    stream is exhausted (or it is from the start)."""
    cfg = _cfg()
    scn = _scenario(cfg, n_src=5)
    st = _state(cfg, scn, 4, np.zeros(5, np.int32),
                alive_count=cfg.max_markers - 3, exhausted=exhausted)
    got, want = _run(cfg, scn, st, True)
    _assert_written(got, want)
    assert bool(got["source_exhausted"])
    assert int(got["alive_count"]) == cfg.max_markers - (3 if exhausted
                                                         else 1)


@pytest.mark.parametrize("per_cell,K,counts", [
    (4, 8, (3, 4, 5)),      # markers_per_cell binds
    (8, 6, (4, 5, 6)),      # K binds
])
def test_cells_at_the_caps_match_jax(per_cell, K, counts):
    cfg = _cfg(markers_per_cell=per_cell, slots_per_cell=K)
    scn = _scenario(cfg)
    c = np.resize(np.asarray(counts, np.int32), 60)
    st = _state(cfg, scn, 5, c, alive_count=2000)
    got, want = _run(cfg, scn, st, True)
    _assert_written(got, want)
    assert int(got["alive_count"]) == 2000 + int(
        ((c < per_cell) & (c < K)).sum())


def test_padded_sources_match_jax():
    cfg = _cfg()
    scn = _scenario(cfg, pad=6)
    st = _state(cfg, scn, 6, np.r_[np.zeros(60), np.full(6, 2)],
                alive_count=100)
    got, want = _run(cfg, scn, st, True)
    _assert_written(got, want)
    assert int(got["alive_count"]) == 160


def test_frame_leaves_the_callers_state_alone():
    """S1 writes in place; step_frame copies what it carries from its
    input first, so the input state is unchanged and a second frame from
    it gives the same result."""
    cfg = _cfg(solver=dataclasses.replace(SimConfig().solver,
                                          use_pallas=True))
    scn, st = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")
    before = {k: v.copy() for k, v in convert.state_to_numpy(st).items()}
    a = convert.state_to_numpy(sim.step_frame(cfg, scn, st))
    for k, v in convert.state_to_numpy(st).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    b = convert.state_to_numpy(sim.step_frame(cfg, scn, st))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    src = convert.scenario_to_numpy(scn)["source"]
    assert not np.array_equal(a["r"][src], before["r"][src])


@pytest.mark.parametrize("case", CASES)
def test_card_cases_match_jax(case):
    """The seeded cases the card tests hold S1 to (tests/source_states.py)
    are JAX's emission in the plain version."""
    cfg, scn, st, active = source_case(case)
    got, want = _run(cfg, scn, st, active)
    _assert_written(got, want)
