"""The single-card batch (`euler_tpu_torch/parallel/batch.py`,
`parallel/spatial.py`) against the JAX package's (`euler_tpu/parallel/
batch.py`), and against itself, on the CPU (the kernels' plain versions).

[basic.txt, waterfall.txt] at 40 x 100, basic padded with waterfall's 60
source entries, all invalid, under two configurations: the default
`SimConfig` (the global marker layout; tests/test_parallel.py's CFG) and
the CLI's --pallas slot configuration.
  * `build_batch` equals the JAX one leaf for leaf after `convert` (which
    takes the stacked batch's leading axis);
  * `step_frame_batched`, 2 frames, against JAX's
    `step_frame_batched_jit` (its marker pass as jnp ops, bitwise its
    Pallas one; its Pallas solver in interpret mode): counts, alive,
    alive_count and drops bitwise, u and v within 5e-3, the tolerance of
    the single-instance tests of the same routes
    (tests/test_torch_global_frames.py for the global layout,
    tests/test_torch_waterfall.py for the slot layout);
  * the batch against each instance stepped alone, bitwise, and the
    padded no-source instance on the routes of a scenario with sources
    (S1, never the fused substep: a third configuration, the Jacobi
    speed mode at 40 x 100, where basic.txt alone takes K10);
  * the input batch unchanged; source padding inert; `run_frames_batched`;
    `HostBatchRunner` against sequential stepping at 64²; `to_spatial` /
    `to_flat`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from euler_tpu.parallel.batch import build_batch as jbuild_batch
from euler_tpu.parallel.batch import step_frame_batched_jit as jstep_batched
from euler_tpu.parallel.spatial import to_flat as jto_flat
from euler_tpu.parallel.spatial import to_spatial as jto_spatial
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.core.scenario import build_scenario
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.parallel.batch import (
    HostBatchRunner,
    build_batch,
    instance,
    run_frames_batched,
    step_frame_batched,
)
from euler_tpu_torch.parallel.spatial import to_flat, to_spatial

from helpers import read_scenario
from torch_parity import jax_config, pallas_interpret

torch.set_num_threads(1)

FRAMES = 2
TEXTS = [read_scenario("basic.txt"), read_scenario("waterfall.txt")]
CONFIGS = {
    "global": SimConfig(solver=SolverConfig(max_iterations=100)),
    "slots": cli.build_config(cli.parse_args(["scenarios/waterfall.txt"])),
}
# the single-instance parity tests of the same routes hold u and v to
# this (tests/test_torch_global_frames.py, tests/test_torch_waterfall.py)
UV_ATOL = 5e-3
BITWISE = ["marker_count", "alive", "alive_count", "dropped_markers",
           "frame_count"]


def _jax_config(cfg):
    return dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)


def _clone(st):
    return st.replace(**{f.name: getattr(st, f.name).clone()
                         for f in dataclasses.fields(st)})


def _equal(a, b):
    """Every field of two states (or scenarios) bitwise equal."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x.dtype == torch.uint32:
            x, y = x.to(torch.int64), y.to(torch.int64)
        assert torch.equal(x, y), f.name


@pytest.fixture(scope="module", params=list(CONFIGS))
def runs(request):
    """The batch built and stepped FRAMES frames by both packages, and by
    the port instance by instance, with the port's plain-version calls."""
    name = request.param
    cfg = CONFIGS[name]
    jcfg = _jax_config(cfg)
    jscn, jst = jbuild_batch(TEXTS, jcfg)
    jbuilt = (jscn, jst)
    scn, st0 = build_batch(TEXTS, cfg, device="cpu")
    before = _clone(st0)
    _build.PLAIN_CALLS.clear()
    st = st0
    got, want = [], []
    for _ in range(FRAMES):
        st = step_frame_batched(cfg, scn, st)
        with pallas_interpret():
            jst = jstep_batched(jcfg, jscn, jst)
        got.append(st)
        want.append(jst)
    calls = dict(_build.PLAIN_CALLS)
    return dict(name=name, cfg=cfg, scn=scn, st0=st0, before=before,
                got=got, want=want, jbuilt=jbuilt, calls=calls)


def test_build_batch_matches_jax(runs):
    cfg, scn, st0 = runs["cfg"], runs["scn"], runs["st0"]
    jscn, jst = runs["jbuilt"]
    assert scn.source_yx.shape == (2, 60, 2)
    assert st0.u.shape == (2, cfg.ny, cfg.nx)
    jnp_st = {f.name: np.asarray(getattr(jst, f.name))
              for f in dataclasses.fields(jst)}
    for k, v in convert.state_to_numpy(st0).items():
        assert v.dtype == jnp_st[k].dtype and v.shape == jnp_st[k].shape, k
        np.testing.assert_array_equal(v, jnp_st[k], err_msg=k)
    for k, v in convert.scenario_to_numpy(scn).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jscn, k)),
                                      err_msg=k)
    # the JAX batch carried across is the port's own
    _equal(convert.state_from_numpy(jnp_st, device="cpu",
                                    layout=cfg.marker_layout), st0)
    _equal(convert.scenario_from_numpy(
        {k: np.asarray(getattr(jscn, k)) for k in convert._SCENARIO_FIELDS},
        device="cpu"), scn)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_batched_matches_jax(runs, frame):
    got = convert.state_to_numpy(runs["got"][frame])
    jst = runs["want"][frame]
    for k in BITWISE:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jst, k)),
                                      err_msg=k)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                   atol=UV_ATOL, rtol=0, err_msg=k)
    assert list(got["frame_count"]) == [frame + 1] * len(TEXTS)


def test_batched_matches_per_instance(runs):
    """Each instance of the batch bitwise equal to the same padded
    instance stepped alone; every substep of both instances took S1."""
    cfg, scn, st0 = runs["cfg"], runs["scn"], runs["st0"]
    for i in range(len(TEXTS)):
        one = instance(scn, i)
        assert one.num_sources == 60 and scn.num_sources == len(TEXTS)
        st = instance(st0, i)
        for frame in range(FRAMES):
            st = sim.step_frame(cfg, one, st)
            _equal(st, instance(runs["got"][frame], i))
    assert runs["calls"]["S1"] == len(TEXTS) * cfg.max_substeps * FRAMES


def test_input_batch_unchanged(runs):
    _equal(runs["st0"], runs["before"])


def test_padded_instance_takes_the_source_route():
    """basic.txt has no sources: alone it takes the fused Jacobi substep
    (K10) of the speed mode; padded with waterfall's it takes S1 and the
    unfused projection (K9), as the JAX vmap does, and the batch equals
    the padded instance stepped alone."""
    cfg = SimConfig(marker_layout="slots", solver=SolverConfig(
        max_iterations=100, tol_rel=1e-6, fuse_projection=True))
    alone, _ = build_scenario(TEXTS[0], cfg, device="cpu")
    assert sim.route(cfg, alone) == ("fused", "K10")
    scn, st0 = build_batch(TEXTS, cfg, device="cpu")
    assert sim.route(cfg, instance(scn, 0)) == ("plain", "K9")
    _build.PLAIN_CALLS.clear()
    st = step_frame_batched(cfg, scn, st0)
    calls = dict(_build.PLAIN_CALLS)
    assert "K10" not in calls and "K2" not in calls
    assert calls["S1"] == calls["K9"] == len(TEXTS) * cfg.max_substeps
    _equal(sim.step_frame(cfg, instance(scn, 0), instance(st0, 0)),
           instance(st, 0))


@pytest.mark.parametrize("layout", ["global", "slots"])
def test_source_padding_is_inert(layout):
    """Padded source entries emit nothing and draw nothing (tests/
    test_parallel.py:40-52)."""
    cfg = CONFIGS[layout]
    text = TEXTS[1]
    scn0, st0 = build_scenario(text, cfg, device="cpu")
    scn1, st1 = build_scenario(text, cfg, pad_sources=scn0.num_sources + 7,
                               device="cpu")
    st0 = sim.step_frame(cfg, scn0, st0)
    st1 = sim.step_frame(cfg, scn1, st1)
    _equal(st0, st1)


def test_run_frames_batched():
    cfg = CONFIGS["global"]
    scn, st = build_batch(TEXTS, cfg, device="cpu")
    out = run_frames_batched(cfg, scn, st, 3)
    assert out.frame_count.tolist() == [3, 3]
    assert not torch.isnan(out.u).any()


def test_host_batch_matches_sequential():
    """HostBatchRunner is per-instance stepping, round-robin
    (tests/test_host_batch.py)."""
    cfg = SimConfig(nx=64, ny=64, marker_layout="slots",
                    solver=SolverConfig(max_iterations=30))
    pairs = [dam_break(cfg, seed=i, device="cpu") for i in range(3)]
    runner = HostBatchRunner(cfg, pairs)
    states = runner.run(2)
    sums = runner.sync()
    for (scn, st), st_b, s in zip(pairs, states, sums):
        for _ in range(2):
            st = sim.step_frame(cfg, scn, st)
        _equal(st, st_b)
        assert int(st_b.frame_count) == 2 and s == float(st.u.sum())


def test_spatial_round_trip_matches_jax():
    """to_flat gives the JAX package's flat store, to_spatial takes the
    JAX package's spatial planes back, and each returns a state already
    in its form as it is."""
    cfg = CONFIGS["slots"]
    jcfg = _jax_config(cfg)
    from euler_tpu.core.scenario import build_scenario as jbuild

    _, st = build_scenario(TEXTS[1], cfg, device="cpu")
    _, jst = jbuild(TEXTS[1], jcfg)
    flat = to_flat(cfg, st)
    assert flat.markers.shape == (2, cfg.max_markers)
    np.testing.assert_array_equal(flat.markers.numpy(),
                                  np.asarray(jto_flat(jcfg, jst).markers))
    np.testing.assert_array_equal(flat.alive.numpy(),
                                  np.asarray(jto_flat(jcfg, jst).alive))
    js = jto_spatial(jcfg, jst)
    back = to_spatial(cfg, flat)
    np.testing.assert_array_equal(back.markers.numpy(),
                                  np.asarray(js.markers))
    np.testing.assert_array_equal(back.alive.numpy(), np.asarray(js.alive))
    assert to_spatial(cfg, st) is st and to_flat(cfg, flat) is flat
    with pytest.raises(ValueError, match="slot"):
        to_spatial(CONFIGS["global"], st)
