"""Text scenarios in the port (`euler_tpu_torch/core/scenario.py`)
against the JAX package's `build_scenario`, slot layout: the masks, the
source list and the whole initial state of all 5 bundled scenarios
bitwise, in mono and rainbow and with padded source lists; and the model
registry (`euler_tpu_torch/models.py`)."""

import dataclasses

import numpy as np
import pytest

from euler_tpu import models as jmodels
from euler_tpu.config import SimConfig as JSimConfig
from euler_tpu.core import scenario as jscenario
from euler_tpu_torch import convert, models
from euler_tpu_torch.config import SimConfig
from euler_tpu_torch.core import scenario
from euler_tpu_torch.core.rng import XorShift64Star

from helpers import read_scenario

SCENARIOS = ["basic", "block", "filter", "waterfall", "weird-edges"]


def _both(name, rainbow=False, pad=None, **over):
    cfg = SimConfig(marker_layout="slots", rainbow=rainbow, **over)
    jcfg = JSimConfig(marker_layout="slots", rainbow=rainbow, **over)
    text = read_scenario(name + ".txt")
    scn, st = scenario.build_scenario(text, cfg, pad, device="cpu")
    jscn, jst = jscenario.build_scenario(text, jcfg, pad)
    return scn, st, jscn, jst


def _assert_same(scn, st, jscn, jst):
    for k, v in convert.scenario_to_numpy(scn).items():
        want = np.asarray(getattr(jscn, k))
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v, want, err_msg=k)
    for k, v in convert.state_to_numpy(st).items():
        want = np.asarray(getattr(jst, k))
        assert v.dtype == want.dtype and v.shape == want.shape, k
        np.testing.assert_array_equal(v, want, err_msg=k)
        assert v.tobytes() == want.tobytes(), k  # bitwise, -0.0 included


@pytest.mark.parametrize("rainbow", [False, True])
@pytest.mark.parametrize("name", SCENARIOS)
def test_initial_state_matches_jax(name, rainbow):
    _assert_same(*_both(name, rainbow))


@pytest.mark.parametrize("name", ["waterfall", "basic"])
def test_padded_sources_match_jax(name):
    scn, st, jscn, jst = _both(name, pad=64)
    assert scn.num_sources == 64
    assert int(scn.source_valid.sum()) == (60 if name == "waterfall" else 0)
    _assert_same(scn, st, jscn, jst)
    if name == "waterfall":
        with pytest.raises(ValueError, match="pad_sources"):
            scenario.build_scenario(read_scenario(name + ".txt"),
                                    SimConfig(marker_layout="slots"), 59,
                                    device="cpu")


@pytest.mark.parametrize("size", [(40, 99), (64, 128), (20, 30)])
def test_other_sizes_match_jax(size):
    """The text placed in a grid of another size: cut to its width and
    height (main.c:237-240), or in a corner of a larger grid."""
    ny, nx = size
    _assert_same(*_both("waterfall", ny=ny, nx=nx))


@pytest.mark.parametrize("name", SCENARIOS)
def test_parse_and_seed_match_jax(name):
    text = read_scenario(name + ".txt")
    cfg = SimConfig(marker_layout="slots")
    masks = scenario.parse_scenario_text(text, cfg)
    jmasks = jscenario.parse_scenario_text(text, JSimConfig())
    for a, b in zip(masks, jmasks):
        np.testing.assert_array_equal(a, b)
    from euler_tpu.core.rng import XorShift64Star as JXorShift

    pos = scenario.seed_markers(masks[1], cfg, XorShift64Star())
    jpos = jscenario.seed_markers(jmasks[1], JSimConfig(), JXorShift())
    np.testing.assert_array_equal(pos.view(np.uint32), jpos.view(np.uint32))
    np.testing.assert_array_equal(scenario._source_scan_order(masks[2]),
                                  jscenario._source_scan_order(jmasks[2]))


def test_waterfall_sources():
    scn, st, _, _ = _both("waterfall")
    assert scn.num_sources == 60 and bool(scn.source_valid.all())
    ys, xs = scn.source_yx[:, 0], scn.source_yx[:, 1]
    assert bool(scn.source[ys.long(), xs.long()].all())
    assert int(scn.source.sum()) == 60


def test_global_layout_raises():
    with pytest.raises(NotImplementedError, match="M9"):
        scenario.build_scenario(read_scenario("basic.txt"), SimConfig(),
                                device="cpu")


@pytest.mark.parametrize("name", ["waterfall", "dam_break"])
def test_models_registry(name):
    assert models.names() == jmodels.names()
    cfg = SimConfig(marker_layout="slots", nx=48, ny=32)
    scn, st = models.load(name, cfg, device="cpu")
    jscn, jst = jmodels.load(name, JSimConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "solver"}))
    _assert_same(scn, st, jscn, jst)
    with pytest.raises(KeyError):
        models.load("nonesuch", cfg, device="cpu")
