"""The port's renderer against the JAX package's, on all 5 bundled
scenarios two frames in (the port's own states, handed to both): the
bytes of `draw_frame` and `draw_frame_downsampled` equal the JAX
package's, in mono and rainbow and for windows that clip; the native
encoder (the port's own copy, built with g++ into build/) equals
`encode_frame_py`; the gather is one device-to-host copy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.config import SimConfig as JSimConfig
from euler_tpu.core.state import FluidState as JFluidState
from euler_tpu.core.state import Scenario as JScenario
from euler_tpu.render import ansi as jansi
from euler_tpu.render import downsample as jdown
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.core.scenario import load_scenario
from euler_tpu_torch.native import get_lib
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.render import ansi, downsample

SCENARIOS = ["basic", "block", "filter", "waterfall", "weird-edges"]
WINDOWS = [(30, 110), (20, 50), (1, 3)]


@pytest.fixture(scope="module", params=[(s, r) for s in SCENARIOS
                                        for r in (False, True)],
                ids=lambda p: f"{p[0]}-{'rainbow' if p[1] else 'mono'}")
def frame(request):
    name, rainbow = request.param
    argv = [f"scenarios/{name}.txt"] + (["--rainbow"] if rainbow else [])
    cfg = cli.build_config(cli.parse_args(argv))
    scn, st = load_scenario(f"scenarios/{name}.txt", cfg, device="cpu")
    for _ in range(2):
        st = sim.step_frame(cfg, scn, st)
    jcfg = JSimConfig(ny=cfg.ny, nx=cfg.nx, rainbow=rainbow,
                      marker_layout="slots")
    jscn = JScenario(**{k: jnp.asarray(v) for k, v in
                        convert.scenario_to_numpy(scn).items()})
    jst = JFluidState(**{k: jnp.asarray(v) for k, v in
                         convert.state_to_numpy(st).items()})
    return cfg, scn, st, jcfg, jscn, jst


@pytest.mark.parametrize("window", WINDOWS)
def test_draw_frame_matches_jax(frame, window):
    cfg, scn, st, jcfg, jscn, jst = frame
    got = ansi.draw_frame(cfg, scn, st, *window)
    assert got == jansi.draw_frame(jcfg, jscn, jst, *window)
    glyph, cls, rgb = ansi.gather_frame(cfg, scn, st)
    assert got == (ansi.T_REPOSITION + ansi.encode_frame_py(
        cfg, glyph, cls, rgb, *window, cfg.rainbow) + ansi.T_HIDE_CURSOR)


@pytest.mark.parametrize("window", [(12, 40), (5, 9)])
def test_draw_frame_downsampled_matches_jax(frame, window):
    cfg, scn, st, jcfg, jscn, jst = frame
    assert downsample.pick_factors(cfg, *window) == jdown.pick_factors(
        jcfg, *window)
    assert (downsample.draw_frame_downsampled(cfg, scn, st, *window)
            == jdown.draw_frame_downsampled(jcfg, jscn, jst, *window))


def test_gather_matches_jax(frame):
    cfg, scn, st, jcfg, jscn, jst = frame
    for a, b in zip(ansi.gather_frame(cfg, scn, st),
                    jansi.gather_frame(jcfg, jscn, jst)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("seed", range(4))
def test_native_encoder_matches_python(seed):
    """Random frames with every class, glyph and colour, clipped and
    not: the C++ encoder gives encode_frame_py's bytes."""
    g = np.random.default_rng(seed)
    Y, X = int(g.integers(3, 50)), int(g.integers(3, 120))
    cfg = cli.build_config(cli.parse_args(["x", "--size", f"{Y}x{X}"]))
    glyph = g.integers(0, 5, (Y, X)).astype(np.uint8)
    cls = g.integers(0, 3, (Y, X)).astype(np.uint8)
    rgb = g.integers(0, 256, (Y, X, 3)).astype(np.uint8)
    for rows, cols in ((Y, X), (Y // 2, X // 3), (1, 1)):
        for rainbow in (False, True):
            assert ansi.encode_frame(cfg, glyph, cls, rgb, rows, cols,
                                     rainbow) == ansi.encode_frame_py(
                cfg, glyph, cls, rgb, rows, cols, rainbow)


def test_native_encoder_builds_into_build_dir():
    get_lib()
    built = list(_build.BUILD_DIR.glob("libencoder-*.so"))
    assert built
    src_dir = ansi.__file__.rsplit("/", 2)[0] + "/native"
    import os

    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]


def test_gather_is_one_copy(monkeypatch, frame):
    cfg, scn, st, *_ = frame
    copies = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        copies.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    ansi.gather_frame(cfg, scn, st)
    downsample.gather_frame_downsampled(cfg, 2, 3, scn, st)
    assert copies == [(cfg.ny, cfg.nx, 5),
                      (-(-(cfg.ny - 2) // 2) + 2, -(-(cfg.nx - 2) // 3) + 2,
                       5)]
