"""The slice as a whole: scenarios/waterfall.txt (60 sources) in the
configuration the CLI builds, the port on the CPU against the JAX
package (its marker pass as jnp ops, bitwise its Pallas one; its
solvers' Pallas kernels in interpret mode), 2 frames:
marker_count, alive, alive_count, dropped_markers, the RNG,
source_exhausted and the colours bitwise, u and v within atol 5e-3
(tests/test_torch_sim.py's standard for the main path).  On three
routes: the CLI's 40 x 100 config (K1, S1, K7, K8), the same on the
unfused marker pass (K5 + K6), and the converged MG config at 64 x 128
(K1, S1, K7, K3 through `project()`).  Sources never take K2, K10 or
K4."""

import dataclasses

import jax
import numpy as np
import pytest

from euler_tpu.core.scenario import load_scenario as jload_scenario
from euler_tpu.parallel.spatial import to_spatial
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.core.scenario import load_scenario
from euler_tpu_torch.ops.cuda import _build

from torch_parity import jax_config, pallas_interpret

FRAMES = 2
BITWISE = ["marker_count", "alive", "alive_count", "dropped_markers", "rng",
           "source_exhausted", "r", "g", "b", "frame_count"]
ROUTES = {
    # route: (CLI arguments, fuse_marker_pass, kernels its frames run)
    "K1": ([], True, {"K1", "S1", "K7", "K8"}),
    "K5+K6": ([], False, {"K5", "K6", "S1", "K7", "K8"}),
    "mg": (["--size", "64x128", "--converged"], True,
           {"K1", "S1", "K7", "K3"}),
}


def _config(route):
    argv, fused, _ = ROUTES[route]
    cfg = cli.build_config(cli.parse_args(["scenarios/waterfall.txt"]
                                          + argv))
    return dataclasses.replace(cfg, fuse_marker_pass=fused)


@pytest.fixture(scope="module", params=list(ROUTES))
def frames(request):
    route = request.param
    cfg = _config(route)
    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)
    scn, st = load_scenario("scenarios/waterfall.txt", cfg, device="cpu")
    jscn, jst = jload_scenario("scenarios/waterfall.txt", jcfg)
    jst = to_spatial(jcfg, jst)
    step = jax.jit(jstep_frame, static_argnums=0)
    _build.PLAIN_CALLS.clear()
    _build.LAUNCHES.clear()
    out = []
    for _ in range(FRAMES):
        st = sim.step_frame(cfg, scn, st)
        with pallas_interpret():
            jst = step(jcfg, jscn, jst)
        out.append((convert.state_to_numpy(st), jst))
    return route, cfg, scn, out, dict(_build.PLAIN_CALLS)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_waterfall_matches_jax(frames, frame):
    route, cfg, scn, out, _ = frames
    got, jst = out[frame]
    for k in BITWISE:
        want = np.asarray(getattr(jst, k)).reshape(np.shape(got[k]))
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                   atol=5e-3, rtol=0, err_msg=k)
    assert int(got["frame_count"]) == frame + 1


def test_waterfall_routes(frames):
    """The frames ran the route's kernels (their plain versions, on the
    CPU), and no fused or padded-store kernel."""
    route, cfg, scn, out, calls = frames
    _, _, kernels = ROUTES[route]
    assert set(calls) == kernels
    assert calls["S1"] == cfg.max_substeps * FRAMES
    assert sim.route(cfg, scn)[0] != "fused"
    assert sim.marker_route(cfg, scn) == ("K1" if cfg.fuse_marker_pass
                                          else "K5+K6")
    assert int(out[-1][0]["alive_count"]) > 0
