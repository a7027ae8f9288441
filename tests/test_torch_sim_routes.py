"""The port's frame loop on the routes beside the MG main path, against
the JAX `step_frame`: 2 frames from the developed 64² dam break (rainbow
routes colourised first), with the JAX projection's Pallas solvers in
interpret mode and its marker pass as jnp ops (bitwise the fused Pallas
pass, which tests/test_torch_marker_pass.py holds K1 against).

  route             config                          kernel
  jacobi fused      jacobi, fuse_projection, mono   K10
  jacobi unfused    jacobi, no fuse_projection      K8 (project)
  jacobi rainbow    jacobi, fuse_projection, rainbow K9
  mg rainbow        mg, fuse_projection, rainbow    K3 (project)

Marker counts bitwise, dropped markers equal, u/v atol 5e-3, r/g/b atol
5e-3 in rainbow mode (tests/test_substep_fused.py:118-146); p as each
route defines it: the K8/K3 routes carry the clamped pressure (atol
5e-4 of scale), K9 zeroes it and K10 carries it unchanged.  Sources and
IC(0) run; cfl above 1 and RB-GS MG still raise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from euler_tpu.ops.color import colorize as jcolorize
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import convert, sim
from euler_tpu_torch.ops.color import colorize

from torch_parity import (
    developed_numpy,
    jax_config,
    jax_state,
    n,
    pallas_interpret,
    port_config,
    port_state,
    speed_config,
)

FRAMES = 2


def _config(route):
    if route == "mg_rainbow":
        return port_config(64, rainbow=True)
    cfg = speed_config(64, rainbow=route == "jacobi_rainbow")
    if route == "jacobi_unfused":
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, fuse_projection=False))
    return cfg


def _run(route):
    cfg = _config(route)
    jcfg = dataclasses.replace(jax_config(cfg), use_pallas_markers=False)
    scn, st = port_state(developed_numpy(64))
    jscn, jst = jax_state(developed_numpy(64))
    if cfg.rainbow:
        st = colorize(cfg, scn, st)
        jst = jcolorize(jcfg, jscn, jst)
    out = []
    with pallas_interpret():
        step = jax.jit(jstep_frame, static_argnums=0)
        for _ in range(FRAMES):
            st, stats = sim.step_frame_stats(cfg, scn, st)
            jst = step(jcfg, jscn, jst)
            out.append((cfg, convert.state_to_numpy(st), jst, stats))
    return out


ROUTES = ["jacobi_fused", "jacobi_unfused", "jacobi_rainbow", "mg_rainbow"]


@pytest.fixture(scope="module", params=ROUTES)
def frames(request):
    return request.param, _run(request.param)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_route_frames_match_jax(frames, frame):
    route, out = frames
    cfg, got, jst, stats = out[frame]
    np.testing.assert_array_equal(got["marker_count"],
                                  np.asarray(jst.marker_count))
    assert int(got["dropped_markers"]) == int(jst.dropped_markers)
    for name in ("u", "v") + (("r", "g", "b") if cfg.rainbow else ()):
        want = np.asarray(getattr(jst, name))
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want, atol=5e-3, rtol=0,
                                   err_msg=name)
    jp = np.asarray(jst.p)
    if route == "jacobi_rainbow":
        assert not got["p"].any() and not jp.any()
    elif route == "jacobi_fused":
        np.testing.assert_array_equal(got["p"], developed_numpy(64)[1]["p"])
        np.testing.assert_array_equal(jp, developed_numpy(64)[1]["p"])
    else:
        scale = max(1.0, float(np.abs(jp).max()))
        np.testing.assert_allclose(got["p"], jp, atol=5e-4 * scale, rtol=0)
    assert int(got["frame_count"]) == int(jst.frame_count)
    assert 1 <= int(stats["n_active"]) <= cfg.max_substeps
    assert int(stats["pcg_iters"]) > 0


@pytest.mark.parametrize("kind", ["sources", "ic0"])
def test_sources_and_ic0_still_raise(kind):
    """Neither raises any more (the port has source emission and P1 with
    IC(0)): the speed mode with a source runs unfused and draws from the
    RNG, and raises only above cfl 1, as every slot route does; IC(0)
    runs P1 and P2 (their plain versions here) and takes iterations, and
    MG with the frame-stale hierarchy (`mg_frame_hierarchy`, M14 part c),
    still not ported, raises."""
    scn, st = port_state(developed_numpy(64))
    cfg = speed_config(64)
    if kind == "sources":
        source = torch.zeros_like(scn.source)
        source[50, 40] = True  # in the air above the water
        scn = dataclasses.replace(
            scn, source=source,
            source_yx=torch.tensor([[50, 40]], dtype=torch.int32),
            source_valid=torch.tensor([True]))
        assert sim.route(cfg, scn)[0] != "fused"
        new = sim.step_frame(cfg, scn, st)
        assert not torch.equal(new.rng, st.rng)
        cfg = dataclasses.replace(cfg, cfl=1.5)
    else:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, preconditioner="ic0", max_iterations=20))
        assert sim.route(cfg, scn) == ("plain", "P1")
        new, stats = sim.step_frame_stats(cfg, scn, st)
        assert int(stats["pcg_iters"]) > 0
        assert bool(torch.isfinite(new.u).all())
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, preconditioner="mg", mg_frame_hierarchy=True))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sim.step_frame(cfg, scn, st)
