"""K7's tiled launch (`csrc/grid_stage.cuh` `grid_passes`), checked on
the CPU as plain Python (imports nothing of JAX; runs in seconds):

  * the halo reach: a tile's ut and vt (and the rainbow form's uu, vv)
    are a function of u and v within 2 cells of the tile and of the masks
    within 2 cells before and 3 after it, the window the kernel stages in
    shared memory.  `grid_stage_plain` on seeded states
    (tests/grid_states.py: a developed dam break with newly fluid and
    solid cells on the tiles' borders) with u and v set to NaN outside
    that window and the masks flipped at random outside theirs gives the
    tile's cells bit for bit;
  * `grid_tile_plan` covers every cell exactly once, at the route sizes
    and at ragged ones, within the shared memory a launch gets, and
    raises for a tile the kernel does not take;
  * the rainbow form `grid_stage(..., extrapolated=True)` returns
    `extrapolate_zero`'s planes beside the same ut and vt;
  * every substep route that is not fused takes its grid stage from
    K7's wrapper, in rainbow mode its extrapolated form, while
    `sim.route` keeps naming the JAX package's choice.
"""

import dataclasses

import numpy as np
import pytest
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import grid_kernel as k7
from euler_tpu_torch.ops.cuda import mg_kernel as k3
from euler_tpu_torch.ops.cuda import pcg_kernel as k89
from euler_tpu_torch.ops.cuda import substep_kernel as k2
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.forces import max_speed_sq

from grid_states import grid_state

torch.set_num_threads(1)

# the window the kernel stages around a tile: (before, after) in cells
UV_HALO = (2, 2)
MASK_HALO = (2, 3)


def _bits(t):
    return t.contiguous().view(torch.int32)


def _window(lo, hi, n, halo):
    return slice(max(lo - halo[0], 0), min(hi + halo[1], n))


def _outside(Y, X, ys, xs):
    out = np.ones((Y, X), bool)
    out[ys, xs] = False
    return torch.as_tensor(out)


@pytest.mark.parametrize("Y,X,tile", [
    (48, 80, (8, 32)),
    (37, 53, (8, 32)),
    (37, 53, (4, 32)),
    (48, 80, (k7.TILE_Y, k7.TILE_X)),
])
def test_halo_reach(Y, X, tile):
    cfg, u, v, fluid, prev, solid, dt = grid_state(Y, X, tile, seed=Y * X)
    plan = k7.grid_tile_plan(Y, X, *tile)
    want = k7.grid_stage(cfg, u, v, fluid, prev, solid, dt,
                         extrapolated=True)
    rng = np.random.default_rng(Y + X)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            y0, x0 = ty * plan.tile_y, tx * plan.tile_x
            y1, x1 = min(y0 + plan.tile_y, Y), min(x0 + plan.tile_x, X)
            far = _outside(Y, X, _window(y0, y1, Y, UV_HALO),
                           _window(x0, x1, X, UV_HALO))
            far_mask = _outside(Y, X, _window(y0, y1, Y, MASK_HALO),
                                _window(x0, x1, X, MASK_HALO))

            def flip(m):
                r = torch.as_tensor(rng.random((Y, X)) < 0.5)
                return torch.where(far_mask, r, m)

            nan = torch.tensor(float("nan"))
            got = k7.grid_stage(cfg, torch.where(far, nan, u),
                                torch.where(far, nan, v), flip(fluid),
                                flip(prev), flip(solid), dt,
                                extrapolated=True)
            for g, w in zip(got, want):
                assert torch.equal(_bits(g[y0:y1, x0:x1]),
                                   _bits(w[y0:y1, x0:x1])), (y0, x0)


@pytest.mark.parametrize("Y,X,tile_x", [
    (64, 64, 32), (1024, 1024, 32), (2048, 2048, 64), (4096, 4096, 64),
    (100, 257, 32), (257, 100, 32), (37, 53, 32), (1, 1, 32), (8, 1, 32),
    (4096, 1000, 64), (1000, 4100, 32)])
def test_tile_plan_covers_every_cell_once(Y, X, tile_x):
    plan = k7.grid_tile_plan(Y, X)
    assert plan.tile_x == tile_x
    assert plan.smem_bytes == k7.grid_tile_smem_bytes(plan.tile_y,
                                                      plan.tile_x)
    assert plan.smem_bytes <= k7.SMEM_BYTES_MAX
    assert plan.threads % 32 == 0 and plan.tile_x in k7.TILE_XS
    for n, tile, tiles in ((Y, plan.tile_y, plan.tiles_y),
                           (X, plan.tile_x, plan.tiles_x)):
        cover = np.zeros(n, int)
        for i in range(tiles):
            cover[i * tile:(i + 1) * tile] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("tile_y,tile_x,threads", [
    (16, 48, 256), (16, 32, 1024), (16, 32, 100), (64, 128, 256),
    (0, 32, 256)])
def test_tile_plan_refuses_what_the_kernel_does_not_take(tile_y, tile_x,
                                                         threads):
    with pytest.raises(ValueError, match="no K7 tile"):
        k7.grid_tile_plan(1024, 1024, tile_y, tile_x, threads)


def test_extrapolated_form_on_cpu():
    cfg, u, v, fluid, prev, solid, dt = grid_state(48, 80, (8, 32))
    before = _build.PLAIN_CALLS["K7"]
    ut, vt, uu, vv = k7.grid_stage(cfg, u, v, fluid, prev, solid, dt,
                                   extrapolated=True)
    assert _build.PLAIN_CALLS["K7"] == before + 1
    want = (k7.grid_stage_plain(cfg, dt, u, v, fluid, prev, solid)
            + k7.extrapolate_zero(cfg, u, v, fluid, prev, solid))
    for g, w in zip((ut, vt, uu, vv), want):
        assert torch.equal(_bits(g), _bits(w))
    two = k7.grid_stage(cfg, u, v, fluid, prev, solid, dt)
    assert len(two) == 2
    assert torch.equal(_bits(two[0]), _bits(ut))
    assert torch.equal(_bits(two[1]), _bits(vt))


def _mg(size, fuse_projection=True):
    return SimConfig(nx=size, ny=size, marker_layout="slots",
                     solver=SolverConfig(max_iterations=100,
                                         dtype="float32", tol_rel=1e-4,
                                         preconditioner="mg",
                                         warm_start=True,
                                         fuse_projection=fuse_projection))


def _jacobi(size, fuse_projection=True):
    return SimConfig(nx=size, ny=size, marker_layout="slots",
                     solver=SolverConfig(max_iterations=100, tol=1e-6,
                                         tol_rel=1e-6, dtype="float32",
                                         preconditioner="jacobi",
                                         warm_start=False,
                                         fuse_projection=fuse_projection))


# route: (config, the route `sim.route` names)
ROUTES = {
    "jacobi_unfused": (_jacobi(32, fuse_projection=False), ("plain", "K8")),
    "mg_unfused": (_mg(32, fuse_projection=False), ("plain", "K3")),
    "pallas_grid": (dataclasses.replace(_jacobi(32, fuse_projection=False),
                                        use_pallas_grid=True), ("K7", "K8")),
    "k9": (_jacobi(32), ("plain", "K9")),
    "k11": (_mg(128), ("plain", "K11")),
    "k12": (_jacobi(32), ("plain", "K12")),
    "jacobi_rainbow": (dataclasses.replace(_jacobi(32), rainbow=True),
                       ("plain", "K9")),
    "mg_rainbow": (dataclasses.replace(_mg(32), rainbow=True),
                   ("plain", "K3")),
    "mg_fused": (_mg(32), ("fused", "K2")),
    "jacobi_fused": (_jacobi(32), ("fused", "K10")),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_unfused_routes_take_k7(route, monkeypatch):
    """One substep of each route: the grid stage of every route that is
    not fused is one call of K7's wrapper (the extrapolated form in
    rainbow mode), which the fused routes do not call."""
    cfg, want = ROUTES[route]
    if route == "k9":
        monkeypatch.setattr(k2, "substep_jacobi_fused_fits", lambda c: False)
    if route == "k11":
        monkeypatch.setattr(k2, "substep_fused_fits", lambda c: False)
        monkeypatch.setattr(k3, "mg_pallas_fits", lambda c: False)
    if route == "k12":
        monkeypatch.setattr(k89, "pallas_solver_fits", lambda c: False)
        monkeypatch.setattr(k89, "fused_projection_fits", lambda c: False)
        monkeypatch.setattr(k2, "substep_jacobi_fused_fits", lambda c: False)
    calls = []
    wrapper = k7.grid_stage

    def counting(*args, **kwargs):
        calls.append(kwargs.get("extrapolated", False))
        return wrapper(*args, **kwargs)

    monkeypatch.setattr(k7, "grid_stage", counting)
    scn, st = dam_break(cfg, device="cpu")
    assert sim.route(cfg, scn) == want
    msq = max_speed_sq(cfg, st.u, st.v)
    dt = sim._dt_from_msq(cfg, msq, torch.tensor(cfg.frame_time))
    new, _, _ = sim.substep(cfg, scn, st, dt, dt)
    assert calls == ([] if want[0] == "fused" else [cfg.rainbow])
    for name in ("u", "v"):
        assert torch.isfinite(getattr(new, name)).all()


class _FakeLib:
    """Stands in for a loaded library: records what `_build.bind` sets."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("eu_"):
            return self.fns.setdefault(name, type("Fn", (), {})())
        raise AttributeError(name)


def _entries(source: str) -> dict:
    """{name: number of parameters} of the EU_API functions of a source
    and the headers it may include."""
    import re

    csrc = _build.CSRC
    text = "".join(p.read_text() for p in [csrc / source]
                   + sorted(csrc.glob("*.cuh")))
    return {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
            for m in re.finditer(r"EU_API\s+int\s+(eu_\w+)\s*\(([^)]*)\)",
                                 text)}


@pytest.mark.parametrize("loader,source", [
    ("grid_kernel.grid_lib", "grid_stage.cu"),
    ("pcg_kernel.jacobi_lib", "jacobi_pcg.cu"),
    ("marker_fused_kernel.marker_lib", "marker_pass.cu"),
    ("mg_kernel._lib", "mg_pcg.cu"),
    ("mg_kernel._stream_lib", "mg_stream.cu"),
    ("pcg_stream_kernel.stream_lib", "jacobi_stream.cu"),
    ("source_kernel.source_lib", "sources.cu"),
    ("global_marker_kernel.global_lib", "global_markers.cu"),
    ("pcg_general_kernel.general_lib", "pcg_general.cu"),
    ("pcg_general_kernel.mg_lib", "pcg_mg.cu"),
    ("pcg_shard_kernel.shard_lib", "pcg_shard.cu"),
    ("pcg_mg_blocks_kernel.blocks_lib", "pcg_mg_blocks.cu"),
    ("pcg_ic0_blocks_kernel.ic0_blocks_lib", "pcg_ic0_blocks.cu")])
def test_bindings_match_the_sources(loader, source, monkeypatch):
    """Every entry a wrapper binds takes as many arguments in the CUDA
    source as its ctypes binding passes (ctypes passes what it is given:
    a count that differs shifts every argument after it)."""
    import importlib

    module, fn = loader.split(".")
    mod = importlib.import_module(f"euler_tpu_torch.ops.cuda.{module}")
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name, flags=(): lib)
    load = getattr(mod, fn)
    getattr(load, "__wrapped__", load)()
    entries = _entries(source)
    assert lib.fns
    for name, bound in lib.fns.items():
        assert len(bound.argtypes) == entries[name], name
