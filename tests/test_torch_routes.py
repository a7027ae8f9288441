"""The port picks its routes by the JAX package's own size gates.

For every size of {64, 128, 1024, 1200, 1448, 1536, 2048, 2560, 4096},
both preconditioners, and every setting of fuse_projection, rainbow and
use_pallas_grid, `sim.route` names the grid stage and the projection
kernel that the JAX `sim.substep` and `ops/project.solve_pressure` pick
(sim.py:43-78, 141-212; project.py:191-223), and the level skip of K11
(`_resident_start`, F) is the JAX package's.  Where the JAX package falls
through to its jnp `pcg_loop`, the port runs P1, and for MG P3.

`sim.marker_route` names the marker pass that the JAX `step_frame` runs
with `use_pallas_markers=True` (markers_slots.py:354-386, sim.py:266-269,
320-352), for every setting of fuse_marker_pass, marker_padded_store and
rainbow: the JAX frame is traced with recording stand-ins for its marker
kernels, which shows the kernels it calls and how often it pads the
slot store.
"""

import dataclasses
import functools
import itertools
import types

import jax
import jax.numpy as jnp
import pytest

from euler_tpu import sim as jsim
from euler_tpu.core.presets import dam_break as jdam_break
from euler_tpu.ops.pallas import marker_fused_kernel as jfused
from euler_tpu.ops.pallas import marker_kernel as jmarch
from euler_tpu.ops.pallas import mg_kernel as jmg
from euler_tpu.ops.pallas import mg_stream_kernel as jms
from euler_tpu.ops.pallas import pcg_kernel as jpcg
from euler_tpu.ops.pallas import pcg_stream_kernel as jps
from euler_tpu.ops.pallas import rebin_kernel as jrebin
from euler_tpu_torch import sim
from euler_tpu_torch.ops.cuda import mg_stream_kernel as tms

from torch_parity import jax_config, port_config, speed_config

SIZES = [64, 128, 1024, 1200, 1448, 1536, 2048, 2560, 4096]
NO_SOURCES = types.SimpleNamespace(num_sources=0)


def jax_route(jcfg):
    """The route the JAX package takes, from its own gates."""
    mg = jcfg.solver.preconditioner == "mg"
    if jsim._use_fused_substep(jcfg, NO_SOURCES):
        return "fused", "K2" if mg else "K10"
    grid = "K7" if jcfg.use_pallas_grid and not jcfg.rainbow else "plain"
    if jsim._use_fused_projection(jcfg):
        return grid, "K9"
    for fits, kernel in ((jpcg.pallas_solver_fits, "K8"),
                         (jmg.mg_pallas_fits, "K3"),
                         (jms.stream_mg_fits, "K11"),
                         (jps.stream_solver_fits, "K12")):
        if fits(jcfg):
            return grid, kernel
    # the jnp pcg_loop: P1 in the port, P3 for (Galerkin) MG, f32 or f64
    return grid, "P3" if mg else "P1"


def _config(size, precon, fuse, rainbow, pallas_grid):
    cfg = port_config(size) if precon == "mg" else speed_config(size)
    return dataclasses.replace(
        cfg, rainbow=rainbow, use_pallas_grid=pallas_grid,
        solver=dataclasses.replace(cfg.solver, fuse_projection=fuse))


@pytest.mark.parametrize("precon", ["mg", "jacobi"])
@pytest.mark.parametrize("size", SIZES)
def test_route_matches_jax_gates(size, precon):
    for flags in itertools.product([False, True], repeat=3):
        cfg = _config(size, precon, *flags)
        want = jax_route(jax_config(cfg))
        assert sim.route(cfg, NO_SOURCES) == want, (flags, want)


@pytest.mark.parametrize("size", SIZES)
def test_level_skip_matches_jax(size):
    cfg = port_config(size)
    shapes, ls, F = tms._root(cfg)
    jshapes = jmg._level_shapes(size, size, cfg.solver.mg_min_size)
    jls = jms._resident_start(jshapes)
    assert (shapes, ls, F) == (jshapes, jls, size // jshapes[jls][0])
    assert tms.stream_mg_fits(cfg) == jms.stream_mg_fits(jax_config(cfg))


@pytest.mark.parametrize("precon,size,want", [
    ("mg", 1024, ("fused", "K2")),
    ("mg", 2048, ("plain", "K11")),
    ("mg", 4096, ("plain", "K11")),
    ("jacobi", 1024, ("fused", "K10")),
    ("jacobi", 2048, ("plain", "K8")),
    ("jacobi", 4096, ("plain", "K12")),
])
def test_bench_defaults(precon, size, want):
    """`bench.py --size N [--precon jacobi]`: at 2048² the MG default is
    the plain grid stage and K11 (F = 2), at 4096² Jacobi is K12."""
    cfg = port_config(size) if precon == "mg" else speed_config(size)
    assert sim.route(cfg, NO_SOURCES) == want
    if want[1] == "K11":
        shapes, ls, F = tms._root(cfg)
        assert F == (2 if size == 2048 else 4)


@pytest.mark.parametrize("precon,size", [("mg", 1200), ("mg", 1448),
                                         ("jacobi", 4100)])
def test_pcg_loop_fallthrough_raises(precon, size):
    """MG whose levels do not halve evenly, Jacobi beyond K8's budget with
    rows not a multiple of 8: the JAX package's jnp pcg_loop.  Neither
    raises any more: MG runs P3 (it raised until P3 existed), Jacobi P1
    (it raised until P1 existed).  f64 MG, which the JAX package also runs
    there, runs P3 as well (it raised until the f64 levels existed), as
    the JAX chain gives its jnp loop."""
    cfg = _config(size, precon, True, False, False)
    want = jax_route(jax_config(cfg))[1]
    assert sim.route(cfg, NO_SOURCES)[1] == want
    assert want == ("P3" if precon == "mg" else "P1")
    sim.check_slice(cfg, NO_SOURCES)
    if precon == "mg":
        f64 = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, dtype="float64"))
        sim.check_slice(f64, NO_SOURCES)
        assert jax_route(jax_config(f64))[1] == "P3"
        assert sim.route(f64, NO_SOURCES) == ("plain", "P3")


@functools.lru_cache(maxsize=None)
def _jax_state(size):
    """A JAX dam break to trace a frame on (its preset's own marker pass
    as jnp ops: the Pallas one costs ~13 s of interpret compile here)."""
    return jdam_break(jax_config(speed_config(size), interpret=False))


def jax_marker_calls(jcfg, monkeypatch):
    """The marker kernels (and pad/unpad of the slot store) that the JAX
    `step_frame` calls on `jcfg`, in call order, from a trace in which
    each kernel is a stand-in that records its call and returns its
    input."""
    jscn, jst = _jax_state(jcfg.nx)
    calls = []

    def record(name, fn):
        def stand_in(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return stand_in

    def fused(cfg, u, v, fluid, solid, slots, dt, count, *args, **kwargs):
        return slots, count, count

    def rebin(cfg, px, py, valid_f, dead, *args):
        count = dead.astype(jnp.int32)
        return px, py, valid_f, count, count

    for mod, name, kernel, fn in (
            (jfused, "march_rebin_pallas", "K1", fused),
            (jfused, "march_rebin_padded", "K4", fused),
            (jmarch, "advect_markers_pallas", "K5",
             lambda cfg, u, v, fl, so, px, py, *a: (px, py)),
            (jrebin, "rebin_markers_pallas", "K6", rebin),
            (jfused, "pad_slot_store", "pad", jfused.pad_slot_store),
            (jfused, "unpad_slot_store", "unpad", jfused.unpad_slot_store)):
        monkeypatch.setattr(mod, name, record(kernel, fn))
    jax.eval_shape(functools.partial(jsim.step_frame, jcfg), jscn, jst)
    return calls


@pytest.mark.parametrize("fuse,padded,rainbow",
                         list(itertools.product([False, True], repeat=3)))
def test_marker_route_matches_jax_dispatch(monkeypatch, fuse, padded,
                                           rainbow):
    cfg = dataclasses.replace(
        speed_config(32), fuse_marker_pass=fuse,
        marker_padded_store=padded, rainbow=rainbow)
    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=True,
                               pallas_interpret=True)
    calls = jax_marker_calls(jcfg, monkeypatch)
    route = sim.marker_route(cfg, NO_SOURCES)
    # the frame's substeps are one traced scan body: one pass each
    want = {"K1": ["K1"], "K4": ["pad", "K4", "unpad"],
            "K5+K6": ["K5", "K6"]}[route]
    assert calls == want, (route, calls)
