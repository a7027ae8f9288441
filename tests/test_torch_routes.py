"""The port picks its routes by the JAX package's own size gates.

For every size of {64, 128, 1024, 1200, 1448, 1536, 2048, 2560, 4096},
both preconditioners, and every setting of fuse_projection, rainbow and
use_pallas_grid, `sim.route` names the grid stage and the projection
kernel that the JAX `sim.substep` and `ops/project.solve_pressure` pick
(sim.py:43-78, 141-212; project.py:191-223), and the level skip of K11
(`_resident_start`, F) is the JAX package's.  Where the JAX package falls
through to its jnp `pcg_loop`, the port raises naming ROADMAP M11.
"""

import dataclasses
import itertools
import types

import pytest

from euler_tpu import sim as jsim
from euler_tpu.ops.pallas import mg_kernel as jmg
from euler_tpu.ops.pallas import mg_stream_kernel as jms
from euler_tpu.ops.pallas import pcg_kernel as jpcg
from euler_tpu.ops.pallas import pcg_stream_kernel as jps
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
    return grid, None


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
    rows not a multiple of 8: the JAX package's jnp pcg_loop."""
    cfg = _config(size, precon, True, False, False)
    assert jax_route(jax_config(cfg))[1] is None
    with pytest.raises(NotImplementedError, match="M11"):
        sim.check_slice(cfg, NO_SOURCES)
