"""Galerkin multigrid: the port's hierarchy, Chebyshev rows, cycle and
plain MG-PCG against the JAX package (the solve against the Pallas MG
kernel in interpret mode)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import multigrid as jmg
from euler_tpu.ops.pallas import mg_kernel as jmgk
from euler_tpu_torch.ops import multigrid as tmg
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag

from torch_parity import (
    developed_numpy,
    jax_config,
    n,
    port_config,
    port_state,
    t,
)


def _mask(Y, X, seed=0):
    """Dam-break-like fluid with speckles, solid walls inside a border."""
    rng = np.random.default_rng(seed)
    fluid = np.zeros((Y, X), bool)
    fluid[2:int(Y * 0.6), 2:int(X * 0.5)] = True
    fluid |= rng.random((Y, X)) < 0.08
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    solid = np.zeros((Y, X), bool)
    solid[1, 1:-1] = solid[1:-1, 1] = solid[1:-1, X - 2] = True
    fluid &= ~solid
    return fluid, solid


def _a_diag(solid, fluid):
    cfg = port_config(solid.shape[0])
    return pressure_matrix_diag(cfg, t(solid), t(fluid))


@pytest.mark.parametrize("shape", [(128, 128), (90, 130)])  # 45x65 pads
def test_hierarchy_exact(shape):
    fluid, solid = _mask(*shape)
    a = _a_diag(solid, fluid)
    got = tmg.build_galerkin_hierarchy(a, t(fluid), torch.float32)
    want = jmg.build_galerkin_hierarchy(jnp.asarray(n(a)),
                                        jnp.asarray(fluid), jnp.float32)
    assert len(got) == len(want) >= 3
    for lg, lw in zip(got, want):
        for f in ("c", "e", "n", "active", "lmax", "inv_c"):
            np.testing.assert_array_equal(n(getattr(lg, f)),
                                          np.asarray(getattr(lw, f)),
                                          err_msg=f)


def test_chebyshev_rows():
    cfg = port_config(128)
    jcfg = jax_config(cfg, interpret=False)
    fluid, solid = _mask(128, 128, seed=1)
    a = _a_diag(solid, fluid)
    shapes, packed0, planes, rows = tmgk.mg_host_operands(cfg, a, t(fluid))
    jshapes, _, jpacked0, jplanes, jrows, _, _ = jmgk.mg_host_operands(
        jcfg, jnp.asarray(n(a)), jnp.asarray(fluid))
    assert [tuple(s) for s in shapes] == [tuple(s) for s in jshapes]
    assert shapes == tmgk._level_shapes(128, 128, 32)
    np.testing.assert_array_equal(n(packed0), np.asarray(jpacked0))
    np.testing.assert_array_equal(
        np.concatenate([n(p).ravel() for lv in planes for p in lv]),
        np.concatenate([np.asarray(p).ravel() for p in jplanes]))
    np.testing.assert_allclose(n(rows), np.asarray(jrows), rtol=1e-6)


def test_cycle_matches_jax():
    cfg = port_config(128)
    s = cfg.solver
    fluid, solid = _mask(128, 128, seed=2)
    a = _a_diag(solid, fluid)
    b = np.where(fluid, np.random.default_rng(3).standard_normal(
        fluid.shape), 0).astype(np.float32)
    levels = tmg.build_galerkin_hierarchy(a, t(fluid), torch.float32)
    jlevels = jmg.build_galerkin_hierarchy(jnp.asarray(n(a)),
                                           jnp.asarray(fluid), jnp.float32)
    kw = dict(coarse_iters=s.mg_coarse_iters, w=2,
              cheby_degree=s.mg_cheby_degree, cheby_ratio=s.mg_cheby_ratio,
              coarse_ratio=s.mg_coarse_ratio, w_depth=s.mg_w_depth)
    got = tmg.cycle_galerkin(levels, t(b), **kw)
    want = jmg.cycle_galerkin(jlevels, jnp.asarray(b), smoother="cheby",
                              **kw)
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5 * scale,
                               rtol=0)


@pytest.fixture(scope="module")
def system():
    """A real substep system at 64²: the RHS of the advected velocities
    of a developed dam break, and the previous pressure as warm guess."""
    cfg = port_config(64)
    scn, st = port_state(developed_numpy(64))
    dt = torch.tensor(0.03)
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return cfg, b, a, st.fluid, scn.solid, st.p


@pytest.mark.parametrize("warm,degree", [(False, 1), (True, 1), (True, 2)])
def test_plain_solve_matches_pallas_kernel(system, warm, degree):
    cfg, b, a, fluid, solid, p0 = system
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, mg_cheby_degree=degree))
    jcfg = jax_config(cfg, interpret=False)
    x0 = p0 if warm else None
    p, iters, resid = tmgk.solve_pressure_mg(cfg, b, a, fluid, solid, x0=x0)
    jp, jiters, jresid = jmgk.solve_pressure_mg_pallas(
        jcfg, jnp.asarray(n(b)), jnp.asarray(n(a)), jnp.asarray(n(fluid)),
        jnp.asarray(n(solid)), True,
        x0=None if x0 is None else jnp.asarray(n(x0)))
    scale = float(np.abs(np.asarray(jp)).max())
    assert scale > 0
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=5e-4 * scale,
                               rtol=0)
    assert abs(int(iters) - int(jiters)) <= 1
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * float(b.abs().max()))
    assert float(resid) <= tol and float(jresid) <= tol


def test_wrapper_counts_plain_calls_on_cpu(system):
    cfg, b, a, fluid, solid, _ = system
    before = _build.PLAIN_CALLS["K3"]
    tmgk.solve_pressure_mg(cfg, b, a, fluid, solid)
    assert _build.PLAIN_CALLS["K3"] == before + 1


def test_all_zero_rhs_exits_at_once(system):
    cfg, b, a, fluid, solid, p0 = system
    p, iters, resid = tmgk.solve_pressure_mg(cfg, torch.zeros_like(b), a,
                                             fluid, solid, x0=p0)
    assert int(iters) == 0 and float(resid) == 0.0
    assert not p.any()
