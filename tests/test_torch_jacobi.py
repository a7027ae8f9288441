"""K8 and K9's plain versions, and the port's `project()`, against the
JAX package on the CPU (Pallas in interpret mode).

  * K8 converged (tol 1e-4, tests/test_pallas_markers.py:150-165): p atol
    5e-3;
  * K8 at the speed-mode budget (100 iterations, tol_rel 1e-6): the same
    iteration count, p within 2e-5 of its scale and the final max|r|
    within 5% (the plain loop and the Pallas kernel sum their dot
    products in different orders; over 100 unconverged CG steps that
    moved p by 4.5e-6 of its scale, and the final residual, ~4e-5 of
    max|b|, by 1.4%, on this 64² system);
  * `project()` warm: Jacobi (K8) u/v atol 5e-4
    (tests/test_fused_projection.py:51-54); MG (K3) p atol 5e-4 of scale,
    iterations within 1 (PR 1's K3 tolerances);
  * K9 vs `project_pallas`: u/v atol 5e-4, and msq exactly
    `max_speed_sq` of its own outputs (:56-59); on a zero RHS 0
    iterations and msq 0 (:62-80).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import project as jproject
from euler_tpu.ops.forces import max_speed_sq as jmax_speed_sq
from euler_tpu.ops.pallas.pcg_kernel import (
    project_pallas,
    solve_pressure_pallas,
)
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.ops import project as tproject
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import pcg_kernel as k89
from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
from euler_tpu_torch.ops.forces import max_speed_sq

from torch_parity import (
    developed_numpy,
    jax_config,
    n,
    pallas_interpret,
    port_config,
    port_state,
    speed_config,
)

DT = 0.03


def _j(a):
    return jnp.asarray(n(a))


@pytest.fixture(scope="module")
def random_system():
    """tests/test_pallas_markers.py's 64² system: a random RHS on a fluid
    block above a solid row."""
    N = 64
    rng = np.random.default_rng(0)
    fluid = np.zeros((N, N), bool)
    fluid[2:-2, 2:-2] = True
    solid = np.zeros((N, N), bool)
    solid[1] = True
    fluid &= ~solid
    b = rng.standard_normal((N, N)).astype(np.float32) * fluid
    cfg = SimConfig(nx=N, ny=N, solver=SolverConfig(
        max_iterations=400, tol=1e-4, dtype="float32"))
    a = tproject.pressure_matrix_diag(cfg, torch.as_tensor(solid),
                                      torch.as_tensor(fluid))
    return cfg, torch.as_tensor(b), a, torch.as_tensor(fluid)


@pytest.fixture(scope="module")
def substep_system():
    """The developed 64² dam break's own projection system: the advected
    velocities of a substep, their RHS, the diagonal and the masks."""
    cfg = speed_config(64)
    scn, st = port_state(developed_numpy(64))
    dt = torch.tensor(DT)
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = tproject.divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = tproject.pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return dict(dt=dt, ut=ut, vt=vt, b=b, a=a, fluid=st.fluid,
                solid=scn.solid, p0=st.p)


def _solve_both(cfg, b, a, fluid):
    got = k89.solve_pressure_jacobi(cfg, b, a, fluid)
    want = solve_pressure_pallas(jax_config(cfg), _j(b), _j(a), _j(fluid),
                                 True)
    return got, want


def test_k8_converged_matches_pallas(random_system):
    cfg, b, a, fluid = random_system
    (p, it, res), (jp, jit_, jres) = _solve_both(cfg, b, a, fluid)
    assert float(res) <= cfg.solver.tol and float(jres) <= cfg.solver.tol
    np.testing.assert_allclose(n(p), n(jp), atol=5e-3, rtol=0)
    assert abs(int(it) - int(jit_)) <= 1


def test_k8_speed_budget_matches_pallas(substep_system):
    cfg = speed_config(64)
    s = substep_system
    (p, it, res), (jp, jit_, jres) = _solve_both(cfg, s["b"], s["a"],
                                                 s["fluid"])
    assert int(it) == int(jit_) == cfg.solver.max_iterations
    scale = float(np.abs(n(jp)).max())
    np.testing.assert_allclose(n(p), n(jp), atol=2e-5 * scale, rtol=0)
    np.testing.assert_allclose(float(res), float(jres), rtol=5e-2)


def test_k8_zero_rhs_exits_at_once(substep_system):
    s = substep_system
    p, it, res = k89.solve_pressure_jacobi(speed_config(64),
                                           torch.zeros_like(s["b"]), s["a"],
                                           s["fluid"])
    assert int(it) == 0 and float(res) == 0.0 and not p.any()


@pytest.mark.parametrize("precon", ["jacobi", "mg"])
def test_project_matches_jax(substep_system, precon):
    """`project()` warm-started from the developed state's pressure: K8
    (which ignores the guess, as its Pallas kernel does) or K3."""
    s = substep_system
    cfg = port_config(64) if precon == "mg" else speed_config(64)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, warm_start=True, fuse_projection=False))
    u2, v2, info = tproject.project(cfg, s["dt"], s["ut"], s["vt"],
                                    s["fluid"], s["solid"], p0=s["p0"])
    with pallas_interpret():
        ju2, jv2, jinfo = jproject.project(
            jax_config(cfg), _j(s["dt"]), _j(s["ut"]), _j(s["vt"]),
            _j(s["fluid"]), _j(s["solid"]), p0=_j(s["p0"]))
    if precon == "jacobi":
        np.testing.assert_allclose(n(u2), n(ju2), atol=5e-4, rtol=0)
        np.testing.assert_allclose(n(v2), n(jv2), atol=5e-4, rtol=0)
        assert int(info["iterations"]) == int(jinfo["iterations"])
    else:
        jp = n(jinfo["pressure"])
        scale = float(np.abs(jp).max())
        np.testing.assert_allclose(n(info["pressure"]), jp,
                                   atol=5e-4 * scale, rtol=0)
        assert abs(int(info["iterations"]) - int(jinfo["iterations"])) <= 1
        np.testing.assert_allclose(n(u2), n(ju2), atol=5e-4, rtol=0)
        np.testing.assert_allclose(n(v2), n(jv2), atol=5e-4, rtol=0)
    assert (n(info["pressure"]) >= 0).all()


def test_k9_matches_pallas(substep_system):
    s = substep_system
    cfg = speed_config(64)
    u2, v2, it, res, msq = k89.project_jacobi(cfg, s["dt"], s["ut"],
                                              s["vt"], s["fluid"],
                                              s["solid"])
    ju2, jv2, jit_, jres, jmsq = project_pallas(
        jax_config(cfg), _j(s["dt"]), _j(s["ut"]), _j(s["vt"]),
        _j(s["fluid"]), _j(s["solid"]), True)
    np.testing.assert_allclose(n(u2), n(ju2), atol=5e-4, rtol=0)
    np.testing.assert_allclose(n(v2), n(jv2), atol=5e-4, rtol=0)
    assert abs(int(it) - int(jit_)) <= 1
    assert float(msq) == float(max_speed_sq(cfg, u2, v2))
    assert float(jmsq) == float(jmax_speed_sq(jax_config(cfg), ju2, jv2))


def test_k9_zero_rhs():
    """All air: the zero RHS takes the all-zero early-out and the face
    update leaves the velocities zero."""
    cfg = SimConfig(nx=32, ny=32, solver=SolverConfig(
        max_iterations=50, dtype="float32", preconditioner="jacobi"))
    z = torch.zeros((32, 32))
    none = torch.zeros((32, 32), dtype=torch.bool)
    u2, v2, it, res, msq = k89.project_jacobi(cfg, torch.tensor(0.05), z, z,
                                              none, none)
    assert int(it) == 0 and float(msq) == 0.0
    assert not u2.any() and not v2.any()


@pytest.mark.parametrize("kernel", ["K8", "K9"])
def test_wrappers_take_plain_version_on_cpu(substep_system, kernel):
    s = substep_system
    cfg = speed_config(64)
    before = _build.PLAIN_CALLS[kernel]
    if kernel == "K8":
        got = k89.solve_pressure_jacobi(cfg, s["b"], s["a"], s["fluid"])
        want = k89.solve_pressure_jacobi_plain(cfg, s["b"], s["a"],
                                               s["fluid"])
    else:
        args = (cfg, s["dt"], s["ut"], s["vt"], s["fluid"], s["solid"])
        got = k89.project_jacobi(*args)
        want = k89.project_jacobi_plain(*args)
    assert _build.PLAIN_CALLS[kernel] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
