"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a host without an NVIDIA GPU (the
kernels have no CPU mode).  Imports nothing of JAX, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from euler_tpu_torch import sim
from euler_tpu_torch.config import SimConfig, SolverConfig
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.cuda import mg_kernel as k3
from euler_tpu_torch.ops.cuda import pcg_kernel as k89
from euler_tpu_torch.ops.cuda import substep_kernel as k2
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag

pytestmark = pytest.mark.cuda

SIZE = 128


def _cfg(size=SIZE):
    return SimConfig(
        nx=size, ny=size, marker_layout="slots",
        solver=SolverConfig(max_iterations=100, dtype="float32",
                            tol_rel=1e-4, preconditioner="mg",
                            warm_start=True, fuse_projection=True))


@pytest.fixture(scope="module")
def developed():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = _cfg()
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(4):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    return cfg, scn, st, dt


@pytest.mark.parametrize("mask", ["state", "shifted"])
def test_marker_pass_bitwise(developed, mask):
    """The state's own fluid mask, and one that is not count > 0: the
    kernel reads the mask it is given, as the plain version does."""
    cfg, scn, st, dt = developed
    K = cfg.slots_per_cell
    fluid = st.fluid
    if mask == "shifted":
        fluid = (fluid | torch.roll(fluid, 1, 0)).contiguous()
        assert not torch.equal(fluid, st.marker_count > 0)
    args = (cfg, st.u, st.v, fluid, scn.solid,
            st.markers.reshape(2 * K, cfg.ny, cfg.nx), dt, st.marker_count)
    dead = scn.sink | scn.solid
    got = k1.march_rebin(*args, dead=dead)
    want = k1.march_rebin_plain(*args, dead=dead)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_substep_matches_plain(developed):
    cfg, scn, st, dt = developed
    args = (cfg, dt, dt, st.u, st.v, st.fluid, st.prev_fluid, scn.solid,
            st.p)
    u, v, it, _, msq, _ = k2.project_substep_mg(*args)
    up, vp, itp, _, msqp, _ = k2.project_substep_mg_plain(*args)
    assert (u - up).abs().max() <= 2e-3 and (v - vp).abs().max() <= 2e-3
    assert abs(int(it) - int(itp)) <= 1
    assert abs(float(msq) - float(msqp)) <= 1e-3 * float(msqp)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_matches_plain(developed, warm):
    cfg, scn, st, dt = developed
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    x0 = st.p if warm else None
    p, it, _ = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=x0)
    pp, itp, _ = k3.solve_pressure_mg_plain(cfg, b, a, st.fluid, x0)
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()
    assert abs(int(it) - int(itp)) <= 1


@pytest.mark.parametrize("size,degree", [(128, 2), (32, 1)])
def test_solve_other_schedules(developed, size, degree):
    """Chebyshev degree 2 (the general smoother kernels) and a grid that
    is its own coarsest level (one-level cycle)."""
    import dataclasses

    cfg = _cfg(size)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, mg_cheby_degree=degree))
    scn, st = dam_break(cfg, device="cuda")
    st = sim.step_frame(cfg, scn, st)
    dt = torch.tensor(0.05, device="cuda")
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    p, it, _ = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    pp, itp, _ = k3.solve_pressure_mg_plain(cfg, b, a, st.fluid, st.p)
    assert int(itp) > 0
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()
    assert abs(int(it) - int(itp)) <= 1


def test_frames_match_cpu_plain(developed):
    cfg = _cfg(64)
    scn_g, st_g = dam_break(cfg, device="cuda")
    scn_c, st_c = dam_break(cfg, device="cpu")
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
        st_c = sim.step_frame(cfg, scn_c, st_c)
    assert torch.equal(st_g.marker_count.cpu(), st_c.marker_count)
    assert (st_g.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (st_g.v.cpu() - st_c.v).abs().max() <= 5e-3


def _speed(cfg):
    """The Jacobi speed mode on `cfg`'s grid (bench.py --precon jacobi)."""
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, preconditioner="jacobi", tol=1e-6, tol_rel=1e-6,
        warm_start=False))


def _jacobi_system(developed):
    cfg, scn, st, dt = developed
    cfg = _speed(cfg)
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    return cfg, scn, st, dt, ut, vt


def test_jacobi_solve_matches_plain(developed):
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    p, it, _ = k89.solve_pressure_jacobi(cfg, b, a, st.fluid)
    pp, itp, _ = k89.solve_pressure_jacobi_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp) > 0
    assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()


def test_jacobi_project_matches_plain(developed):
    cfg, scn, st, dt, ut, vt = _jacobi_system(developed)
    args = (cfg, dt, ut, vt, st.fluid, scn.solid)
    u, v, it, _, msq = k89.project_jacobi(*args)
    up, vp, itp, _, msqp = k89.project_jacobi_plain(*args)
    assert (u - up).abs().max() <= 2e-3 and (v - vp).abs().max() <= 2e-3
    assert abs(int(it) - int(itp)) <= 1
    assert abs(float(msq) - float(msqp)) <= 1e-3 * float(msqp)


@pytest.mark.parametrize("active", [True, False])
def test_jacobi_substep_matches_plain(developed, active):
    cfg, scn, st, dt = developed
    cfg = _speed(cfg)
    dt_proj = dt if active else torch.tensor(float("inf"), device="cuda")
    if not active:
        dt = torch.zeros((), device="cuda")
    args = (cfg, dt, dt_proj, st.u, st.v, st.fluid, st.prev_fluid,
            scn.solid)
    u, v, it, res, msq = k2.project_substep_jacobi(*args)
    up, vp, itp, _, msqp = k2.project_substep_jacobi_plain(*args)
    assert (u - up).abs().max() <= 2e-3 and (v - vp).abs().max() <= 2e-3
    assert abs(int(it) - int(itp)) <= 1
    assert abs(float(msq) - float(msqp)) <= 1e-3 * float(msqp)
    if not active:
        assert int(it) == 0 and float(res) == 0.0
        assert torch.isfinite(u).all() and torch.isfinite(v).all()


@pytest.mark.parametrize("route", ["jacobi_fused", "jacobi_unfused",
                                   "jacobi_rainbow", "mg_rainbow"])
def test_route_frames_match_cpu_plain(developed, route):
    cfg = _cfg(64)
    if route != "mg_rainbow":
        cfg = _speed(cfg)
    cfg = dataclasses.replace(cfg, rainbow=route.endswith("rainbow"),
                              solver=dataclasses.replace(
                                  cfg.solver,
                                  fuse_projection=route != "jacobi_unfused"))
    scn_g, st_g = dam_break(cfg, device="cuda")
    scn_c, st_c = dam_break(cfg, device="cpu")
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
        st_c = sim.step_frame(cfg, scn_c, st_c)
    assert torch.equal(st_g.marker_count.cpu(), st_c.marker_count)
    for name in ("u", "v", "r", "g", "b"):
        a, b = getattr(st_g, name).cpu(), getattr(st_c, name)
        assert (a - b).abs().max() <= 5e-3, name
