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
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import grid_kernel as k7
from euler_tpu_torch.ops.cuda import marker_fused_kernel as k1
from euler_tpu_torch.ops.cuda import marker_kernel as k5
from euler_tpu_torch.ops.cuda import mg_kernel as k3
from euler_tpu_torch.ops.cuda import mg_stream_kernel as k11
from euler_tpu_torch.ops.cuda import pcg_kernel as k89
from euler_tpu_torch.ops.cuda import pcg_stream_kernel as k12
from euler_tpu_torch.ops.cuda import rebin_kernel as k6
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


def _develop(size):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    cfg = _cfg(size)
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(4):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    return cfg, scn, st, dt


@pytest.fixture(scope="module")
def developed():
    return _develop(SIZE)


@pytest.fixture(scope="module")
def developed256():
    """The 256² dam break 4 frames in, and its substep's own system."""
    cfg, scn, st, dt = _develop(256)
    ut, vt = k7.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return cfg, scn, st, dt, b, a


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


def _marker_args(developed, zero_dt):
    cfg, scn, st, dt = developed
    if zero_dt:
        dt = torch.zeros((), device="cuda")
    return cfg, scn, st, dt, (cfg, st.u, st.v, st.fluid, scn.solid)


@pytest.mark.parametrize("zero_dt", [False, True])
def test_march_bitwise(developed, zero_dt):
    """K5: every slot, live and dead, bitwise; dt = 0 is an identity."""
    cfg, scn, st, dt, args = _marker_args(developed, zero_dt)
    px, py = st.markers[0], st.markers[1]
    got = k5.advect_markers(*args, px, py, dt, st.marker_count)
    want = k5.advect_markers_plain(*args, px, py, dt, st.marker_count)
    for a, b, was in zip(got, want, (px, py)):
        assert torch.equal(a, b)
        assert torch.equal(a, was) == zero_dt


@pytest.mark.parametrize("zero_dt", [False, True])
def test_rebin_bitwise(developed, zero_dt):
    """K6 on K5's output with the state's alive plane, bitwise."""
    cfg, scn, st, dt, args = _marker_args(developed, zero_dt)
    px, py = k5.advect_markers(*args, st.markers[0], st.markers[1], dt,
                               st.marker_count)
    dead = scn.sink | scn.solid
    got = k6.rebin_markers(cfg, px, py, st.alive, dead)
    want = k6.rebin_markers_plain(cfg, px, py, st.alive, dead)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if zero_dt:
        assert torch.equal(torch.stack(got[:2]), st.markers)
        assert torch.equal(got[3], st.marker_count)


def _interior(out, cfg):
    """K4's outputs with the store cut to its interior."""
    slots, count, drop = out
    return (slots[:, 8:8 + cfg.ny, 128:128 + cfg.nx], count, drop)


@pytest.mark.parametrize("zero_dt", [False, True])
def test_march_rebin_padded_bitwise(developed, zero_dt):
    """K4's interior against its plain version and against K1, with
    garbage in the input's pads."""
    cfg, scn, st, dt, args = _marker_args(developed, zero_dt)
    K, Y, X = cfg.slots_per_cell, cfg.ny, cfg.nx
    store = torch.full((2 * K, Y + 16, X + 256), float("nan"), device="cuda")
    store[:, 8:8 + Y, 128:128 + X] = st.markers.reshape(2 * K, Y, X)
    dead = scn.sink | scn.solid
    got = _interior(k1.march_rebin_padded(*args, store, dt,
                                          st.marker_count, dead=dead), cfg)
    want = _interior(k1.march_rebin_padded_plain(
        *args, store, dt, st.marker_count, dead=dead), cfg)
    fused = k1.march_rebin(*args, st.markers.reshape(2 * K, Y, X), dt,
                           st.marker_count, dead=dead)
    for a, b, c in zip(got, want, fused):
        assert torch.equal(a, b) and torch.equal(a, c)
    if zero_dt:
        assert torch.equal(got[0], st.markers.reshape(2 * K, Y, X))


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


def test_grid_stage_matches_plain(developed256):
    cfg, scn, st, dt, _, _ = developed256
    args = (st.u, st.v, st.fluid, st.prev_fluid, scn.solid)
    ut, vt = k7.grid_stage(cfg, *args, dt)
    up, vp = k7.grid_stage_plain(cfg, dt, *args)
    assert (ut - up).abs().max() <= 2e-4 and (vt - vp).abs().max() <= 2e-4


@pytest.mark.parametrize("F", [2, 4])
def test_mg_stream_matches_plain(developed256, monkeypatch, F):
    """The level skip at 256²: the root one level down (F = 2, the 2048²
    transfer) or two (F = 4, the 4096² transfer)."""
    cfg, scn, st, dt, b, a = developed256
    if F == 4:
        monkeypatch.setattr(k11, "_resident_start", lambda shapes: 2)
    assert k11._root(cfg)[2] == F
    p, it, _ = k11.solve_pressure_mg_stream(cfg, b, a, st.fluid)
    pp, itp, _ = k11.solve_pressure_mg_stream_plain(cfg, b, a, st.fluid)
    assert int(itp) > 0
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()
    assert abs(int(it) - int(itp)) <= 1


def test_pcg_stream_matches_plain(developed256):
    cfg, scn, st, dt, b, a = developed256
    cfg = _speed(cfg)
    p, it, _ = k12.solve_pressure_stream(cfg, b, a, st.fluid)
    pp, itp, _ = k12.solve_pressure_stream_plain(cfg, b, a, st.fluid)
    assert int(it) == int(itp) > 0
    assert (p - pp).abs().max() <= 1e-4 * pp.abs().max()


def _gated_route(route, monkeypatch):
    """The config of a new route with the gates before it turned off."""
    if route == "K11":
        monkeypatch.setattr(k2, "substep_fused_fits", lambda c: False)
        monkeypatch.setattr(k3, "mg_pallas_fits", lambda c: False)
        return _cfg(128)
    cfg = _speed(_cfg(64))
    if route == "K12":
        monkeypatch.setattr(k89, "pallas_solver_fits", lambda c: False)
        monkeypatch.setattr(k89, "fused_projection_fits", lambda c: False)
        monkeypatch.setattr(k2, "substep_jacobi_fused_fits", lambda c: False)
        return cfg
    return dataclasses.replace(cfg, use_pallas_grid=True,
                               solver=dataclasses.replace(
                                   cfg.solver, fuse_projection=False))


@pytest.mark.parametrize("route", ["K5+K6", "K4"])
def test_marker_route_frames(developed, route):
    """2 frames of the 64² main path on a marker route: equal to the K1
    route on the card in counts, drops, u, v and the store; within the
    frame tolerances of the CPU plain versions."""
    cfg = _cfg(64)
    rcfg = dataclasses.replace(cfg, fuse_marker_pass=route != "K5+K6",
                               marker_padded_store=route == "K4")
    scn, st = dam_break(cfg, device="cuda")
    assert sim.marker_route(rcfg, scn) == route
    ref = sim.run_frames(cfg, scn, st, 2)
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = sim.run_frames(rcfg, scn, st, 2)
    launches, plain = dict(_build.LAUNCHES), sum(_build.PLAIN_CALLS.values())
    assert "K1" not in launches and plain == 0
    for k in route.split("+"):
        assert launches[k] == 16
    for name in ("marker_count", "dropped_markers", "u", "v", "markers",
                 "alive", "p"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    scn_c, st_c = dam_break(rcfg, device="cpu")
    st_c = sim.run_frames(rcfg, scn_c, st_c, 2)
    assert torch.equal(got.marker_count.cpu(), st_c.marker_count)
    assert (got.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (got.v.cpu() - st_c.v).abs().max() <= 5e-3


@pytest.mark.parametrize("route", ["K11", "K12", "K7"])
def test_new_route_frames_match_cpu_plain(developed, monkeypatch, route):
    cfg = _gated_route(route, monkeypatch)
    scn_g, st_g = dam_break(cfg, device="cuda")
    scn_c, st_c = dam_break(cfg, device="cpu")
    assert route in sim.route(cfg, scn_g)
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    for _ in range(2):
        st_g = sim.step_frame(cfg, scn_g, st_g)
    launches, plain = dict(_build.LAUNCHES), sum(_build.PLAIN_CALLS.values())
    for _ in range(2):
        st_c = sim.step_frame(cfg, scn_c, st_c)
    assert launches.get(route, 0) > 0 and plain == 0
    bypassed = {"K11": {"K2", "K3"}, "K12": {"K8", "K9", "K10"},
                "K7": {"K2", "K10"}}[route]
    assert not bypassed & set(launches)
    assert torch.equal(st_g.marker_count.cpu(), st_c.marker_count)
    assert (st_g.u.cpu() - st_c.u).abs().max() <= 5e-3
    assert (st_g.v.cpu() - st_c.v).abs().max() <= 5e-3


def _mg_system(cfg, scn, st, dt):
    """A substep's own MG system on `st`: the RHS of the advected
    velocities and the diagonal."""
    ut, vt = k2.grid_stage_plain(cfg, dt, st.u, st.v, st.fluid,
                                 st.prev_fluid, scn.solid)
    return (divergence_rhs(cfg, ut, vt, st.fluid, dt),
            pressure_matrix_diag(cfg, scn.solid, st.fluid))


def _solver(cfg, **over):
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                               **over))


@pytest.mark.parametrize("cap", [1, 3, 8, 9])
def test_solve_stops_at_the_cap(developed, cap):
    """With a tolerance no iterate meets, exactly `cap` iterations: inside
    the first graph chunk, at its end, and one into the second."""
    cfg, scn, st, dt = developed
    b, a = _mg_system(cfg, scn, st, dt)
    cfg = _solver(cfg, max_iterations=cap, tol=0.0, tol_rel=0.0)
    p, it, _ = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    pp, itp, _ = k3.solve_pressure_mg_plain(cfg, b, a, st.fluid, st.p)
    assert int(it) == int(itp) == cap
    assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()


def test_workspace_reuse_is_bitwise(developed):
    """A second solve on the same workspace with new input tensors equals
    a solve on a fresh workspace bit for bit, and returns nothing that
    aliases the workspace."""
    cfg, scn, st, dt = developed
    b, a = _mg_system(cfg, scn, st, dt)
    k3.clear_workspaces()
    k3.solve_pressure_mg(cfg, b * 0.5, a, st.fluid, x0=st.p * 2.0)
    again = k3.solve_pressure_mg(cfg, b.clone(), a.clone(), st.fluid.clone(),
                                 x0=st.p.clone())
    assert len(k3._WORKSPACES) == 1
    k3.clear_workspaces()
    fresh = k3.solve_pressure_mg(cfg, b, a, st.fluid, x0=st.p)
    for x, y in zip(again, fresh):
        assert torch.equal(x, y)
    ws = k3.workspace(cfg, b.device)
    assert {t.data_ptr() for t in fresh}.isdisjoint(
        t.data_ptr() for t in ws.keep)


def test_alternating_configs(developed):
    """Two schedules and two grid sizes in turns, each against its plain
    version: the cache hands each its own workspace and graph."""
    cfg, scn, st, dt = developed
    small = _cfg(64)
    sscn, sst = dam_break(small, device="cuda")
    sst = sim.step_frame(small, sscn, sst)
    cases = [(cfg, _mg_system(cfg, scn, st, dt), st),
             (_solver(cfg, mg_cheby_degree=2), _mg_system(cfg, scn, st, dt),
              st),
             (small, _mg_system(small, sscn, sst, dt), sst)]
    for _ in range(2):
        for c, (b, a), s in cases:
            p, it, _ = k3.solve_pressure_mg(c, b, a, s.fluid, x0=s.p)
            pp, itp, _ = k3.solve_pressure_mg_plain(c, b, a, s.fluid, s.p)
            assert int(itp) > 0 and abs(int(it) - int(itp)) <= 1
            assert (p - pp).abs().max() <= 5e-4 * pp.abs().max()


@pytest.mark.parametrize("case", ["developed1024", "speckled256"])
def test_hierarchy_bitwise(case):
    """The Galerkin hierarchy and Chebyshev rows K3 builds on the card
    equal `mg_host_operands` bit for bit: on the developed 1024² dam break
    and on a speckled 256² mask (isolated fluid cells, enclosed blocks)."""
    if case == "developed1024":
        cfg, scn, st, dt = _develop(1024)
        b, a = _mg_system(cfg, scn, st, dt)
        fluid = st.fluid
    else:
        cfg = _cfg(256)
        fluid, solid, b = _speckled(256, 3)
        a = pressure_matrix_diag(cfg, solid, fluid)
    ws = k3.workspace(cfg, b.device)
    ws.load(a, fluid, b)
    ws.solve(warm=False)
    _, packed0, planes, rows = k3.mg_host_operands(cfg, a, fluid)
    assert torch.equal(ws.packed0, packed0)
    assert len(planes) == len(ws.levels)
    for want, got in zip(planes, ws.levels):
        for x, y in zip(want, got):
            assert torch.equal(x, y)
    assert torch.equal(ws.rows, rows)


def _speckled(size, seed):
    """A speckled mask (isolated fluid cells, a filled block, scattered
    solids) and a random RHS on its fluid cells, from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator().manual_seed(seed)
    fluid = torch.rand((size, size), generator=g) < 0.3
    fluid[size // 6:size * 3 // 5, size // 12:size // 2] = True
    solid = torch.rand((size, size), generator=g) < 0.05
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    fluid &= ~solid
    fluid, solid = fluid.cuda(), solid.cuda()
    b = torch.where(fluid, torch.randn((size, size), generator=g).cuda(), 0.0)
    return fluid, solid, b


@pytest.mark.parametrize("degree", [1, 2])
def test_coarse_cycle_rounds_as_per_operation_launches(degree):
    """One preconditioner application on a speckled 512² system, whose
    coarse cycle spans 128² (the cluster), 64² and 32² as at 1024²: one
    launch a visit equals one launch per level operation bit for bit, at
    Chebyshev degree 1 (the main path's) and 2."""
    fluid, solid, b = _speckled(512, 5)
    cfg = _solver(_cfg(512), mg_cheby_degree=degree)
    a = pressure_matrix_diag(cfg, solid, fluid)
    ws = k3.workspace(cfg, b.device)
    ws.load(a, fluid, b)
    ws.solve(warm=False)
    ws.load(a, fluid, b)
    fused, per_op = ws.cycle(per_op=False), ws.cycle(per_op=True)
    assert fused.abs().max() > 0
    assert torch.equal(fused, per_op)


def test_inactive_substep_is_free(developed):
    """dt_proj = inf makes the RHS exactly zero: 0 iterations, a zero
    residual, finite outputs (the hierarchy build and every chunk are
    skipped on the device)."""
    cfg, scn, st, dt = developed
    inf = torch.tensor(float("inf"), device="cuda")
    zero = torch.zeros((), device="cuda")
    u, v, it, res, msq, p = k2.project_substep_mg(
        cfg, zero, inf, st.u, st.v, st.fluid, st.prev_fluid, scn.solid, st.p)
    assert int(it) == 0 and float(res) == 0.0
    for x in (u, v, msq, p):
        assert torch.isfinite(x).all()
