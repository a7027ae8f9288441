"""P3 with RB-GS smoothing and P7 (the rediscretized V-cycle) on the card,
against their plain versions (`ops/project.pcg_loop` with
`multigrid.make_mg_preconditioner`: `cycle_galerkin` with smoother
"rbgs", `v_cycle` on `build_hierarchy`).

On a dam break developed 2 frames by the port on the card, at 999² (P3:
an odd level 0 on padded planes; P7: odd levels, unpadded) and 1080 x
1920, in f32 and in f64: each solve within 5e-4 of scale and 1 iteration
of the plain solve (f64: both stopped at a residual of 1e-10, within
1e-10 of scale; P7 in f32, whose stopping iteration rides on the loop's
rounding, on the plain solve's trajectory and stopped by the rule, never
more than 1 iteration after it); P7's hierarchy (fluid, solid,
a_diag, inv_diag of every level) bitwise the plain build; one V-cycle of
P7 within 1e-6 (f32) / 1e-12 (f64) of scale of the plain `v_cycle`; a
zero RHS (0 iterations, p = 0) and a cap of 3 (exactly 3, as the plain
solve); one launch count a solve and no plain call; P3-rbgs's coarse
cycle plan; a Chebyshev and an RB-GS config of one grid on two
workspaces.  (The per-operation RB-GS cycle against the fused one:
tests/test_torch_cuda.py.)

Marked `cuda`: each test skips on a host without an NVIDIA GPU (the
kernels have no CPU mode).  Imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_mg_rbgs.py
"""

import dataclasses
import functools

import pytest
import torch

from euler_tpu_torch import cli, sim
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops import multigrid
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import mg_kernel as k3
from euler_tpu_torch.ops.cuda import pcg_general_kernel as p3
from euler_tpu_torch.ops.cuda.grid_kernel import grid_stage_plain
from euler_tpu_torch.ops.forces import max_speed_sq
from euler_tpu_torch.ops.project import divergence_rhs, pressure_matrix_diag

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


DTYPES = {"f32": "float32", "f64": "float64"}
# the two settings: (solver change, launch count)
SETTINGS = {"rbgs": (dict(mg_smoother="rbgs"), "P3"),
            "rediscretize": (dict(mg_scheme="rediscretize"), "P7")}
# p's atol over its scale against the plain version: f32's reductions
# fold in another order than the plain loop's
RTOL = {"f32": 5e-4, "f64": 1e-10}
# the f64 solves' stopping rule: P7's PCG amplifies rounding, so at the
# CLI's tol of 1e-6 two sound f64 solves stop far more than RTOL apart
F64_RULE = dict(tol=1e-10, tol_rel=1e-10, max_iterations=400)


def _config(size: str, kind: str, dtype: str = "f32", **solver):
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           size]))
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype=DTYPES[dtype], **SETTINGS[kind][0], **solver))


@functools.lru_cache(maxsize=None)
def _system(size: str):
    """(b, a_diag, fluid, solid, p) of a substep's own system on the dam
    break after 2 frames on the card (the CLI's config, its MG with
    RB-GS), b in f32."""
    cfg = _config(size, "rbgs")
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(2):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return b, a, st.fluid, scn.solid, st.p


def _check(got, want, dtype):
    """p within RTOL of scale; iterations within 1 of want's."""
    (p, it, _), (pp, itp, _) = got, want
    scale = float(pp.abs().max())
    assert scale > 0 and int(itp) > 0
    assert p.dtype == pp.dtype == getattr(torch, DTYPES[dtype])
    assert float((p - pp).abs().max()) <= RTOL[dtype] * scale
    assert abs(int(it) - int(itp)) <= 1


def _check_trajectory(cfg, b, a, fl, so, x0, got, want):
    """P7 in f32: near its stop max|r| hovers at the tolerance for several
    iterations, so where it stops rides on the loop's rounding (at 999²
    78 against the plain solve's 80 cold, 46 against 48 warm; the plain
    loop's own count moves with the order of its sums: PERF.md §6).  So:
    p within RTOL of scale; never more than 1 iteration after the plain
    solve; stopped by the rule (max|r| within the tolerance) or at the cap
    as the plain solve; and both capped at the fewer of their counts with
    a tolerance of 0 take exactly that many iterations, p within RTOL of
    scale: the same trajectory to where the first stopped."""
    (p, it, res), (pp, itp, _) = got, want
    s = cfg.solver
    assert float((p - pp).abs().max()) <= RTOL["f32"] * float(pp.abs().max())
    assert 0 < int(it) <= int(itp) + 1
    tol = max(s.tol, s.tol_rel * float(b.abs().max()))
    assert float(res) <= tol or int(it) == int(itp) == s.max_iterations
    n = min(int(it), int(itp))
    capped = dataclasses.replace(cfg, solver=dataclasses.replace(
        s, tol=0.0, tol_rel=0.0, max_iterations=n))
    g = p3.solve_pressure_general(capped, b, a, fl, x0=x0, solid=so)
    w = p3.solve_pressure_general_plain(capped, b, a, fl, x0, so)
    assert int(g[1]) == int(w[1]) == n
    assert float((g[0] - w[0]).abs().max()) <= RTOL["f32"] * float(
        w[0].abs().max())


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("size", ["999x999", "1080x1920"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", list(SETTINGS))
def test_matches_plain(kind, dtype, size, warm):
    _card()
    cfg = _config(size, kind, dtype, **(F64_RULE if dtype == "f64" else {}))
    b, a, fl, so, p0 = _system(size)
    f = getattr(torch, cfg.solver.dtype)
    b = b.to(f)
    name = SETTINGS[kind][1]
    assert sim.route(cfg, type("S", (), {"num_sources": 0})()) == (
        "plain", name)
    x0 = torch.where(fl, p0, 0.0).to(f) if warm else None
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = p3.solve_pressure_general(cfg, b, a, fl, x0=x0, solid=so)
    assert dict(_build.LAUNCHES) == {name: 1} and not _build.PLAIN_CALLS
    assert got[0].shape == (cfg.ny, cfg.nx) and got[0].is_contiguous()
    want = p3.solve_pressure_general_plain(cfg, b, a, fl, x0, so)
    if dtype == "f64":
        assert int(want[1]) < cfg.solver.max_iterations
    if (kind, dtype) == ("rediscretize", "f32"):
        _check_trajectory(cfg, b, a, fl, so, x0, got, want)
    else:
        _check(got, want, dtype)


@pytest.mark.parametrize("size", ["999x999", "1080x1920"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_p7_hierarchy_bitwise(dtype, size):
    """The fluid and solid masks, a_diag and inv_diag of every level P7
    builds on the card for a solve equal to `multigrid.build_hierarchy`
    (and its masks' coarsening), bit for bit, at the unpadded shapes of
    `rediscretized_shapes`."""
    _card()
    cfg = _config(size, "rediscretize", dtype)
    b, a, fl, so, _ = _system(size)
    f = getattr(torch, cfg.solver.dtype)
    p3.solve_pressure_general(cfg, b.to(f), a, fl, solid=so)
    ws = p3.workspace(cfg, b.device)
    min_size = cfg.solver.mg_min_size
    assert ws.shapes == k3.rediscretized_shapes(cfg.ny, cfg.nx, min_size)
    want = multigrid.build_hierarchy(so, fl, f, min_size=min_size)
    assert len(want) == len(ws.levels) >= 5
    solid = so
    for l, (lw, (g_fl, g_so, g_a, g_inv)) in enumerate(zip(want,
                                                           ws.levels)):
        if l:
            solid = multigrid.coarsen_masks(solid, want[l - 1].fluid)[0]
        assert g_inv.dtype == f
        for what, w, g in (("fluid", lw.fluid, g_fl), ("solid", solid, g_so),
                           ("a_diag", lw.a_diag, g_a),
                           ("inv_diag", lw.inv_diag, g_inv)):
            assert torch.equal(w, g), f"level {l} {what}"


@pytest.mark.parametrize("size", ["999x999", "1080x1920"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_p7_cycle_matches_plain(dtype, size):
    """One V-cycle of P7 on the hierarchy of its last solve against the
    plain `v_cycle`: the same operations in the same order, so within
    1e-6 (f32) / 1e-12 (f64) of scale; nonzero."""
    _card()
    cfg = _config(size, "rediscretize", dtype)
    b, a, fl, so, _ = _system(size)
    f = getattr(torch, cfg.solver.dtype)
    b = b.to(f)
    p3.solve_pressure_general(cfg, b, a, fl, solid=so)
    got = p3.workspace(cfg, b.device).cycle(b)
    s = cfg.solver
    want = multigrid.make_mg_preconditioner(cfg, so, fl, f)(b)
    scale = float(want.abs().max())
    assert scale > 0 and bool(got.abs().max() > 0)
    rel = 1e-6 if dtype == "f32" else 1e-12
    assert float((got - want).abs().max()) <= rel * scale, (
        s.mg_pre_smooth, s.mg_post_smooth)


@pytest.mark.parametrize("kind", list(SETTINGS))
def test_zero_rhs_and_cap(kind):
    """A zero RHS exits with 0 iterations and p = 0, warm or cold; capped
    at 3 iterations each takes exactly 3, as its plain version, within
    5e-4 of its scale."""
    _card()
    cfg = _config("1080x1920", kind)
    b, a, fl, so, p0 = _system("1080x1920")
    for x0 in (None, p0):
        p, it, res = p3.solve_pressure_general(cfg, torch.zeros_like(b), a,
                                               fl, x0=x0, solid=so)
        assert int(it) == 0 and float(res) == 0.0 and not p.any()
    capped = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_iterations=3))
    got = p3.solve_pressure_general(capped, b, a, fl, x0=p0, solid=so)
    want = p3.solve_pressure_general_plain(capped, b, a, fl, p0, so)
    assert int(got[1]) == int(want[1]) == 3
    _check(got, want, "f32")


def test_p3_rbgs_plan():
    """P3-rbgs's coarse cycle (coarse_cycle_rbgs) takes over where the
    Chebyshev one does: at 1024², 128² in f32 and 64² in f64; at 1080 x
    1920, 68 x 120."""
    _card()
    dev = torch.device("cuda", 0)
    want = {("1024x1024", "f32"): (3, 184_320),
            ("1024x1024", "f64"): (4, 73_728),
            ("1080x1920", "f32"): (4, 91_800),
            ("1080x1920", "f64"): (4, 183_600)}
    for (size, dtype), (fused, smem) in want.items():
        plan = p3.workspace(_config(size, "rbgs", dtype), dev).plan()
        assert (plan["fused"], plan["smem"]) == (fused, smem), (size, dtype)


def test_rbgs_and_cheby_workspaces():
    """A Chebyshev and an RB-GS config of one grid get two workspaces (the
    cache key holds the smoother), and each solve on its own matches its
    plain version."""
    _card()
    rbgs = _config("1080x1920", "rbgs")
    cheby = dataclasses.replace(rbgs, solver=dataclasses.replace(
        rbgs.solver, mg_smoother="cheby"))
    dev = torch.device("cuda", 0)
    assert p3.workspace(cheby, dev) is not p3.workspace(rbgs, dev)
    b, a, fl, so, _ = _system("1080x1920")
    for cfg in (cheby, rbgs, cheby):
        _check(p3.solve_pressure_general(cfg, b, a, fl),
               p3.solve_pressure_general_plain(cfg, b, a, fl), "f32")
