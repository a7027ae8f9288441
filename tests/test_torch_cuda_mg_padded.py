"""P3 on the card: the PCG loop with the Galerkin MG cycle on padded
levels (csrc/pcg_mg.cu), the CLI's converged solve at sizes whose levels
do not halve evenly, against its plain version
(`ops/project.pcg_loop` with `multigrid.make_mg_preconditioner`).

On a dam break developed 2 frames by the port on the card, at 1200²,
999² (an odd level 0, solved on its padded 1000² planes) and 1080 x
1920, in f32 and in f64 (`solver.dtype="float64"`: the f64 levels): P3
cold and warm within 5e-4 of scale and 1 iteration of the plain solve
(f64: 1e-8 of scale and the same iterations); the hierarchy and
Chebyshev rows it builds on the card bitwise equal to
`mg_kernel.mg_host_operands` in the solver dtype (and the active flags
to the plain hierarchy's), at 999² and 2160 x 3840; one cycle through
coarse_cycle bitwise equal to one launch per level operation; a zero RHS
(0 iterations, p = 0), a cap of 3 (exactly 3, as the plain solve); one
launch count a solve and no plain call; a workspace per grid; the f64
plan at 1024², whose coarse cycle starts one level lower than f32's.

Marked `cuda`: each test skips on a host without an NVIDIA GPU (the
kernels have no CPU mode).  Imports nothing of JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda_mg_padded.py
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
from euler_tpu_torch.ops.project import (
    divergence_rhs,
    make_preconditioner,
    pressure_matrix_diag,
)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


DTYPES = {"f32": "float32", "f64": "float64"}
# (p's atol over its scale, iterations equal) of P3 against its plain
# version: f32's reductions fold in another order than the plain loop's
# (the last bits of an iterate, then an iteration at the stop), f64's
# the same by 1e-16 of each sum
AGREE = {"f32": (5e-4, False), "f64": (1e-8, True)}


def _config(size: str, **solver):
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           size]))
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, **solver))


@functools.lru_cache(maxsize=None)
def _system(size: str, dtype: str = "f32"):
    """(cfg, b, a_diag, fluid, p) of a substep's own system on the dam
    break after 2 frames on the card (the CLI's converged config, its
    solver in `dtype`)."""
    cfg = _config(size, dtype=DTYPES[dtype])
    scn, st = dam_break(cfg, device="cuda")
    for _ in range(2):
        st = sim.step_frame(cfg, scn, st)
    dt = sim._dt_from_msq(cfg, max_speed_sq(cfg, st.u, st.v),
                          torch.tensor(cfg.frame_time, device="cuda"))
    ut, vt = grid_stage_plain(cfg, dt, st.u, st.v, st.fluid, st.prev_fluid,
                              scn.solid)
    b = divergence_rhs(cfg, ut, vt, st.fluid, dt)
    a = pressure_matrix_diag(cfg, scn.solid, st.fluid)
    return cfg, b, a, st.fluid, st.p


def _check(got, want, dtype: str = "f32"):
    (p, it, _), (pp, itp, _) = got, want
    rel, same = AGREE[dtype]
    scale = float(pp.abs().max())
    assert scale > 0 and int(itp) > 0
    assert p.dtype == pp.dtype == getattr(torch, DTYPES[dtype])
    assert float((p - pp).abs().max()) <= rel * scale
    assert abs(int(it) - int(itp)) <= (0 if same else 1)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("size", ["1200x1200", "999x999", "1080x1920"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_p3_matches_plain(dtype, size, warm):
    _card()
    cfg, b, a, fl, p0 = _system(size, dtype)
    assert sim.route(cfg, type("S", (), {"num_sources": 0})()) == (
        "plain", "P3")
    x0 = torch.where(fl, p0, 0.0).to(b.dtype) if warm else None
    _build.LAUNCHES.clear()
    _build.PLAIN_CALLS.clear()
    got = p3.solve_pressure_general(cfg, b, a, fl, x0=x0)
    assert _build.LAUNCHES["P3"] == 1 and not _build.PLAIN_CALLS
    assert got[0].shape == (cfg.ny, cfg.nx) and got[0].is_contiguous()
    want = p3.solve_pressure_general_plain(cfg, b, a, fl, x0)
    _check(got, want, dtype)


@pytest.mark.parametrize("size", ["999x999", "2160x3840"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_p3_hierarchy_bitwise(dtype, size):
    """The packed level 0 (padded), every coarse level's c, e, n planes and
    active flags, and the Chebyshev rows P3 builds on the card for a solve
    equal to the plain build in the solver dtype, bit for bit."""
    _card()
    cfg = _config(size, dtype=DTYPES[dtype])
    scn, st = dam_break(cfg, device="cuda")
    st = sim.step_frame(cfg, scn, st)
    fl = st.fluid
    a = pressure_matrix_diag(cfg, scn.solid, fl)
    f = getattr(torch, cfg.solver.dtype)
    b = torch.where(fl, torch.randn(fl.shape, device="cuda", dtype=f,
                                    generator=torch.Generator(
                                        "cuda").manual_seed(3)), 0.0)
    p3.solve_pressure_general(cfg, b, a, fl)
    ws = p3.workspace(cfg, b.device)
    shapes, packed0, planes, rows = k3.mg_host_operands(cfg, a, fl)
    assert ws.shapes == shapes == k3.padded_level_shapes(
        cfg.ny, cfg.nx, cfg.solver.mg_min_size)
    assert ws.packed0.dtype == rows.dtype == f
    assert torch.equal(ws.packed0, packed0)
    levels = multigrid.build_galerkin_hierarchy(
        a, fl, f, min_size=cfg.solver.mg_min_size)
    for l, (want, got, lv) in enumerate(zip(planes, ws.levels, levels[1:]),
                                        start=1):
        for name, w, g in zip("cen", want, got):
            assert torch.equal(w, g), f"level {l} {name}"
        assert torch.equal(got[3] != 0, lv.active), f"level {l} active"
    assert torch.equal(ws.rows, rows)


@pytest.mark.parametrize("size", ["999x999", "1080x1920"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_p3_cycle_fused_equals_per_op(dtype, size):
    """One preconditioner application on the hierarchy of the last solve,
    through coarse_cycle (one cluster launch a visit from its first level
    of at most 128² cells whose lower levels fit the shared memory in the
    solver dtype) and through one launch per level operation: bitwise
    equal, and nonzero; near the plain cycle (f32: 1e-4 of scale, f64:
    1e-10, where only the Chebyshev rows' last bit and the sums' order
    part them)."""
    _card()
    cfg, b, a, fl, _ = _system(size, dtype)
    p3.solve_pressure_general(cfg, b, a, fl)
    ws = p3.workspace(cfg, b.device)
    Y0, X0 = ws.shapes[0]
    r = torch.nn.functional.pad(b, (0, X0 - cfg.nx, 0, Y0 - cfg.ny))
    fused = ws.cycle(r, per_op=False)
    per_op = ws.cycle(r, per_op=True)
    assert bool(fused.abs().max() > 0)
    assert torch.equal(fused, per_op)
    want = make_preconditioner(cfg, a, fl)(b)
    scale = float(want.abs().max())
    rel = 1e-4 if dtype == "f32" else 1e-10
    assert float((fused[:cfg.ny, :cfg.nx] - want).abs().max()) <= rel * scale


def test_p3_zero_rhs_and_cap():
    """A zero RHS exits with 0 iterations and p = 0, warm or cold; capped
    at 3 iterations P3 takes exactly 3, as its plain version, and stays
    within 5e-4 of its scale."""
    _card()
    cfg, b, a, fl, p0 = _system("1200x1200")
    for x0 in (None, p0):
        p, it, res = p3.solve_pressure_general(cfg, torch.zeros_like(b), a,
                                               fl, x0=x0)
        assert int(it) == 0 and float(res) == 0.0 and not p.any()
    capped = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_iterations=3))
    got = p3.solve_pressure_general(capped, b, a, fl, x0=p0)
    want = p3.solve_pressure_general_plain(capped, b, a, fl, p0)
    assert int(got[1]) == int(want[1]) == 3
    _check(got, want)


def test_p3_workspace_per_grid():
    """1080 x 1920 and 1080 x 1919 share a padded level plan but not a
    workspace (the key holds the grid); a second solve reuses the
    first's."""
    _card()
    a_cfg, b_cfg = _config("1080x1920"), _config("1080x1919")
    assert (k3.padded_level_shapes(1080, 1920, 32)
            == k3.padded_level_shapes(1080, 1919, 32))
    assert p3.workspace_key(a_cfg, "cuda") != p3.workspace_key(b_cfg, "cuda")
    ws = p3.workspace(a_cfg, torch.device("cuda", 0))
    assert p3.workspace(a_cfg, torch.device("cuda", 0)) is ws
    assert ws.nbytes <= p3._MAX_WORKSPACE_BYTES


def test_p3_f64_plan_starts_lower():
    """At 1024² (the CLI's converged config: levels 1024² .. 32², the W on
    levels 0 and 1) f32's coarse cycle takes over at 128², the 64² and 32²
    below it in 9 f32 planes of shared memory (184,320 bytes); in f64
    those would take 368,640 bytes, more than a CTA may have, so the f64
    plan starts at 64², 32² below it (73,728 bytes).  At 1080 x 1920 both
    start at 68 x 120 (f64: 183,600 bytes)."""
    _card()
    dev = torch.device("cuda", 0)
    want = {("1024x1024", "f32"): (3, 184_320),
            ("1024x1024", "f64"): (4, 73_728),
            ("1080x1920", "f32"): (4, 91_800),
            ("1080x1920", "f64"): (4, 183_600)}
    for (size, dtype), (fused, smem) in want.items():
        plan = p3.workspace(_config(size, dtype=DTYPES[dtype]), dev).plan()
        assert (plan["fused"], plan["smem"]) == (fused, smem), (size, dtype)
