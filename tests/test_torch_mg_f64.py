"""f64 MG on one card (P3 in double precision) on the CPU: the JAX
package's `solver.dtype="float64"` with `preconditioner="mg"`, which every
size takes through its jnp `pcg_loop` with `make_mg_preconditioner` in
f64 (its Pallas MG gates are f32 only), against the port's P3 route and
its plain versions in f64.

Against the JAX package (three jitted compiles: the hierarchies and a
cycle, the three solves, the frame):
  * the f64 hierarchy bit for bit at 45 x 65 and 63 x 99 (an odd level 0),
    mg_min_size 8, and P3's plain build (`mg_host_operands` in f64: the
    packed level 0, the coarse planes, the Chebyshev rows from f64
    bounds);
  * one cycle at 45 x 65 (mg_min_size 16) within 1e-12 of scale;
  * the plain solve against `solve_pressure` (use_pallas False, f64, tol
    1e-10) at 63 x 99 (mg_min_size 16): cold, warm, and capped at 3;
    iterations within 1 (3 and 3 under the cap), p within 1e-8 of scale;
  * the route: P3 at 64², 1024², 1080 x 1920, 1200² and 2048², where no
    JAX Pallas gate opens, never K2, K3 or K11;
  * 3 frames of the CLI's converged mode in f64 at 42 x 100 (mg_min_size
    16) on a dam break with a source (K1, S1, K7, P3): counts exact, u
    and v within 2e-3; the same 3 frames on 2 row blocks and on 2 x 2
    blocks (in-process `LocalGroup`s; blocks of 21 rows, so P5's plain
    version gathers at level 0) against the same JAX frames, with no JAX
    compile of their own: counts, alive, drops and the RNG exact, u and
    v within 2e-3.
And without JAX: `python -m euler_tpu_torch --load` of a 40 x 100
checkpoint whose config is f64 MG runs a headless frame on the CPU,
bitwise the frame stepped here.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from euler_tpu.ops import multigrid as jmg
from euler_tpu.ops import project as jproject
from euler_tpu.ops.pallas import mg_kernel as jmgk
from euler_tpu.ops.pallas import mg_stream_kernel as jms
from euler_tpu.ops.pallas import pcg_kernel as jpcg
from euler_tpu.ops.pallas import pcg_stream_kernel as jps
from euler_tpu.sim import _use_fused_substep as j_use_fused_substep
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.io import checkpoint
from euler_tpu_torch.ops import multigrid as tmg
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.project import (
    make_preconditioner,
    pressure_matrix_diag,
    solve_pressure,
    solver_route,
)
from euler_tpu_torch.parallel import spatial_mg

from torch_parity import (
    assert_frame,
    block_frames,
    jax_config,
    jax_state,
    n,
    port_config,
    t,
)

REPO = Path(__file__).resolve().parents[1]
F64 = "float64"
SHAPES = [(45, 65), (63, 99)]   # levels padded; 63 x 99 at level 0 too
CYCLE = ((45, 65), 16)           # 46 x 66, 24 x 34 (23 x 33 padded)
SOLVE = ((63, 99), 16)           # 64 x 100, 32 x 50, 16 x 25


def _config(Y, X, min_size=8, **solver):
    cfg = port_config(64)
    solver = {"dtype": F64, "mg_min_size": min_size, **solver}
    return dataclasses.replace(cfg, ny=Y, nx=X, solver=dataclasses.replace(
        cfg.solver, **solver))


def _system(Y, X, seed=0):
    """A dam-break-like fluid with speckles inside a solid wall, its
    a_diag, and a seeded f64 RHS on the fluid."""
    rng = np.random.default_rng(seed)
    fluid = np.zeros((Y, X), bool)
    fluid[2:int(Y * 0.6), 2:int(X * 0.55)] = True
    fluid |= rng.random((Y, X)) < 0.08
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    solid = np.zeros((Y, X), bool)
    solid[1, 1:-1] = solid[1:-1, 1] = solid[1:-1, X - 2] = True
    fluid &= ~solid
    a = n(pressure_matrix_diag(_config(Y, X), t(solid), t(fluid)))
    b = np.where(fluid, rng.standard_normal((Y, X)), 0.0)
    return fluid, solid, a, b


@pytest.fixture(scope="module")
def jax_levels():
    """Compile 1: the JAX f64 hierarchies of SHAPES (mg_min_size 8) and
    one f64 MG cycle at CYCLE's shape and mg_min_size, in one jit."""
    (Yc, Xc), cmin = CYCLE
    jcfg = jax_config(_config(Yc, Xc, cmin), interpret=False)
    systems = [_system(Y, X) for Y, X in SHAPES]
    fluid, solid, a, b = _system(Yc, Xc, seed=1)

    @jax.jit
    def build(pairs, a, fluid, solid, b):
        levels = [jmg.build_galerkin_hierarchy(aa, ff, jnp.float64,
                                               min_size=8)
                  for aa, ff in pairs]
        z = jmg.make_mg_preconditioner(jcfg, solid, fluid, jnp.float64,
                                       a_diag=a)(b)
        return levels, z

    pairs = [(jnp.asarray(s[2]), jnp.asarray(s[0])) for s in systems]
    levels, z = build(pairs, *(jnp.asarray(v) for v in (a, fluid, solid,
                                                         b)))
    return systems, levels, (fluid, a, b, np.asarray(z))


@pytest.mark.parametrize("k", range(len(SHAPES)),
                         ids=[f"{Y}x{X}" for Y, X in SHAPES])
def test_hierarchy_f64_exact(jax_levels, k):
    """The port's f64 hierarchy and P3's plain build in f64 (the packed
    level 0 padded, the coarse planes, the Chebyshev rows) against the
    JAX f64 `build_galerkin_hierarchy`, bit for bit (the rows to 1e-15:
    one correctly rounded f64 recurrence each)."""
    systems, levels, _ = jax_levels
    fluid, _, a, _ = systems[k]
    want = levels[k]
    Y, X = SHAPES[k]
    cfg = _config(Y, X)
    got = tmg.build_galerkin_hierarchy(t(a), t(fluid), torch.float64,
                                       min_size=8)
    plan = tmgk.padded_level_shapes(Y, X, 8)
    assert plan == [tuple(lv.c.shape) for lv in want]
    assert len(got) == len(want) >= 4
    for lg, lw in zip(got, want):
        assert lg.c.dtype == torch.float64 and lw.c.dtype == jnp.float64
        for f in ("c", "e", "n", "active", "lmax", "inv_c"):
            np.testing.assert_array_equal(n(getattr(lg, f)),
                                          np.asarray(getattr(lw, f)),
                                          err_msg=f)
    shapes, packed0, planes, rows = tmgk.mg_host_operands(cfg, t(a),
                                                          t(fluid))
    assert shapes == plan
    assert packed0.dtype == rows.dtype == torch.float64
    Y0, X0 = plan[0]
    want0 = np.zeros((Y0, X0))
    want0[:Y, :X] = np.where(fluid, a + 8, 0)
    np.testing.assert_array_equal(n(packed0), want0)
    for (c, e, nn), lw in zip(planes, want[1:]):
        for got_p, f in zip((c, e, nn), "cen"):
            assert got_p.dtype == torch.float64
            np.testing.assert_array_equal(n(got_p), np.asarray(getattr(lw, f)))
    s = cfg.solver
    for l, lw in enumerate(want):
        last = l == len(want) - 1
        deg = s.mg_coarse_iters if last else s.mg_cheby_degree
        it, coefs = jmg.cheby_coefficients(
            lw.lmax, deg, s.mg_coarse_ratio if last else s.mg_cheby_ratio)
        row = np.asarray([it] + [c for pair in coefs for c in pair],
                         np.float64)
        np.testing.assert_allclose(n(rows[l, :len(row)]), row, rtol=1e-15)
        assert not n(rows[l, len(row):]).any()


def test_cycle_f64_matches_jax(jax_levels):
    """One f64 cycle of `make_preconditioner` ("mg": P3's plain step)
    against the JAX f64 `make_mg_preconditioner`, within 1e-12 of
    scale."""
    _, _, (fluid, a, b, want) = jax_levels
    (Y, X), cmin = CYCLE
    cfg = _config(Y, X, cmin)
    got = make_preconditioner(cfg, t(a), t(fluid))(t(b))
    assert got.dtype == torch.float64 and got.shape == (Y, X)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(n(got), want, atol=1e-12 * scale, rtol=0)


SOLVE_CASES = ["cold", "warm", "cap3"]


@pytest.fixture(scope="module")
def solves():
    """Compile 2: the JAX f64 `solve_pressure` (use_pallas False: its
    `pcg_loop` with `make_mg_preconditioner`) at SOLVE's shape, tol 1e-10,
    cold (x0 = 0, bitwise the cold start there), warm, and warm capped at
    3 iterations, in one jit; and the port's plain solves beside them."""
    (Y, X), smin = SOLVE
    cfg = _config(Y, X, smin, tol=1e-10, tol_rel=1e-10)
    cap3 = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, max_iterations=3))
    fluid, solid, a, b = _system(Y, X, seed=2)
    _, _, _, b2 = _system(Y, X, seed=3)
    guess, _, _ = solve_pressure(cfg, t(b + 0.1 * b2), t(a), t(fluid))
    x0 = np.where(fluid, n(guess), 0.0)

    @functools.partial(jax.jit, static_argnums=(0, 1))
    def three(jcfg, jcfg3, b, a, fluid, solid, x0):
        cold = jproject.solve_pressure(jcfg, b, a, fluid, solid,
                                       x0=jnp.zeros_like(b))
        warm = jproject.solve_pressure(jcfg, b, a, fluid, solid, x0=x0)
        capped = jproject.solve_pressure(jcfg3, b, a, fluid, solid, x0=x0)
        return cold, warm, capped

    jout = three(jax_config(cfg, interpret=False),
                 jax_config(cap3, interpret=False),
                 *(jnp.asarray(v) for v in (b, a, fluid, solid, x0)))
    port = {}
    for case, c, guess0 in (("cold", cfg, None), ("warm", cfg, x0),
                            ("cap3", cap3, x0)):
        assert solver_route(c) == "P3"
        before = _build.PLAIN_CALLS["P3"]
        port[case] = solve_pressure(c, t(b), t(a), t(fluid), t(solid),
                                    x0=None if guess0 is None else t(guess0))
        assert _build.PLAIN_CALLS["P3"] == before + 1
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * float(np.abs(b).max()))
    return port, dict(zip(SOLVE_CASES, jout)), tol


@pytest.mark.parametrize("case", SOLVE_CASES)
def test_plain_solve_f64_matches_jax(solves, case):
    """P3's plain f64 solve against the JAX f64 solve: p within 1e-8 of
    scale, iterations within 1 (exactly 3, both, under a cap of 3); the
    converged ones below the tolerance."""
    port, jout, tol = solves
    p, it, res = port[case]
    jp, jit, jres = jout[case]
    assert p.dtype == torch.float64 and jp.dtype == jnp.float64
    scale = float(np.abs(np.asarray(jp)).max())
    assert scale > 0
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=1e-8 * scale,
                               rtol=0)
    if case == "cap3":
        assert int(it) == int(jit) == 3
        return
    assert abs(int(it) - int(jit)) <= 1 and int(it) > 0
    assert float(res) <= tol and float(jres) <= tol


@pytest.mark.parametrize("size", ["64x64", "1024x1024", "1080x1920",
                                  "1200x1200", "2048x2048"])
def test_route_f64_is_p3(size):
    """The CLI's converged mode with solver.dtype float64: no JAX Pallas
    gate opens (fused substep, K8, K3, K11, K12: f32 only), so the JAX
    chain falls through to its jnp loop and the port runs P3, never K2,
    K3 or K11 (whose gates stay shut to f64), and `check_slice` passes."""
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           size, "--converged"]))
    assert cfg.solver.preconditioner == "mg"
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype=F64))
    jcfg = jax_config(cfg)
    scn = type("Scn", (), {"num_sources": 0})()
    assert not j_use_fused_substep(jcfg, scn)
    assert not any(g(jcfg) for g in (jpcg.pallas_solver_fits,
                                     jmgk.mg_pallas_fits,
                                     jms.stream_mg_fits,
                                     jps.stream_solver_fits))
    assert solver_route(cfg) == "P3"
    assert sim.route(cfg, scn) == ("plain", "P3")
    assert not tmgk.mg_fits(cfg) and not tmgk.galerkin_cheby_f32(cfg)
    assert tmgk.galerkin_cheby(cfg)
    sim.check_slice(cfg, scn)


FRAMES = 3
FRAME_ARGS = ["preset:dam_break", "--size", "42x100", "--converged"]


@pytest.fixture(scope="module")
def frames():
    """Compile 3: 3 frames of the CLI's converged mode in f64 at 42 x 100
    (mg_min_size 16: 42 x 100, 22 x 50 stored, 11 x 25) on a dam break
    with a source cell in the air, the port on the CPU and the JAX package
    (jnp marker pass, jnp pcg_loop with the f64 MG preconditioner) from
    the same numpy state."""
    cfg = cli.build_config(cli.parse_args(FRAME_ARGS))
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, mg_min_size=16, dtype=F64))
    scn, st = dam_break(cfg, device="cpu")
    source = torch.zeros_like(scn.source)
    source[32, 60] = True
    scn = dataclasses.replace(
        scn, source=source,
        source_yx=torch.tensor([[32, 60]], dtype=torch.int32),
        source_valid=torch.tensor([True]))
    jscn, jst = jax_state((convert.scenario_to_numpy(scn),
                           convert.state_to_numpy(st)))
    jcfg = dataclasses.replace(jax_config(cfg, interpret=False),
                               use_pallas_markers=False)
    step = jax.jit(jstep_frame, static_argnums=0)
    _build.PLAIN_CALLS.clear()
    out, st0 = [], st
    for _ in range(FRAMES):
        st, stats = sim.step_frame_stats(cfg, scn, st)
        jst = step(jcfg, jscn, jst)
        out.append((convert.state_to_numpy(st), jst, int(stats["pcg_iters"])))
    return cfg, scn, out, dict(_build.PLAIN_CALLS), st0


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frames_f64_match_jax(frames, frame):
    """Counts, drops and the live-marker count exact; u, v within 2e-3
    (the largest difference seen is printed)."""
    cfg, scn, out, *_ = frames
    got, jst, iters = out[frame]
    for k in ("marker_count", "dropped_markers", "alive_count"):
        np.testing.assert_array_equal(
            got[k], np.asarray(getattr(jst, k)).reshape(np.shape(got[k])),
            err_msg=k)
    diff = {k: float(np.abs(got[k] - np.asarray(getattr(jst, k))).max())
            for k in ("u", "v")}
    print(f"frame {frame}: max |du| {diff['u']:.3g}, |dv| {diff['v']:.3g}")
    assert max(diff.values()) <= 2e-3, diff
    assert iters > 0 and np.abs(got["p"]).max() > 0


def test_frames_f64_route(frames):
    """The frames ran K1, S1, K7 and P3 (their plain versions here) once a
    substep, no fused kernel and no K3; the source emitted."""
    cfg, scn, out, calls, _ = frames
    assert sim.route(cfg, scn) == ("plain", "P3")
    assert set(calls) == {"K1", "S1", "K7", "P3"}
    assert calls["P3"] == calls["K7"] == cfg.max_substeps * FRAMES
    assert out[-1][0]["marker_count"][31:34, 59:62].sum() > 0


class _Place:
    """Block (0, 0) of y x x, as `block_plan` reads a group."""

    def __init__(self, y, x):
        self.sizes = {"y": y, "x": x}

    def size(self, axis):
        return self.sizes[axis]

    def rank(self, axis):
        return 0


@pytest.mark.parametrize("y,x", [(2, 1), (2, 2)])
def test_frames_f64_on_blocks_match_jax(frames, y, x):
    """The f64 frames on y x x blocks of 21 rows (the frame on blocks,
    `spatial.make_block_step`: K1, S1, K7 and P5 a block a substep, their
    plain versions here; P5 at gather level 0) from the fixture's state,
    against its third JAX frame: counts, alive, alive_count, drops and
    the RNG exact, u and v within 2e-3, live positions within 1e-4."""
    cfg, scn, out, _, st0 = frames
    plan = spatial_mg.block_plan(cfg, _Place(y, x),
                                 ("y", "x") if x > 1 else ("y",))
    assert (plan.rows, plan.cols) == (21, 100 // x) and plan.gather == 0
    _build.PLAIN_CALLS.clear()
    got = block_frames(cfg, scn, st0, y, x, FRAMES)
    per = y * x * FRAMES * cfg.max_substeps
    assert [_build.PLAIN_CALLS[k] for k in ("K1", "S1", "K7", "P5", "P4",
                                            "P3")] == [per] * 4 + [0, 0]
    jst = out[-1][1]
    want = {f.name: np.asarray(getattr(jst, f.name))
            for f in dataclasses.fields(jst)}
    assert_frame(cfg, got, want, 2e-3)


def test_cli_load_f64_checkpoint(tmp_path):
    """`python -m euler_tpu_torch --load` of a 40 x 100 checkpoint whose
    config is f64 MG: the config travels in the checkpoint, the headless
    frame runs on the CPU's plain versions (P3 in f64), and its state is
    bitwise the frame stepped here."""
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           "40x100", "--converged"]))
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, dtype=F64))
    assert sim.route(cfg, type("Scn", (), {"num_sources": 0})())[1] == "P3"
    scn, st = dam_break(cfg, device="cpu")
    ck, out_ck = tmp_path / "f64.npz", tmp_path / "next.npz"
    checkpoint.save(str(ck), cfg, scn, st)
    loaded_cfg, _, _ = checkpoint.load(str(ck), device="cpu")
    assert loaded_cfg.solver == cfg.solver
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "euler_tpu_torch", "--load", str(ck),
         "--frames", "1", "--cpu", "--checkpoint", str(out_ck)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith(
        "1 frames (100x40)")
    _, _, resumed = checkpoint.load(str(out_ck), device="cpu")
    on = sim.step_frame(cfg, scn, st)
    for k, v in convert.state_to_numpy(on).items():
        assert convert.state_to_numpy(resumed)[k].tobytes() == v.tobytes(), k
