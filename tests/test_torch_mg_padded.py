"""P3's case on the CPU: MG where the JAX package's `solve_pressure` falls
through to its jnp `pcg_loop` with `make_mg_preconditioner`, at level
sizes that do not halve evenly (the JAX hierarchy pads an odd level with
inactive cells before coarsening it; the cycle pads b and crops x).

Against the JAX package, at sizes whose levels need padding (mg_min_size
8 unless said; nothing larger than 136 x 240 compiled):
  * the hierarchy bit for bit (45 x 65, 63 x 99 with an odd level 0,
    90 x 130) and the stored level plan P3 allocates;
  * the preconditioner, one cycle (45 x 65, mg_min_size 16), to 1e-5 of
    scale;
  * P3's plain solve (`solve_pressure` on CPU tensors) against the JAX
    `solve_pressure` with use_pallas=False, cold, warm and with a zero
    RHS at 63 x 99, capped at 3 iterations at 45 x 65, both with fewer
    levels to keep the JAX compile short: p within 5e-4 of scale,
    iterations within 1;
  * the route at the CLI's sizes, and what `check_slice` still refuses
    (f64 MG, which it refused until the f64 levels, runs P3);
  * 3 frames of the CLI's converged mode at 42 x 100 (mg_min_size 16:
    21 x 50 is padded) on a dam break with a source (K1, S1, K7, P3):
    counts exact, u and v within 2e-3.
"""

import dataclasses
import functools

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
from euler_tpu.sim import step_frame as jstep_frame
from euler_tpu_torch import cli, convert, sim
from euler_tpu_torch.core.presets import dam_break
from euler_tpu_torch.ops import multigrid as tmg
from euler_tpu_torch.ops.cuda import _build
from euler_tpu_torch.ops.cuda import mg_kernel as tmgk
from euler_tpu_torch.ops.project import (
    make_preconditioner,
    pressure_matrix_diag,
    solve_pressure,
    solver_route,
)

from torch_parity import jax_config, jax_state, n, port_config, t

MIN_SIZE = 8


def _config(Y, X, **solver):
    cfg = port_config(64)
    solver = {"mg_min_size": MIN_SIZE, **solver}
    return dataclasses.replace(cfg, ny=Y, nx=X, solver=dataclasses.replace(
        cfg.solver, **solver))


def _system(Y, X, seed=0):
    """A dam-break-like fluid with speckles inside a solid wall, its
    a_diag, and a seeded RHS on the fluid (f32)."""
    rng = np.random.default_rng(seed)
    fluid = np.zeros((Y, X), bool)
    fluid[2:int(Y * 0.6), 2:int(X * 0.55)] = True
    fluid |= rng.random((Y, X)) < 0.08
    fluid[[0, -1], :] = fluid[:, [0, -1]] = False
    solid = np.zeros((Y, X), bool)
    solid[1, 1:-1] = solid[1:-1, 1] = solid[1:-1, X - 2] = True
    fluid &= ~solid
    a = n(pressure_matrix_diag(_config(Y, X), t(solid), t(fluid)))
    b = np.where(fluid, rng.standard_normal((Y, X)), 0).astype(np.float32)
    return fluid, solid, a, b


SHAPES = [(45, 65), (63, 99), (90, 130)]


@pytest.mark.parametrize("shape", SHAPES)
def test_padded_hierarchy_exact(shape):
    """The port's hierarchy, P3's stored level plan and its plain build
    (`mg_host_operands`: the packed level 0 padded, the coarse planes, the
    Chebyshev rows) against the JAX `build_galerkin_hierarchy`."""
    Y, X = shape
    cfg = _config(Y, X)
    fluid, _, a, _ = _system(Y, X)
    got = tmg.build_galerkin_hierarchy(t(a), t(fluid), torch.float32,
                                       min_size=MIN_SIZE)
    want = jax.jit(functools.partial(
        jmg.build_galerkin_hierarchy, dtype=jnp.float32,
        min_size=MIN_SIZE))(jnp.asarray(a), jnp.asarray(fluid))
    plan = tmgk.padded_level_shapes(Y, X, MIN_SIZE)
    assert plan == [tuple(lv.c.shape) for lv in want]
    assert not tmgk.mg_fits(cfg)  # a level is padded
    assert len(got) == len(want) >= 4
    for lg, lw in zip(got, want):
        for f in ("c", "e", "n", "active", "lmax", "inv_c"):
            np.testing.assert_array_equal(n(getattr(lg, f)),
                                          np.asarray(getattr(lw, f)),
                                          err_msg=f)
    shapes, packed0, planes, rows = tmgk.mg_host_operands(cfg, t(a),
                                                          t(fluid))
    assert shapes == plan
    Y0, X0 = plan[0]
    want0 = np.zeros((Y0, X0), np.float32)
    want0[:Y, :X] = np.where(fluid, a + 8, 0)
    np.testing.assert_array_equal(n(packed0), want0)
    for (c, e, nn), lw in zip(planes, want[1:]):
        for got_p, f in zip((c, e, nn), "cen"):
            np.testing.assert_array_equal(n(got_p), np.asarray(getattr(lw, f)))
    s = cfg.solver
    for l, lw in enumerate(want):
        last = l == len(want) - 1
        deg = s.mg_coarse_iters if last else s.mg_cheby_degree
        it, coefs = jmg.cheby_coefficients(
            lw.lmax, deg, s.mg_coarse_ratio if last else s.mg_cheby_ratio)
        row = [it] + [c for pair in coefs for c in pair]
        np.testing.assert_allclose(n(rows[l, :len(row)]),
                                   np.asarray(row, np.float32), rtol=1e-6)
        assert not n(rows[l, len(row):]).any()


def test_preconditioner_matches_jax():
    """One cycle of `make_preconditioner` ("mg": P3's plain step) against
    the JAX `make_mg_preconditioner`, on a seeded RHS at 45 x 65 with
    mg_min_size 16, whose levels 0 and 1 are padded (46 x 66, 24 x 34,
    then 12 x 17)."""
    Y, X = SHAPES[0]
    cfg = _config(Y, X, mg_min_size=16)
    jcfg = jax_config(cfg, interpret=False)
    fluid, solid, a, b = _system(Y, X, seed=1)
    got = make_preconditioner(cfg, t(a), t(fluid))(t(b))

    @jax.jit
    def precon(a, fluid, solid, b):
        return jmg.make_mg_preconditioner(jcfg, solid, fluid, jnp.float32,
                                          a_diag=a)(b)

    want = precon(*(jnp.asarray(v) for v in (a, fluid, solid, b)))
    assert got.shape == (Y, X)
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 0
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5 * scale,
                               rtol=0)


# (shape, mg_min_size, cap): 63 x 99 (mg_min_size 16: 64 x 100, 32 x 50,
# 16 x 25) and 45 x 65 (mg_min_size 24: 46 x 66, 23 x 33) pad level 0
SOLVES = {"63x99": ((63, 99), 16, 100), "45x65_cap3": ((45, 65), 24, 3)}


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX `solve_pressure` (use_pallas False: `pcg_loop` with
    `make_mg_preconditioner`), compiled once per entry of SOLVES; it always
    takes a guess, since x0 = 0 is bitwise the cold start there (p = 0,
    r = b - A 0 = b)."""
    return {k: jax.jit(jproject.solve_pressure, static_argnums=0)
            for k in SOLVES}


@pytest.mark.parametrize("case,key", [("cold", "63x99"), ("warm", "63x99"),
                                      ("zero", "63x99"),
                                      ("cap3", "45x65_cap3")])
def test_plain_solve_matches_jax(case, key, jax_solves):
    """P3's plain solve (`solve_pressure` on CPU tensors) against the JAX
    `solve_pressure`: p within 5e-4 of scale, iterations within 1
    (exactly 0 on a zero RHS, 3 under a cap of 3)."""
    (Y, X), min_size, cap = SOLVES[key]
    cfg = _config(Y, X, tol_rel=1e-4, max_iterations=cap,
                  mg_min_size=min_size)
    assert solver_route(cfg) == "P3" and not tmgk.mg_fits(cfg)
    fluid, solid, a, b = _system(Y, X, seed=2)
    x0 = None
    if case == "zero":
        b = np.zeros_like(b)
    if case != "cold":
        _, _, _, b2 = _system(Y, X, seed=3)
        guess, _, _ = solve_pressure(cfg, t(b + 0.1 * b2), t(a), t(fluid))
        x0 = np.where(fluid, n(guess), 0).astype(np.float32)
    before = _build.PLAIN_CALLS["P3"]
    p, it, res = solve_pressure(cfg, t(b), t(a), t(fluid), t(solid),
                                x0=None if x0 is None else t(x0))
    assert _build.PLAIN_CALLS["P3"] == before + 1
    jp, jit, jres = jax_solves[key](
        jax_config(cfg, interpret=False), jnp.asarray(b), jnp.asarray(a),
        jnp.asarray(fluid), jnp.asarray(solid),
        jnp.asarray(np.zeros_like(b) if x0 is None else x0))
    scale = max(float(np.abs(np.asarray(jp)).max()), 1e-30)
    np.testing.assert_allclose(n(p), np.asarray(jp), atol=5e-4 * scale,
                               rtol=0)
    if case == "zero":
        assert int(it) == int(jit) == 0 and not n(p).any()
        return
    if case == "cap3":
        assert int(it) == int(jit) == 3
        return
    assert abs(int(it) - int(jit)) <= 1 and int(it) > 0
    tol = max(cfg.solver.tol, cfg.solver.tol_rel * float(np.abs(b).max()))
    assert float(res) <= tol and float(jres) <= tol


SIZES = ["1080x1920", "720x1280", "1200x1200", "1448x1448", "2160x3840",
         "999x999", "1024x1024", "2048x2048"]


@pytest.mark.parametrize("size", SIZES)
def test_route_at_cli_sizes(size):
    """The CLI's converged mode: P3 where the JAX package's gates let no
    Pallas solver run (its chain falls through to `pcg_loop`), K3 at
    1024² and K11 at 2048² as before; the substep is never fused at a P3
    size and `check_slice` refuses none of them."""
    cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                           size]))
    jcfg = jax_config(cfg)
    gates = [jpcg.pallas_solver_fits(jcfg), jmgk.mg_pallas_fits(jcfg),
             jms.stream_mg_fits(jcfg), jps.stream_solver_fits(jcfg)]
    want = {"1024x1024": "K3", "2048x2048": "K11"}.get(size, "P3")
    assert solver_route(cfg) == want
    if want == "P3":
        assert gates == [False] * 4
    else:
        assert gates[1] == (want == "K3") and gates[2]
    scn = type("Scn", (), {"num_sources": 0})()
    if want == "P3":
        assert sim.route(cfg, scn) == ("plain", "P3")
        assert not tmgk.mg_fits(cfg)
    sim.check_slice(cfg, scn)


FRAMES = 3
# levels 42 x 100, 21 x 50 (stored 22 x 50), 11 x 25 at mg_min_size 16
FRAME_ARGS = ["preset:dam_break", "--size", "42x100", "--converged"]


@pytest.fixture(scope="module")
def frames():
    """3 frames of the CLI's converged mode at 42 x 100 (mg_min_size 16)
    on a dam break with a source cell in the air, the port on the CPU and
    the JAX package (jnp marker pass, jnp pcg_loop with the MG
    preconditioner) from the same numpy state."""
    cfg = cli.build_config(cli.parse_args(FRAME_ARGS))
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, mg_min_size=16))
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
    out = []
    for _ in range(FRAMES):
        st, stats = sim.step_frame_stats(cfg, scn, st)
        jst = step(jcfg, jscn, jst)
        out.append((convert.state_to_numpy(st), jst, int(stats["pcg_iters"])))
    return cfg, scn, out, dict(_build.PLAIN_CALLS)


@pytest.mark.parametrize("frame", range(FRAMES))
def test_frames_match_jax(frames, frame):
    """Counts, drops and the live-marker count exact; u, v within 2e-3."""
    cfg, scn, out, _ = frames
    got, jst, iters = out[frame]
    for k in ("marker_count", "dropped_markers", "alive_count"):
        np.testing.assert_array_equal(
            got[k], np.asarray(getattr(jst, k)).reshape(np.shape(got[k])),
            err_msg=k)
    for k in ("u", "v"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                   atol=2e-3, rtol=0, err_msg=k)
    assert iters > 0 and np.abs(got["p"]).max() > 0


def test_frames_route(frames):
    """The frames ran K1, S1, K7 and P3 (their plain versions here) once a
    substep, no fused kernel and no K3; the source emitted."""
    cfg, scn, out, calls = frames
    assert sim.route(cfg, scn) == ("plain", "P3")
    assert set(calls) == {"K1", "S1", "K7", "P3"}
    assert calls["P3"] == calls["K7"] == cfg.max_substeps * FRAMES
    assert out[-1][0]["marker_count"][31:34, 59:62].sum() > 0


REFUSED = {
    # what check_slice still refuses: (config change, ROADMAP item named;
    # None: refused until its item was ported, runs P3 or P7 now)
    "f64_mg": (dict(solver=dict(dtype="float64")), None),
    "rbgs": (dict(solver=dict(mg_smoother="rbgs")), None),
    "rediscretize": (dict(solver=dict(mg_scheme="rediscretize")), None),
    "frame_hierarchy": (dict(solver=dict(mg_frame_hierarchy=True)),
                        "item M14"),
    "f64_grid": (dict(dtype="float64"), "item M16"),
    "cfl": (dict(cfl=1.5), "queue 3, closed item 1"),
}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_check_slice_refusals_name_their_item(kind):
    """Each configuration the port still refuses raises NotImplementedError
    naming the ROADMAP item that holds it, at a P3 size and at a K3 size;
    f64 MG (M15 part a), RB-GS MG and rediscretized MG (M14 part a),
    ported, pass at both and route to P3 (P7: rediscretized), the f32
    Chebyshev gates of K3 and K11 shut to them."""
    change, item = REFUSED[kind]
    for size in ("1200x1200", "1024x1024"):
        cfg = cli.build_config(cli.parse_args(["preset:dam_break", "--size",
                                               size]))
        solver = dataclasses.replace(cfg.solver, **change.get("solver", {}))
        bad = dataclasses.replace(cfg, solver=solver, **{
            k: v for k, v in change.items() if k != "solver"})
        scn = type("Scn", (), {"num_sources": 0})()
        if item is None:
            solve = "P7" if kind == "rediscretize" else "P3"
            sim.check_slice(bad, scn)
            assert solver_route(bad) == solve
            assert sim.route(bad, scn) == ("plain", solve)
            continue
        with pytest.raises(NotImplementedError, match=item):
            sim.check_slice(bad, scn)
